"""Paired-trajectory trainer-parity probe on the PyTorch port (the port of
parity_probe.py): the port's engine against a reference-faithful torch
replica, from one init on one client's data.

One client's partition goes through the port's data pipeline; the port's
engine trains it for one round (the per-phase round: sequential batches,
the shrink loss, patience early stop), and a torch module that mirrors
the reference's Shrink-AE and trainer line by line (architecture and
init, the loop: sequential batches, epoch-mean train loss, batch-mean
valid loss, patience early stop) trains the same rows from a copy of the
engine's init. The probe compares the per-epoch loss curves and the
reference's centroid AUC (standardize the train latents, L2 distance to
the origin). Verdict: `equivalent` when both stop at the same epoch, the
loss curves agree within 1e-3 and the AUCs within 5e-3.

`--solo N` adds the distribution probe: N independent solo trainings a
side on the same arrays, the port drawing its inits from its run-r
streams, the replica from torch's own (`torch.manual_seed(r * 10000)`,
the reference's per-run seeding), each scored by the same centroid AUC;
Welch's t on the two AUC samples. Its result is written under "solo".

Both sides run on --device (the replica's init is drawn on the CPU and
moved). The centroid AUC is numpy: a population-std standard scaler with
constant features left unscaled, and the tie-averaged rank AUC.

Usage: `python3 parity_probe_torch.py --shards <Client-k tree> [--client
5] [--data-seed 4] [--epochs 5] [--solo N] [--out
PARITY_PROBE_torch.json]`; on the CPU add `--device cpu`.
"""

import glob
import json
import os
import sys

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import sweep_data_torch as sweep  # noqa: E402


def welch_t(a, b):
    """Welch's t for two independent samples, or None where it is
    undefined: a side with fewer than 2 samples, or zero variance on both
    sides with unequal means. Equal means with zero variance: 0.0."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    if len(a) < 2 or len(b) < 2:
        return None
    va, vb = a.var(ddof=1) / len(a), b.var(ddof=1) / len(b)
    if va + vb:
        return float((a.mean() - b.mean()) / np.sqrt(va + vb))
    return 0.0 if a.mean() == b.mean() else None


def standardize(train, test):
    """`test` standardized by `train`'s columns: population mean and
    standard deviation, a constant column (variance within rounding of
    zero) left unscaled."""
    n = train.shape[0]
    mean = train.mean(axis=0)
    var = train.var(axis=0)
    eps = np.finfo(np.float64).eps
    constant = var <= n * eps * var + (n * mean * eps) ** 2
    scale = np.sqrt(var)
    scale[constant | (scale == 0.0)] = 1.0
    return (test - mean) / scale


def rank_auc(labels, scores) -> float:
    """ROC AUC as the tie-averaged Mann-Whitney statistic in float64 (NaN
    when a class is absent)."""
    from scipy.stats import rankdata
    y = np.asarray(labels) > 0
    n_pos, n_neg = int(y.sum()), int((~y).sum())
    if not n_pos or not n_neg:
        return float("nan")
    ranks = rankdata(np.asarray(scores, np.float64))
    return float((ranks[y].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def centroid_auc(train_z, test_z, test_y) -> float:
    """The reference's centroid AUC: standardize on the train latents, the
    L2 distance to the origin as the score. Latents are nan_to_num'd
    first, so a diverged run is recorded rather than raising."""
    train_z = np.nan_to_num(np.asarray(train_z, dtype=np.float64))
    test_z = np.nan_to_num(np.asarray(test_z, dtype=np.float64))
    return rank_auc(test_y, np.nan_to_num(np.linalg.norm(
        standardize(train_z, test_z), axis=1)))


def load_client_partition(cfg, shards, client, data_seed, device):
    """One client's partition through the port's pipeline, and its stacked
    tensors on `device`."""
    from fedmse_tpu_torch.config import DatasetConfig
    from fedmse_tpu_torch.data import (build_dev_dataset, prepare_clients,
                                       stack_clients)
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs

    n_avail = len(glob.glob(os.path.join(shards, "Client-*")))
    if n_avail == 0:
        raise FileNotFoundError(f"no Client-* shards under {shards!r}")
    ds = DatasetConfig.for_client_dirs(shards, n_avail)
    ds = type(ds)(data_path=ds.data_path,
                  devices_list=(ds.devices_list[client],))
    rngs = ExperimentRngs(run=0, data_seed=data_seed)
    clients = prepare_clients(ds, cfg, rngs.data_rng)
    data = stack_clients(clients, build_dev_dataset(clients, rngs.data_rng),
                         cfg.batch_size, device=device)
    return clients[0], data, rngs


def make_replica(cfg):
    """The reference's Shrink-AE with its own init (U(-1/sqrt(fan_in), ..)
    weights, zero biases, from torch's global generator on the CPU: a
    `torch.manual_seed` before the call selects the draw)."""
    import torch.nn as nn

    lam = cfg.shrink_lambda
    dim, hid, lat = cfg.dim_features, cfg.hidden_neus, cfg.latent_dim

    class SAE(nn.Module):
        def __init__(self):
            super().__init__()
            self.e1 = nn.Linear(dim, hid)
            self.e2 = nn.Linear(hid, lat)
            self.d1 = nn.Linear(lat, hid)
            self.d2 = nn.Linear(hid, dim)
            for layer in (self.e1, self.e2, self.d1, self.d2):
                bound = 1.0 / np.sqrt(layer.in_features)
                layer.weight.data.uniform_(-bound, bound)
                layer.bias.data.zero_()

        def forward(self, x):
            z = self.e2(torch.relu(self.e1(x)))
            r = self.d2(torch.relu(self.d1(z)))
            loss = (nn.MSELoss()(x, r) + lam *
                    torch.linalg.vector_norm(z, dim=1).sum() / z.shape[0])
            return z, r, loss

    return SAE()


def train_replica(m, train, valid, cfg, epochs, device):
    """The reference's trainer loop: sequential batches, epoch-mean train
    loss, batch-mean valid loss, patience early stop."""
    tr_t = torch.tensor(train, device=device)
    va_t = torch.tensor(valid, device=device)
    opt = torch.optim.Adam(m.parameters(), lr=cfg.lr_rate)
    b = cfg.batch_size
    minv, worse = float("inf"), 0
    th = {"train_loss": [], "valid_loss": []}
    for _ in range(epochs):
        m.train()
        el, nb = 0.0, 0
        for i in range(0, len(tr_t), b):
            _, _, loss = m(tr_t[i:i + b])
            loss.backward()
            opt.step()
            opt.zero_grad()
            el += loss.item()
            nb += 1
        m.eval()
        with torch.no_grad():
            vl = float(np.mean([m(va_t[i:i + b])[2].item()
                                for i in range(0, len(va_t), b)]))
        th["train_loss"].append(round(el / nb, 5))
        th["valid_loss"].append(round(vl, 5))
        if vl < minv:
            minv, worse = vl, 0
        else:
            worse += 1
            if worse >= cfg.patience:
                break
    return th


def replica_latents(m, train, test_x, device):
    with torch.no_grad():
        zt = m(torch.tensor(train, device=device))[0].cpu().numpy()
        zx = m(torch.tensor(test_x, device=device))[0].cpu().numpy()
    return zt, zx


def _engine(cfg, data, rngs, states=None):
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.models import make_model
    model = make_model("hybrid", cfg.dim_features,
                       shrink_lambda=cfg.shrink_lambda,
                       device=data.train_xb.device)
    return RoundEngine(model, cfg, data, n_real=1, rngs=rngs,
                       model_type="hybrid", update_type="mse_avg",
                       states=states)


def trajectory(cfg, c, data, rngs, epochs, device, states=None):
    """The paired trajectory: the port's engine for one round from its init
    (or `states`), the replica from a copy of that init."""
    eng = _engine(cfg, data, rngs, states)
    p0 = {coder: {name: {k: v[0].detach().cpu().numpy().copy()
                         for k, v in layer.items()}
                  for name, layer in layers.items()}
          for coder, layers in eng.model_params().items()}
    res = eng.run_round(0)
    tr = np.asarray(res.tracking[0])
    act = tr[:, 2] > 0
    ours = {"train_loss": [round(float(x), 5) for x in tr[act, 0]],
            "valid_loss": [round(float(x), 5) for x in tr[act, 1]],
            "auc": round(float(res.client_metrics[0]), 4)}

    m = make_replica(cfg)
    names = {"e1": ("encoder", "Dense_0"), "e2": ("encoder", "Dense_1"),
             "d1": ("decoder", "Dense_0"), "d2": ("decoder", "Dense_1")}
    for tn, (coder, name) in names.items():
        layer = getattr(m, tn)
        layer.weight.data = torch.tensor(p0[coder][name]["kernel"].T.copy())
        layer.bias.data = torch.tensor(p0[coder][name]["bias"].copy())
    m = m.to(device)
    th = train_replica(m, c.train_x, c.valid_x, cfg, epochs, device)
    zt, zx = replica_latents(m, c.train_x, c.test_x, device)
    th["auc"] = round(centroid_auc(zt, zx, c.test_y), 4)

    same_stop = (len(ours["train_loss"]) == len(th["train_loss"])
                 and len(ours["valid_loss"]) == len(th["valid_loss"]))
    max_dl = (max(max(abs(a - b) for a, b in zip(ours[k], th[k]))
                  for k in ("train_loss", "valid_loss"))
              if same_stop else float("inf"))
    return {
        "epochs_protocol": epochs, "ours": ours, "torch_replica": th,
        "same_stop_epoch": same_stop,
        "max_abs_loss_delta": round(max_dl, 6) if same_stop else None,
        "auc_delta": round(abs(ours["auc"] - th["auc"]), 4),
        "verdict": ("equivalent" if same_stop and max_dl < 1e-3 and
                    abs(ours["auc"] - th["auc"]) < 5e-3 else "DIVERGED"),
    }


def solo_distribution(cfg, c, data, n, device):
    """N solo trainings a side on the same arrays, scored by the same
    centroid AUC; only the init draws differ (each side its own stream)."""
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs

    eng = _engine(cfg, data, ExperimentRngs(run=0,
                                            data_seed=cfg.data_seed))
    tr_x = torch.tensor(c.train_x, device=eng.device)
    te_x = torch.tensor(c.test_x, device=eng.device)
    ours_auc, ours_div, ours_stop, ours_minv = [], 0, [], []
    for run in range(n):
        eng.rngs = ExperimentRngs(run=run, data_seed=cfg.data_seed)
        eng.reset_federation()
        res = eng.run_round(0)
        params = eng.model_params()
        with torch.no_grad():
            zt = eng.model.apply_params(params, tr_x)[0].cpu().numpy()
            zx = eng.model.apply_params(params, te_x)[0].cpu().numpy()
        if not (np.isfinite(zt).all() and np.isfinite(zx).all()):
            ours_div += 1
        ours_auc.append(round(centroid_auc(zt, zx, c.test_y), 4))
        tr = np.asarray(res.tracking[0])
        ours_stop.append(int((tr[:, 2] > 0).sum()))
        ours_minv.append(round(float(res.min_valid[0]), 5))

    torch_auc, torch_div, torch_stop, torch_minv = [], 0, [], []
    for run in range(n):
        torch.manual_seed(run * 10000)  # the reference's per-run seeding
        m = make_replica(cfg).to(device)
        th = train_replica(m, c.train_x, c.valid_x, cfg, cfg.epochs, device)
        zt, zx = replica_latents(m, c.train_x, c.test_x, device)
        if not (np.isfinite(zt).all() and np.isfinite(zx).all()):
            torch_div += 1
        torch_auc.append(round(centroid_auc(zt, zx, c.test_y), 4))
        torch_stop.append(len(th["valid_loss"]))
        torch_minv.append(round(min(th["valid_loss"]), 5))

    a, b = np.asarray(ours_auc), np.asarray(torch_auc)
    t = welch_t(a, b)

    def sd(x):
        return round(float(x.std(ddof=1)), 4) if len(x) > 1 else None

    return {
        "mode": "solo-distribution",
        "n_per_side": n, "epochs": cfg.epochs,
        "ours": {"mean": round(float(a.mean()), 4), "sd": sd(a),
                 "diverged": ours_div, "aucs": ours_auc,
                 "stop_epochs": ours_stop, "min_valid": ours_minv},
        "torch_replica": {"mean": round(float(b.mean()), 4), "sd": sd(b),
                          "diverged": torch_div, "aucs": torch_auc,
                          "stop_epochs": torch_stop,
                          "min_valid": torch_minv},
        "welch_t": None if t is None else round(t, 3),
        "reading": ("|t| >= 2: the solo outcome distributions differ, so "
                    "single-client training owns any federation-level gap; "
                    "|t| < 2: the solo sides match at this n, look in the "
                    "federation layer; null: zero within-side variance "
                    "with unequal means"),
    }


def probe(shards, client=5, data_seed=4, epochs=5, solo=0, *,
          device="cuda", states=None, prov=None):
    """The paired trajectory (`states` replaces the port's init) and, when
    `solo` > 0, the distribution probe under "solo"."""
    from fedmse_tpu_torch.config import ExperimentConfig

    cfg = ExperimentConfig(network_size=1, num_participants=1.0,
                           epochs=epochs, num_rounds=1, data_seed=data_seed)
    device = torch.device(device)
    c, data, rngs = load_client_partition(cfg, shards, client, data_seed,
                                          device)
    out = {"shards": shards, "client": client, "data_seed": data_seed,
           **trajectory(cfg, c, data, rngs, epochs, device, states)}
    if solo:
        out["solo"] = solo_distribution(cfg, c, data, solo, device)
    out.update(prov or {})
    return out


def main(argv=None):
    p = sweep.parser(__doc__, "PARITY_PROBE_torch.json")
    p.add_argument("--shards", default=os.path.join(
        REPO_ROOT, "Data", "kitsune-8clients-anchor"),
        help="a Client-k shard tree (default: the Kitsune anchor tree)")
    p.add_argument("--client", type=int, default=5)
    p.add_argument("--data-seed", type=int, default=4)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--solo", type=int, default=0,
                   help="N solo trainings a side (the distribution probe)")
    args = p.parse_args(argv)
    device, prov = sweep.start(args)
    out = probe(args.shards, args.client, args.data_seed, args.epochs,
                args.solo, device=device, prov=prov)
    sweep.write(args.out, out)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

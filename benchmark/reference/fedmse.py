"""A plain PyTorch reference of FedMSE's federated round (FedMSE, Computers
& Security 151:104337; judahx67/fedmse-decentralized `src/`), as the
benchmark's configurations state it. It imports nothing of the program:
it reads the benchmark's inputs (the federation's data, the initial
parameters, the seed) and works every round out again with autograd,
batched matrix products and numpy.

One round, for clients stacked on a leading axis:

1. the cohort: max(1, int(participation N)) clients from Python's
   `random.Random(seed + 7919 (run + 1)).sample(range(N), S)` (the
   reference implementation's selection stream, run 1);
2. local training of each cohort client on its own rows: unshuffled
   minibatches in order, one Adam step (b1 0.9, b2 0.999, eps 1e-8, a
   count per client that persists across rounds) per batch on the batch's
   masked mean reconstruction MSE, plus lambda times the masked mean
   latent norm (the shrink autoencoder), plus mu sum (p - p_global)^2
   (FedProx); after each epoch the validation loss (the same terms, per
   batch, averaged over the batches); a client stops after `patience`
   epochs without a better validation loss, the first epoch always runs;
   the final weights are kept;
3. the election: every model scores the first selected client's
   validation rows, standardized with their own mean and std (ddof 1,
   + 1e-8), as the mean over 128-row batches of the batch's mean row MSE;
   voter i (selection order) multiplies the scores by 1 + (u - 0.5) 2e-4
   with its row u of the round's uniform draws, [R, S, N] per chunk of R
   rounds from `torch.Generator().manual_seed(run seed)`, and the first
   voter with a candidate picks the selected client other than itself,
   under the quota of `max_aggregation` wins, with the least score (NaN
   worst; equal scores to the earliest selected);
4. the merge: weights 1 / (dev-set MSE) over the cohort, normalized
   (`mse_avg`), or uniform over the cohort (`fedprox`, `avg`), times the
   clients' parameters;
5. verification by every client but the aggregator, on the last client's
   validation rows: the first broadcast is accepted; later ones iff the
   sum over the eight tensors of ||history - broadcast||_F is at most the
   threshold and 1 / (1 + MSE) fell by at most the performance threshold;
   the history takes every broadcast, an acceptance loads it (it becomes
   p_global) and clears the rejection count, a rejection increments it;
   the aggregator loads the broadcast. A round without an aggregator
   changes nothing past training;
6. evaluation of every client: the ROC AUC of its test rows' anomaly
   scores (nan_to_num'd; `scores` gives them for any parameters): the
   row's reconstruction MSE, or, for the kNN score, the distance to the k-th nearest of a bank of `bank_size`
   latents of the client's own train rows (the bank_size valid rows of
   least priority, priorities from a generator seeded by
   SeedSequence([0, client])), the top-k taken over the minima of
   strided bins of 2 slots each (the configuration's `approx` top-k).

Parameters are one flat row per client in the published layout W1 [D, H],
b1, W2 [H, L], b2, W3 [L, H], b3, W4 [H, D], b4, each matrix [in, out]
row-major. Everything runs in float32 on the inputs' device, TF32 off;
with `tf32=True` (the control of the comparison) the operands of every
matrix product are rounded to TF32 first, as tensor cores in TF32 mode
read them.
"""

from __future__ import annotations

import random
from typing import Dict, List, Sequence

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8
VOTE_BATCH = 128
JITTER = 2e-4


def leaf_shapes(dims):
    d, h, lat = dims
    return [(d, h), (h,), (h, lat), (lat,), (lat, h), (h,), (h, d), (d,)]


def leaves(flat: torch.Tensor, dims) -> List[torch.Tensor]:
    """The eight tensors of flat rows [N, P], each [N, *shape] (views)."""
    out, at = [], 0
    for shape in leaf_shapes(dims):
        size = int(np.prod(shape))
        out.append(flat[:, at:at + size].reshape((flat.shape[0],) + shape))
        at += size
    return out


def tf32(t: torch.Tensor) -> torch.Tensor:
    """t rounded to TF32 (10 explicit mantissa bits, to nearest), as the
    tensor cores read a float32 operand in TF32 mode."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, low: bool = False) -> torch.Tensor:
    """The batched product a @ b in f32, or with both operands rounded to
    TF32 (`low`, the control's precision)."""
    return torch.bmm(tf32(a), tf32(b)) if low else torch.bmm(a, b)


def forward(flat: torch.Tensor, x: torch.Tensor, dims, low: bool = False):
    """(latent [N, R, L], reconstruction [N, R, D]) of rows x [N, R, D],
    client n's rows under client n's parameters."""
    w1, b1, w2, b2, w3, b3, w4, b4 = leaves(flat, dims)
    h1 = torch.relu(mm(x, w1, low) + b1[:, None])
    z = mm(h1, w2, low) + b2[:, None]
    h2 = torch.relu(mm(z, w3, low) + b3[:, None])
    return z, mm(h2, w4, low) + b4[:, None]


def loss_and_grads(flat, prev, x, m, dims, lam: float, mu: float,
                   low: bool = False):
    """(loss [C], grads [C, P]) of each client's batch x [C, R, D] (row mask
    m [C, R]): the masked mean row MSE, plus lam times the masked mean
    latent norm, plus mu sum (p - prev)^2 when mu; the backward pass
    written out (tests hold it to autograd)."""
    w1, b1, w2, b2, w3, b3, w4, b4 = leaves(flat, dims)
    t = lambda a: a.transpose(1, 2)  # noqa: E731
    h1 = torch.relu(mm(x, w1, low) + b1[:, None])
    z = mm(h1, w2, low) + b2[:, None]
    h2 = torch.relu(mm(z, w3, low) + b3[:, None])
    err = x - (mm(h2, w4, low) + b4[:, None])
    den = torch.clamp(m.sum(dim=1), min=1.0)[:, None]
    mw = m / den
    loss = (torch.square(err).mean(dim=-1) * mw).sum(dim=1)
    dr = (-2.0 / x.shape[-1]) * err * mw[:, :, None]
    dh2 = mm(dr, t(w4), low) * (h2 > 0)
    dz = mm(dh2, t(w3), low)
    if lam:
        norm = latent_norm(z)
        loss = loss + lam * (norm * mw).sum(dim=1)
        inv = torch.where(norm > 0, 1.0 / torch.where(norm > 0, norm, 1.0),
                          0.0)
        dz = dz + lam * z * (mw * inv)[:, :, None]
    dh1 = mm(dz, t(w2), low) * (h1 > 0)
    grads = torch.cat([g.reshape(g.shape[0], -1) for g in (
        mm(t(x), dh1, low), dh1.sum(dim=1), mm(t(h1), dz, low),
        dz.sum(dim=1), mm(t(z), dh2, low), dh2.sum(dim=1),
        mm(t(h2), dr, low), dr.sum(dim=1))], dim=1)
    if mu:
        loss = loss + mu * torch.square(flat - prev).sum(dim=-1)
        grads = grads + (2.0 * mu) * (flat - prev)
    return loss, grads


def row_mse(x: torch.Tensor, recon: torch.Tensor) -> torch.Tensor:
    return torch.square(x - recon).mean(dim=-1)


def latent_norm(z: torch.Tensor) -> torch.Tensor:
    """||z||_2 per row, 0 with a zero gradient at z = 0."""
    sq = torch.square(z).sum(dim=-1)
    pos = sq > 0
    return torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))) * pos


def masked_mean(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return (v * m).sum(dim=-1) / torch.clamp(m.sum(dim=-1), min=1.0)


def roc_auc(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mann-Whitney AUC of each row of scores [N, T] (average ranks for
    ties), in float64."""
    s = scores.to(torch.float64)
    srt = torch.sort(s, dim=-1).values.contiguous()
    s = s.contiguous()
    lo = torch.searchsorted(srt, s, side="left").to(torch.float64)
    hi = torch.searchsorted(srt, s, side="right").to(torch.float64)
    rank = lo + (hi - lo + 1.0) / 2.0
    pos = labels > 0.5
    n_pos = pos.sum(dim=-1).to(torch.float64)
    n_neg = labels.shape[-1] - n_pos
    rank_sum = torch.where(pos, rank, torch.zeros_like(rank)).sum(dim=-1)
    return (rank_sum - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)


def bank_priorities(client: int, rows: int) -> torch.Tensor:
    """The kNN bank's priorities of one client's train rows (on the CPU)."""
    state = np.random.SeedSequence([0, int(client)]).generate_state(
        2, dtype=np.uint32)
    g = torch.Generator().manual_seed(
        (int(state[0]) & 0x7fffffff) << 32 | int(state[1]))
    return torch.rand(rows, generator=g)


class Reference:
    """The federation's rounds in plain PyTorch. `cfg` holds the
    configuration's fields (see `benchmark/configs/*.json`); `data` the
    benchmark's inputs by name (train_xb, train_mb, valid_xb, valid_mb,
    valid_x, valid_m, test_x, test_y, dev_x); `params0` the initial flat
    parameters [N, P]; `seed` the run's seed."""

    def __init__(self, cfg: Dict, data: Dict[str, torch.Tensor],
                 params0: torch.Tensor, seed: int, tf32: bool = False,
                 block: int = 25):
        self.cfg, self.data, self.tf32, self.block = cfg, data, tf32, block
        self.dims = (cfg["dim_features"], cfg["hidden_neus"],
                     cfg["latent_dim"])
        self.n = params0.shape[0]
        self.cohort = max(1, int(cfg["num_participants"] * self.n))
        self.params = params0.clone()
        self.prev_global = params0.clone()
        self.mu = torch.zeros_like(params0)
        self.nu = torch.zeros_like(params0)
        self.count = torch.zeros(self.n, dtype=torch.int64,
                                 device=params0.device)
        self.hist = torch.zeros_like(params0)
        self.hist_perf = torch.zeros(self.n, device=params0.device)
        self.hist_seen = torch.zeros(self.n, dtype=torch.bool,
                                     device=params0.device)
        self.rejected = torch.zeros(self.n, dtype=torch.int64,
                                    device=params0.device)
        self.agg_count = np.zeros(self.n, dtype=np.int64)
        run_seed = int(seed) if int(seed) != 0 else 987654321
        self.select = random.Random(int(seed) + 7919 * 2)
        self.draw_gen = torch.Generator().manual_seed(run_seed)
        self.priorities = None

    # ---- local training ---- #

    def _terms(self):
        lam = self.cfg["shrink_lambda"] if self.cfg["model_type"] == \
            "hybrid" else 0.0
        mu = self.cfg["fedprox_mu"] if self.cfg["update_type"] == \
            "fedprox" else 0.0
        return lam, mu

    def _losses(self, p, prev, x, m, batches: int):
        """Each client's loss on each of `batches` equal batches of its rows
        x [C, R, D] (row mask m [C, R]): [C, batches]."""
        lam, mu = self._terms()
        c = x.shape[0]
        z, recon = forward(p, x, self.dims, self.tf32)
        m = m.view(c, batches, -1)
        loss = masked_mean(row_mse(x, recon).view(c, batches, -1), m)
        if lam:
            loss = loss + lam * masked_mean(
                latent_norm(z).view(c, batches, -1), m)
        if mu:
            loss = loss + mu * torch.square(p - prev).sum(dim=-1)[:, None]
        return loss

    def _train(self, sel: Sequence[int]):
        d, cfg = self.data, self.cfg
        idx = torch.as_tensor(sorted(sel), device=self.params.device)
        p = self.params.index_select(0, idx)
        prev = self.prev_global.index_select(0, idx)
        mu, nu = self.mu.index_select(0, idx), self.nu.index_select(0, idx)
        count = self.count.index_select(0, idx)
        txb, tmb = d["train_xb"].index_select(0, idx), \
            d["train_mb"].index_select(0, idx)
        vxb, vmb = d["valid_xb"].index_select(0, idx), \
            d["valid_mb"].index_select(0, idx)
        c, nb = txb.shape[:2]
        epochs, patience, lr = cfg["epochs"], cfg["patience"], cfg["lr_rate"]
        has_b = tmb.sum(dim=2) > 0
        has_v = vmb.sum(dim=2) > 0
        min_v = torch.full((c,), float("inf"), device=p.device)
        worse = torch.zeros(c, dtype=torch.int64, device=p.device)
        tracking = torch.zeros((c, epochs, 3), device=p.device)
        lam, mu_prox = self._terms()
        for e in range(epochs):
            active = (worse < patience) | (e == 0)
            if not bool(active.any()):
                break
            loss_sum = torch.zeros(c, device=p.device)
            for b in range(nb):
                loss, grads = loss_and_grads(p, prev, txb[:, b], tmb[:, b],
                                             self.dims, lam, mu_prox,
                                             self.tf32)
                step = (has_b[:, b] & active)[:, None]
                new_count = count + 1
                new_mu = (1 - B1) * grads + B1 * mu
                new_nu = (1 - B2) * grads * grads + B2 * nu
                cf = new_count.to(torch.float32)[:, None]
                upd = lr * (new_mu / (1 - torch.pow(B1, cf))) / (
                    torch.sqrt(new_nu / (1 - torch.pow(B2, cf))) + EPS)
                p = torch.where(step, p - upd, p)
                mu = torch.where(step, new_mu, mu)
                nu = torch.where(step, new_nu, nu)
                count = torch.where(step[:, 0], new_count, count)
                loss_sum = loss_sum + torch.where(has_b[:, b], loss, 0.0)
            train_loss = loss_sum / torch.clamp(has_b.sum(dim=1), min=1)
            per_batch = self._losses(p, prev, vxb.flatten(1, 2),
                                     vmb.flatten(1, 2), vxb.shape[1])
            v_loss = torch.where(has_v, per_batch, 0.0).sum(dim=1) \
                / torch.clamp(has_v.sum(dim=1), min=1)
            improved = (v_loss < min_v) & active
            min_v = torch.where(improved, v_loss, min_v)
            worse = torch.where(active, torch.where(improved, 0, worse + 1),
                                worse)
            row = torch.stack([train_loss, v_loss, torch.ones_like(v_loss)],
                              dim=1)
            tracking[:, e] = torch.where(active[:, None], row, tracking[:, e])
        self.params[idx], self.mu[idx], self.nu[idx] = p, mu, nu
        self.count[idx] = count
        full = torch.full((self.n, epochs, 3), float("nan"),
                          device=p.device)
        full[idx] = tracking
        best = torch.full((self.n,), float("nan"), device=p.device)
        best[idx] = min_v
        return full, best

    # ---- the election, the merge, verification ---- #

    def _vote_scores(self, voter: int) -> torch.Tensor:
        x = self.data["valid_x"][voter].to(torch.float32)
        m = self.data["valid_m"][voter]
        k = m.sum()
        mean = (x * m[:, None]).sum(dim=0) / k
        std = torch.sqrt((torch.square(x - mean) * m[:, None]).sum(dim=0)
                         / (k - 1)) + 1e-8
        xs = (x - mean) / std
        v = x.shape[0]
        nb = -(-v // VOTE_BATCH)
        pad = nb * VOTE_BATCH - v
        mb = torch.nn.functional.pad(m, (0, pad)).view(nb, VOTE_BATCH)
        has = mb.sum(dim=1) > 0
        out = []
        for lo in range(0, self.n, self.block * 8):
            p = self.params[lo:lo + self.block * 8]
            _, recon = forward(p, xs.expand(p.shape[0], v, -1), self.dims,
                               self.tf32)
            mse = torch.nn.functional.pad(row_mse(xs, recon), (0, pad))
            batch = (mse.view(-1, nb, VOTE_BATCH) * mb).sum(dim=2) \
                / torch.clamp(mb.sum(dim=1), min=1)
            out.append(torch.where(has, batch, 0.0).sum(dim=1)
                       / torch.clamp(has.sum(), min=1))
        return torch.cat(out)

    def _elect(self, sel, base, draws):
        """(aggregator or -1, the winning voter's jittered scores)."""
        pos = {c: i for i, c in enumerate(sel)}
        elig = [c for c in sel
                if self.agg_count[c] < self.cfg["max_aggregation_threshold"]]
        for i, voter in enumerate(sel):
            cands = [c for c in elig if c != voter]
            if not cands:
                continue
            u = draws[i].to(base.device)
            scores = base * (1.0 + (u - 0.5) * JITTER)
            sc = scores.cpu().numpy()
            return min(cands, key=lambda c: (
                np.inf if np.isnan(sc[c]) else float(sc[c]), pos[c])), scores
        return -1, torch.zeros_like(base)

    def _merge_weights(self, sel) -> torch.Tensor:
        w = torch.zeros(self.n, device=self.params.device)
        idx = torch.as_tensor(sel, device=self.params.device)
        if self.cfg["update_type"] != "mse_avg":
            w[idx] = 1.0 / len(sel)
            return w
        dev = self.data["dev_x"].to(torch.float32)
        mses = []
        for lo in range(0, len(sel), self.block):
            p = self.params.index_select(0, idx[lo:lo + self.block])
            _, recon = forward(p, dev.expand(p.shape[0], -1, -1), self.dims,
                               self.tf32)
            mses.append(row_mse(dev, recon).mean(dim=1))
        raw = 1.0 / torch.cat(mses)
        w[idx] = raw / raw.sum()
        return w

    def _verify(self, agg: int, merged: torch.Tensor) -> None:
        cfg = self.cfg
        x = self.data["valid_x"][self.n - 1].to(torch.float32)
        m = self.data["valid_m"][self.n - 1]
        _, recon = forward(merged[None], x[None], self.dims, self.tf32)
        perf = 1.0 / (1.0 + masked_mean(row_mse(x[None], recon), m[None])[0])
        delta = sum(torch.sqrt(torch.square(a - b).flatten(1).sum(1))
                    for a, b in zip(leaves(self.hist, self.dims),
                                    leaves(merged[None], self.dims)))
        first = ~self.hist_seen
        change = torch.where(first, 0.0, perf - self.hist_perf)
        ok = (delta <= cfg["verification_threshold"]) & \
            (change >= -cfg["performance_threshold"])
        is_agg = torch.arange(self.n, device=merged.device) == agg
        attempted = ~is_agg
        accepted = attempted & (first | ok)
        load = accepted | is_agg
        self.params = torch.where(load[:, None], merged[None], self.params)
        self.prev_global = torch.where(accepted[:, None], merged[None],
                                       self.prev_global)
        self.hist = torch.where(attempted[:, None], merged[None], self.hist)
        self.hist_perf = torch.where(attempted, perf, self.hist_perf)
        self.hist_seen = self.hist_seen | attempted
        self.rejected = torch.where(
            attempted, torch.where(accepted, 0, self.rejected + 1),
            self.rejected)

    # ---- evaluation ---- #

    def scores(self, params: torch.Tensor) -> torch.Tensor:
        """The anomaly scores [N, T] (nan_to_num'd) of every client's test
        rows under `params` [N, P]: its own state's, or a state read back
        from the program to judge the program's scores."""
        d, cfg = self.data, self.cfg
        params = params.to(self.params.device, torch.float32)
        out = []
        for lo in range(0, self.n, self.block):
            hi = min(lo + self.block, self.n)
            p = params[lo:hi]
            x = d["test_x"][lo:hi].to(torch.float32)
            z, recon = forward(p, x, self.dims, self.tf32)
            if cfg["score_kind"] != "knn":
                scores = row_mse(x, recon)
            else:
                scores = self._knn_scores(lo, hi, p, z)
            out.append(torch.nan_to_num(scores))
        return torch.cat(out)

    def _evaluate(self) -> torch.Tensor:
        return roc_auc(self.scores(self.params), self.data["test_y"])

    def _knn_scores(self, lo, hi, p, z):
        d, cfg = self.data, self.cfg
        xb = d["train_xb"][lo:hi].to(torch.float32)
        c, nb, b, dim = xb.shape
        rows = nb * b
        zt, _ = forward(p, xb.reshape(c, rows, dim), self.dims, self.tf32)
        valid = d["train_mb"][lo:hi].reshape(c, rows) > 0
        if self.priorities is None:
            self.priorities = torch.stack(
                [bank_priorities(g, rows) for g in range(self.n)]).to(
                    xb.device)
        pri = torch.where(valid, self.priorities[lo:hi], float("inf"))
        size = 1 << (cfg["knn_bank_size"] - 1).bit_length()
        order = torch.argsort(pri, dim=1, stable=True)[:, :size]
        bank = torch.gather(zt, 1, order[:, :, None].expand(
            c, order.shape[1], zt.shape[2]))
        count = torch.clamp(valid.sum(dim=1), max=size)
        dist = torch.square(z[:, :, None, :] - bank[:, None, :, :]).sum(-1)
        dist = torch.nn.functional.pad(dist, (0, size - dist.shape[-1]),
                                       value=float("inf"))
        slot = torch.arange(size, device=z.device)
        dist = torch.where(slot < count[:, None, None], dist, float("inf"))
        k = cfg["knn_k"]
        bins = min(1 << (k * 32 - 1).bit_length(), size)
        if size % bins:
            bins = size
        mins = dist.reshape(c, z.shape[1], size // bins, bins).amin(dim=2)
        mins = torch.nn.functional.pad(mins, (0, max(0, k - bins)),
                                       value=float("inf"))
        smallest = torch.topk(mins, k, dim=-1, largest=False).values
        at = (torch.clamp(count, max=k) - 1).clamp(min=0)
        kth = torch.gather(smallest, 2, at[:, None, None].expand(
            c, z.shape[1], 1))[..., 0]
        return torch.where(count[:, None] > 0, torch.sqrt(kth), 0.0)

    # ---- rounds ---- #

    def round(self, draws: torch.Tensor) -> Dict:
        """One round with the voters' uniforms draws [S, N]; returns its
        outputs on the host."""
        sel = self.select.sample(range(self.n), self.cohort)
        tracking, min_valid = self._train(sel)
        base = self._vote_scores(sel[0])
        agg, scores = self._elect(sel, base, draws)
        weights = torch.zeros(self.n, device=self.params.device)
        if agg >= 0:
            weights = self._merge_weights(sel)
            merged = mm(weights[None, None], self.params[None],
                        self.tf32)[0, 0]
            self._verify(agg, merged)
            self.agg_count[agg] += 1
        auc = self._evaluate()
        host = lambda t: t.detach().cpu().numpy().copy()  # noqa: E731
        return {"selected": list(sel), "aggregator": agg,
                "scores": host(scores), "weights": host(weights),
                "rejected": host(self.rejected), "metrics": host(auc),
                "tracking": host(tracking), "min_valid": host(min_valid)}

    def run(self, chunks: Sequence[int], evals: bool = False) -> Dict:
        """The rounds of chunks of len(chunks) sizes, each chunk's uniforms
        drawn at once; returns every round's outputs and the state after
        each chunk (params, Adam's moments) on the host, and with `evals`
        the state's parameters and test scores after each chunk but the
        first (as the program's record keeps them)."""
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            rounds, states, kept = [], [], []
            for i, k in enumerate(chunks):
                draws = torch.rand((k, self.cohort, self.n),
                                   generator=self.draw_gen)
                for r in range(k):
                    rounds.append(self.round(draws[r]))
                states.append({name: getattr(self, name).detach().cpu()
                               .numpy().copy() for name in ("params", "mu")})
                if evals and i > 0:
                    kept.append({"params": states[-1]["params"],
                                 "scores": self.scores(self.params).cpu()
                                 .numpy()})
            out = {"rounds": rounds, "states": states}
            if evals:
                out["evals"] = kept
            return out
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

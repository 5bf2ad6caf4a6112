"""The driver of the KitNET training cells: federated_rounds' window, trace,
ledger and scoring helpers over a federation of KitNET detectors, with
inputs of N-BaIoT's layout.

Inputs (all from --seed, on the device, in a few large calls):

* each gateway's `normal_rows` normal and `abnormal_rows` abnormal rows
  of `sum(stream_stats) * windows` features in N-BaIoT's column order
  (Meidan et al. 2018, Kitsune's AfterImage statistics): for each stream
  group of `stream_stats` statistics (N-BaIoT: MI_dir 3, H 3, HH 7,
  HH_jit 3, HpHp 7), its `windows` damped windows in turn, each window's
  statistics in turn. A normal row is x_{j,w} = sqrt(0.9) u_j + sqrt(0.1)
  eps_{j,w}, u and eps N(0, 1): the windows of one statistic correlate at
  0.9, statistics not at all. An abnormal row is 4 + 2 (the same
  construction). The normal rows split 40/10/40/10 into train,
  validation, dev and test, every split min-max scaled by the gateway's
  own train rows (the configuration's scaler); the test set is the normal
  test rows then the abnormal rows. The shared dev set is
  `dev_rows_per_gateway` rows drawn without replacement from each
  gateway's dev split, min-max scaled by its own extremes;
* the feature map of `reference/kitnet.feature_map` (m = the
  configuration's `kitnet_max_ae`) over the scaled train rows, handed to
  the program and to the reference alike;
* each gateway's initial parameters, Kitsune's init: U(+-1/n_visible)
  weights, zero biases, one flat f32 row in the layout of
  `reference/kitnet.py`; the statistics start at (+inf, -inf).

The program: `fedmse_tpu_torch.federation.rounds.RoundEngine` of
`make_model("kitnet", ...)` on that map, the fused round (CUDA graphs on
the card), driven as `federated_rounds` drives the autoencoders:
set-up in chunks of SETUP_CHUNKS and EVAL_CHUNK through
`run_pipelined_schedule`, whose outputs, states (with the statistics) and
scores the comparison keeps; then the window, the traced chunk and the
end-to-end metric of `federated_rounds` as they are. The window's result
also names the feature map, which the KitNET kernels' roofline readers
time their kernels at.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from benchmark import roofline_kitnet
from benchmark.drivers import federated_rounds as fr
from benchmark.drivers.federated_rounds import (  # noqa: F401 (the driver API)
    EVAL_CHUNK, SETUP_CHUNKS, end_to_end, free_program, traced_chunk)
from benchmark.reference import kitnet as ref

# the sizes a rehearsal on the CPU runs these cells at (benchmark/tests):
# 4 statistics x 5 windows; hidden_neus keeps compare.py's first slice of
# a row the whole row, as at the cell's size
TINY = {"config": {"dim_features": 20, "hidden_neus": 27, "latent_dim": 7},
        "traffic": {"gateways": 6, "normal_rows": 300, "abnormal_rows": 60,
                    "dev_rows_per_gateway": 20, "stream_stats": [2, 2],
                    "windows": 5}}


def statistic_of_column(stream_stats, windows: int) -> torch.Tensor:
    """[D] int64: the statistic each column of N-BaIoT's layout holds."""
    cols, first = [], 0
    for count in stream_stats:
        for _ in range(windows):
            cols += range(first, first + count)
        first += count
    return torch.tensor(cols, dtype=torch.int64)


def windowed(g: torch.Generator, n: int, rows: int, stat_of: torch.Tensor,
             device) -> torch.Tensor:
    """[n, rows, D]: sqrt(0.9) u_{stat(col)} + sqrt(0.1) eps_col."""
    stats = int(stat_of.max()) + 1
    u = torch.randn((n, rows, stats), generator=g, device=device)
    eps = torch.randn((n, rows, stat_of.shape[0]), generator=g,
                      device=device)
    return (0.9 ** 0.5) * u[:, :, stat_of.to(device)] + (0.1 ** 0.5) * eps


def _minmax(x: torch.Tensor, fit: torch.Tensor) -> torch.Tensor:
    """x scaled by the column extremes of the rows `fit` [..., R, D] (a
    constant column: range 1)."""
    lo = fit.amin(dim=-2, keepdim=True)
    span = fit.amax(dim=-2, keepdim=True) - lo
    return (x - lo) / torch.where(span == 0, torch.ones_like(span), span)


def make_federation(traffic: Dict, cfg: Dict, seed: int,
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """The federation's tensors by FederatedData's field names."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    stat_of = statistic_of_column(traffic["stream_stats"],
                                  traffic["windows"])
    n, dim = traffic["gateways"], cfg["dim_features"]
    if stat_of.shape[0] != dim:
        raise ValueError(f"the traffic's {stat_of.shape[0]} columns are "
                         f"not the configuration's {dim} features")
    rows, ab = traffic["normal_rows"], traffic["abnormal_rows"]
    n_train, n_valid, n_dev, n_test = fr.split_sizes(rows)
    normal = windowed(g, n, rows, stat_of, device)
    abnormal = 4.0 + 2.0 * windowed(g, n, ab, stat_of, device)
    train = normal[:, :n_train]
    cut = [n_train, n_train + n_valid, n_train + n_valid + n_dev]
    valid = _minmax(normal[:, cut[0]:cut[1]], train)
    dev_raw = normal[:, cut[1]:cut[2]]
    test = torch.cat([_minmax(normal[:, cut[2]:], train),
                      _minmax(abnormal, train)], dim=1)
    per = traffic.get("dev_rows_per_gateway") or n_dev
    pick = torch.rand((n, n_dev), generator=g, device=device).argsort(
        dim=1)[:, :per]
    pool = torch.gather(dev_raw, 1, pick[:, :, None].expand(n, per, dim))
    pool = pool.reshape(n * per, dim)
    train = _minmax(train, train)
    batch = cfg["batch_size"]
    train_xb, train_mb = fr._batches(train, batch)
    valid_xb, valid_mb = fr._batches(valid, batch)
    labels = torch.cat([torch.zeros(n_test), torch.ones(ab)]).to(device)
    return {"train_xb": train_xb, "train_mb": train_mb,
            "valid_xb": valid_xb, "valid_mb": valid_mb,
            "valid_x": valid.contiguous(),
            "valid_m": torch.ones((n, n_valid), device=device),
            "test_x": test.contiguous(),
            "test_m": torch.ones((n, n_test + ab), device=device),
            "test_y": labels.expand(n, -1).contiguous(),
            "dev_x": _minmax(pool, pool).contiguous(),
            "client_mask": torch.ones(n, device=device)}


def init_params(n: int, fmap, beta: float, seed: int,
                device: torch.device) -> torch.Tensor:
    """[N, P] f32: U(+-1/n_visible) weights, zero biases, one call."""
    g = torch.Generator(device=device).manual_seed(int(seed) + 1)
    bounds = []
    for shape in ref.leaf_shapes(fmap, beta):
        size = int(np.prod(shape))
        bounds.append(torch.full((size,), 1.0 / shape[0]
                                 if len(shape) == 2 else 0.0))
    bound = torch.cat(bounds).to(device)
    u = torch.rand((n, bound.shape[0]), generator=g, device=device)
    return (u * 2.0 - 1.0) * bound


@dataclasses.dataclass
class KitnetFederation(fr.Federation):
    """federated_rounds' Federation with the federation's feature map."""

    fmap: Tuple[Tuple[int, ...], ...] = ()


def _beta(config: Dict) -> float:
    return float(config.get("kitnet_hidden_ratio", 0.75))


def inputs(config: Dict, traffic: Dict, seed: int,
           device: torch.device) -> KitnetFederation:
    """The benchmark's inputs from the seed, with no program built."""
    data = make_federation(traffic, config, seed, device)
    n, nb, b, d = data["train_xb"].shape
    fmap = ref.feature_map(data["train_xb"].reshape(n, nb * b, d)[
        :, :fr.split_sizes(traffic["normal_rows"])[0]],
        config["kitnet_max_ae"])
    return KitnetFederation(
        config, traffic, seed, data,
        init_params(traffic["gateways"], fmap, _beta(config), seed, device),
        fmap=fmap)


def setup(config: Dict, traffic: Dict, seed: int,
          device: torch.device) -> KitnetFederation:
    """Inputs, the engine, and the set-up rounds (which capture the
    graphs) through the window's own call."""
    from fedmse_tpu_torch.data.stacking import FederatedData
    from fedmse_tpu_torch.federation.pipeline import run_pipelined_schedule
    from fedmse_tpu_torch.federation.rounds import RoundEngine
    from fedmse_tpu_torch.federation.state import fresh_states
    from fedmse_tpu_torch.models import kitnet, make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    fed = inputs(config, traffic, seed, device)
    cfg = fr.experiment_config(config)
    model = make_model("kitnet", config["dim_features"],
                       precision=cfg.precision, device=device,
                       feature_map=fed.fmap,
                       hidden_ratio=cfg.kitnet_hidden_ratio)
    layout = model.param_layout
    rngs = ExperimentRngs(run=1, data_seed=int(seed),
                          run_seed_stride=int(seed))
    states = fresh_states(fed.params0.clone(), kitnet.fresh_stats(
        traffic["gateways"], layout, device))
    engine = RoundEngine(model, cfg, FederatedData(**fed.data),
                         n_real=traffic["gateways"], rngs=rngs,
                         model_type="kitnet",
                         update_type=config["update_type"], states=states,
                         fused=True)
    fed.engine = engine
    rounds, snaps, evals = [], [], []

    def consume(results, sec):
        rounds.extend(fr._program_round(r) for r in results)
        return None

    with fr.kept_scores() as held:
        for i, k in enumerate(SETUP_CHUNKS + (EVAL_CHUNK,)):
            run_pipelined_schedule(engine, fed.rounds_done,
                                   fed.rounds_done + k,
                                   cfg.fused_schedule_chunk, consume,
                                   can_rewind=False, pipelined=True)
            fed.rounds_done += k
            snap = fr._snapshot(engine.states)
            snap["stats"] = engine.states.stats.detach().cpu().numpy().copy()
            snaps.append(snap)
            if i > 0:
                evals.append({"params": snap["params"],
                              "stats": snap["stats"],
                              "scores": held["scores"].detach().cpu()
                              .numpy().copy(), "position": k - 1})
        held.clear()
    fed.setup_record = {"params0": fed.params0.cpu().numpy().copy(),
                        "rounds": rounds[:sum(SETUP_CHUNKS)],
                        "states": snaps[:len(SETUP_CHUNKS)],
                        "evals": evals}
    return fed


def window(fed: KitnetFederation, seconds: float) -> Dict:
    """federated_rounds' window, its result naming the feature map."""
    out = fr.window(fed, seconds)
    out["feature_map"] = fed.fmap
    return out


def reference_record(fed: KitnetFederation, judged: Optional[Dict] = None,
                     tf32: bool = False) -> Dict:
    """The reference's rounds over SETUP_CHUNKS from the benchmark's inputs
    and its scores of the test rows under each state (params and
    statistics) that `judged` kept in its "evals" (federated_rounds'
    reference_record, for KitNET)."""
    r = ref.KitnetReference(fed.config, fed.data, fed.params0, fed.seed,
                            fed.fmap, tf32=tf32)
    out = r.run(SETUP_CHUNKS, evals=tf32)
    out["params0"] = fed.params0.cpu().numpy().copy()
    if judged is not None:
        out["evals"] = [{"scores": r.scores(torch.as_tensor(e["params"]),
                                            torch.as_tensor(e["stats"]))
                         .cpu().numpy()} for e in judged["evals"]]
    return out


def shapes_of(traffic: Dict, cfg: Dict) -> Dict[str, int]:
    """The cell's shapes (federated_rounds'), with the traffic's nominal
    feature map: each statistic's windows one cluster (the map a run
    computes depends on its rows; the readers take the run's own)."""
    out = fr.shapes_of(traffic, cfg)
    stat_of = statistic_of_column(traffic["stream_stats"],
                                  traffic["windows"]).tolist()
    groups = {}
    for col, stat in enumerate(stat_of):
        groups.setdefault(stat, []).append(col)
    out["nominal_map"] = tuple(tuple(c) for c in groups.values())
    return out


def flops_per_round(fed_config: Dict, traffic: Dict) -> float:
    shapes = shapes_of(traffic, fed_config)
    parts = roofline_kitnet.round_flops(shapes, shapes["nominal_map"],
                                        fed_config["update_type"],
                                        _beta(fed_config))
    return sum(parts.values())

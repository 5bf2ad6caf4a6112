"""Rank jobs of the port's client-mesh tests (tests/test_torch_parallel.py,
test_torch_shard.py, test_torch_podscale.py).

Each job runs on one rank of a gloo launch on the CPU
(fedmse_tpu_torch.parallel.launch.spawn) and returns host numpy: every
rank runs every check of its session once, and the test process holds the
ranks' results against each other, against the port's dense engine and
against the JAX package. This module imports torch and numpy only: a rank
imports no jax. The inputs the JAX side needs too are made here from
numpy seeds (`merge_inputs`, `federation`).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from fedmse_tpu_torch.config import CompatConfig, ExperimentConfig
from fedmse_tpu_torch.data import stack_clients, synthetic_clients
from fedmse_tpu_torch.data.stacking import pad_federated_data
from fedmse_tpu_torch.models import make_model
from fedmse_tpu_torch.models.flat import ParamLayout

DIMS = (16, 8, 3)
LAYOUT = ParamLayout(*DIMS)
N_CLIENTS = 10
BLOCK = 64  # the quantized merge's block in the merge checks


def merge_inputs(n: int, seed: int = 0):
    """Stacked flat params [n, P], a selection mask [n], dev rows [32, 16]
    and a K = 3 assignment [n] whose cluster 2 has no selected member."""
    rng = np.random.default_rng(seed)
    params = (rng.normal(size=(n, LAYOUT.size)) * 0.3).astype(np.float32)
    sel = (np.arange(n) % 3 != 1).astype(np.float32)
    dev = rng.normal(size=(32, DIMS[0])).astype(np.float32)
    cluster = (np.arange(n) % 2).astype(np.int64)
    cluster[np.arange(n) % 3 == 1] = 2  # unselected: cluster 2 is empty
    return params, sel, dev, cluster


def federation_clients(n: int = N_CLIENTS, seed: int = 0):
    kw = dict(n_clients=n, dim=DIMS[0], n_normal=240, n_abnormal=120,
              seed=seed)
    clients = synthetic_clients(**kw)
    dev_x = np.concatenate([c.dev_raw for c in clients])[:200].astype(
        np.float32)
    return kw, clients, dev_x


def federation(n: int = N_CLIENTS, pad_to: int = 0):
    _, clients, dev_x = federation_clients(n)
    data = stack_clients(clients, dev_x, 12, device="cpu")
    return pad_federated_data(data, max(pad_to, n))


def config(**kw) -> ExperimentConfig:
    base = dict(dim_features=DIMS[0], hidden_neus=DIMS[1],
                latent_dim=DIMS[2], network_size=N_CLIENTS, epochs=3,
                num_rounds=3, compat=CompatConfig(vote_tie_break=False))
    base.update(kw)
    return ExperimentConfig(**base)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


def _result(r) -> Dict:
    return {k: v for k, v in vars(r).items() if k != "phase_seconds"}


# ---- the merges ---- #

def merges(mesh, n: int) -> Dict:
    from fedmse_tpu_torch.parallel import collectives as coll
    from fedmse_tpu_torch.parallel.costmodel import seam
    params, sel, dev, cluster = merge_inputs(n)
    lo, hi = mesh.block(n)
    model = make_model("hybrid", *DIMS, 3.0, device="cpu")
    p, s = torch.from_numpy(params[lo:hi]), torch.from_numpy(sel[lo:hi])
    c, d = torch.from_numpy(cluster[lo:hi]), torch.from_numpy(dev)
    out: Dict = {"block": (lo, hi)}
    for ut in ("avg", "mse_avg"):
        m, w = coll.make_shardmap_aggregate(model, ut, mesh)(p, s, d)
        out[f"shard_map/{ut}"] = (_np(m), _np(w))
        m, w = coll.make_hierarchical_aggregate(
            model, ut, mesh, num_groups=2, block_size=BLOCK)(p, s, d)
        out[f"quantized2/{ut}"] = (_np(m), _np(w))
        m, _ = coll.make_hierarchical_aggregate(
            model, ut, mesh, num_groups=1, block_size=BLOCK)(p, s, d)
        out[f"quantized1/{ut}"] = _np(m)
        for k in (1, 3):
            cp, w, has = coll.make_clustered_shardmap_aggregate(
                model, ut, mesh, k)(p, s, d, c)
            out[f"cshard_map{k}/{ut}"] = (_np(cp), _np(w), _np(has))
        seam.reset()
        cp, w, has = coll.make_clustered_hierarchical_aggregate(
            model, ut, mesh, 3, num_groups=2, block_size=BLOCK)(p, s, d, c)
        out[f"cquantized2/{ut}"] = (_np(cp), _np(w), _np(has))
        out[f"seam/{ut}"] = seam.snapshot()
        cp, w, has = coll.make_clustered_hierarchical_aggregate(
            model, ut, mesh, 1, num_groups=2, block_size=BLOCK)(p, s, d, c)
        out[f"cquantized1k/{ut}"] = (_np(cp), _np(w), _np(has))
    mask = torch.from_numpy((np.arange(n) < n - 2).astype(np.float32))
    out["divergence"] = _np(coll.make_shardmap_divergence(mesh)(
        p, mask[lo:hi]))
    return out


# ---- the sharded round ---- #

def run_engine(mesh, cfg, n_real=N_CLIENTS, pad_to=0, init=None,
               model_type="hybrid", update_type="mse_avg", rounds=3,
               **kw) -> Dict:
    """A fused RoundEngine over `mesh` (None: the dense engine): round 1
    alone, then the rest in one chunk; the results, round 1's gathered
    params and the final evaluation."""
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    data = federation(n_real, pad_to)
    model = make_model(model_type, *DIMS, cfg.shrink_lambda, device="cpu")
    eng = RoundEngine(model, cfg, data, n_real=n_real,
                      rngs=ExperimentRngs(run=0), model_type=model_type,
                      update_type=update_type, fused=True, mesh=mesh,
                      states=init, **kw)
    res = eng.run_rounds(0, 1)
    p1 = eng.gathered_states().params.numpy()
    if rounds > 1:
        res += eng.run_rounds(1, rounds - 1)
    return {"results": [_result(r) for r in res], "params1": p1,
            "params": eng.gathered_states().params.numpy(),
            "final": eng.evaluate(), "compact": eng.compact,
            "backend": eng.agg_backend,
            "plan": None if eng._merge_plan is None
            else eng._merge_plan["chosen"],
            "plan_cached": None if eng._merge_plan is None
            else eng._merge_plan["cached"]}


def early_stop_run(mesh, stop_at: int = 3, chunk: int = 2,
                   rounds: int = 6) -> Dict:
    """The pipelined chunk loop with a stop inside a chunk (round
    `stop_at`, 0-based), rewound and replayed."""
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.federation.pipeline import run_pipelined_schedule
    from fedmse_tpu_torch.parallel.multihost import uniform_decision
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    cfg = config(num_rounds=rounds, fused_schedule_chunk=chunk)
    sharded = mesh is not None and mesh.sharded
    data = federation(N_CLIENTS)
    model = make_model("hybrid", *DIMS, cfg.shrink_lambda, device="cpu")
    eng = RoundEngine(model, cfg, data, n_real=N_CLIENTS,
                      rngs=ExperimentRngs(run=0), model_type="hybrid",
                      update_type="mse_avg", fused=True,
                      mesh=mesh if sharded else None)
    seen: List = []

    def consume(chunk_results, sec):
        for j, r in enumerate(chunk_results):
            seen.append(_result(r))
            stop = r.round_index == stop_at
            if sharded:
                stop = uniform_decision(stop, mesh)
            if stop:
                return j
        return None

    run_pipelined_schedule(eng, 0, rounds, chunk, consume, can_rewind=True,
                           pipelined=True)
    return {"seen": seen, "params": eng.gathered_states().params.numpy(),
            "agg_count": eng.host.aggregation_count.copy()}


def sharded_adam(mesh, n: int = 8) -> Dict:
    from fedmse_tpu_torch.federation.state import make_sharded_client_update
    rng = np.random.default_rng(5)
    params = torch.from_numpy(rng.normal(size=(n, LAYOUT.size)).astype(
        np.float32))
    grads = torch.from_numpy(rng.normal(size=(n, LAYOUT.size)).astype(
        np.float32))
    from fedmse_tpu_torch.federation.optim import adam_init
    lo, hi = mesh.block(n)
    full = make_sharded_client_update(1e-3)(grads, adam_init(params), params)
    mine = make_sharded_client_update(1e-3, mesh)(
        grads[lo:hi], adam_init(params[lo:hi]), params[lo:hi])
    return {"full": [_np(t) for t in (full[0], *full[1])],
            "mine": [_np(t) for t in (mine[0], *mine[1])], "block": (lo, hi)}


# ---- the tier ---- #

def tier_config(**kw):
    return config(**{"network_size": 12, "num_participants": 1.0,
                     "state_layout": "tiered", **kw})


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def run_tier(mesh, host_sharded: bool = False, ratio: float = 1.0,
             resume_dir=None, cluster_refit: int = 0, n: int = 12,
             rounds: int = 3, hosts=None, local_data: bool = False) -> Dict:
    """The tier over `mesh`; `hosts` names the ranks' hosts in place of
    the mesh's own (the same process group), and `local_data` hands each
    rank only its block of client rows."""
    import dataclasses
    from fedmse_tpu_torch.checkpointing import CheckpointManager
    from fedmse_tpu_torch.cluster import ClusterSpec
    from fedmse_tpu_torch.federation.tiered import (COHORT_DATA_FIELDS,
                                                    run_tiered_combination)
    from fedmse_tpu_torch.parallel import ClientMesh
    from fedmse_tpu_torch.parallel.mesh import my_tier_block
    if hosts is not None:
        mesh = ClientMesh(mesh.world_size, mesh.rank, mesh.device,
                          mesh.backend, pg=mesh.group.pg, hosts=hosts)
    cfg = tier_config(num_participants=ratio, host_sharded=host_sharded,
                      num_rounds=rounds)
    cluster = (ClusterSpec(k=2, refit_every=cluster_refit)
               if cluster_refit else None)
    data = federation(n)
    lo, hi = my_tier_block(n, mesh.world_size, mesh.rank) \
        if mesh is not None else (0, n)
    block_bytes = _nbytes(getattr(data, f)[lo:hi]
                          for f in COHORT_DATA_FIELDS)
    if local_data:
        data = dataclasses.replace(data, **{
            f: getattr(data, f)[lo:hi].clone() for f in
            (*COHORT_DATA_FIELDS, "client_mask")})
    fits: List[int] = []
    out = run_tiered_combination(
        cfg, data, n, "hybrid", "mse_avg", 0, mesh=mesh,
        device="cpu", cluster=cluster, local_data=local_data,
        resume=None if resume_dir is None else CheckpointManager(resume_dir),
        on_round=lambda r, s: fits.append(r.round_index))
    eng = out["engine"]
    return {"results": [_result(r) for r in out["rounds"]],
            "final": np.asarray(out["final_metrics"]),
            "rows": (eng.shard_start, eng.shard_stop),
            "host_sharded": eng.host_sharded,
            "host_data_bytes": _nbytes(eng.host_data.values()),
            "block_data_bytes": block_bytes,
            "blocks": list(eng._blocks),
            "host_bytes": eng.store.host_bytes(),
            "params": eng.store.host.params.numpy().copy(),
            "cluster_fitted_round": eng.cluster_fitted_round,
            "cohort": eng.cohort, "rounds_run": out["rounds_run"]}


# ---- serving, the plan, the driver ---- #

def serving(mesh) -> Dict:
    from fedmse_tpu_torch.serving import ContinuousBatcher, ServingEngine
    rng = np.random.default_rng(6)
    n = 8
    model = make_model("autoencoder", *DIMS, 1.0, device="cpu")
    params = LAYOUT.tree(torch.from_numpy(
        (rng.normal(size=(n, LAYOUT.size)) * 0.3).astype(np.float32)))
    rows = rng.normal(size=(64, DIMS[0])).astype(np.float32)
    gws = rng.integers(0, n, 64).astype(np.int32)
    out = {}
    for precision in ("f32", "bf16"):
        plain = ServingEngine(model, "autoencoder", params, max_bucket=64,
                              precision=precision, device="cpu")
        meshed = ServingEngine(model, "autoencoder", params, max_bucket=64,
                               precision=precision, mesh=mesh, device="cpu")
        out[precision] = {
            take: (meshed.score(rows[:take], gws[:take]),
                   plain.score(rows[:take], gws[:take]))
            for take in (64, 16, 3)}
        out[f"sharded/{precision}"] = meshed.gateway_sharded
    front = ContinuousBatcher(meshed, max_batch=32, latency_budget_ms=1e9)
    tks = [front.submit(rows[i], gws[i]) for i in range(40)]
    front.drain()
    out["front"] = (np.asarray([t.score for t in tks], np.float32),
                    plain.score(rows[:40], gws[:40]))
    odd = ServingEngine(model, "autoencoder",
                        {c: {d: {k: v[:7] for k, v in layer.items()}
                             for d, layer in coder.items()}
                         for c, coder in params.items()},
                        max_bucket=64, mesh=mesh, device="cpu")
    out["odd_sharded"] = odd.gateway_sharded
    return out


def plan(mesh, cache_path: str) -> Dict:
    from fedmse_tpu_torch.parallel.costmodel import plan_merge
    os.environ["FEDMSE_TUNE_CACHE"] = cache_path
    os.environ["FEDMSE_TUNE"] = "1"
    kw = dict(k=2, block_sizes=(64,), repeats=1, max_group_candidates=1)
    first = plan_merge(mesh, [LAYOUT.size], **kw)
    mesh.barrier()  # rank 0 has stored it
    again = plan_merge(mesh, [LAYOUT.size], **kw)
    drift = plan_merge(mesh, [LAYOUT.size], **{**kw, "block_sizes": (32,)})
    return {"first": first, "again": again, "drift": drift}


def driver(mesh, root: str, argv: List[str]) -> Dict:
    from fedmse_tpu_torch.main import main
    out = main(argv)
    return {"summary_path": out["summary_path"],
            "best": out["best_metrics"],
            "backend": [v["aggregation_backend_effective"]
                        for v in out["results"].values()],
            "final": [v["final_metrics"] for v in out["results"].values()],
            "rank": mesh.rank}


# ---- the sessions: every check of a world size, once ---- #

def session(mesh, init_path: str = "", ckpt_dir: str = "",
            cache_path: str = "") -> Dict:
    w = mesh.world_size
    pad = -(-N_CLIENTS // w) * w
    out: Dict = {"world": w, "rank": mesh.rank,
                 "merges": merges(mesh, 8 if w <= 8 else w)}
    if w == 4:
        out["merges12"] = merges(mesh, 12)
    init = None
    if init_path:
        init = torch.load(init_path, weights_only=False)
    backends = {"einsum": {}, "shard_map": {},
                "quantized": {"quant_hosts": 2, "quant_block_size": BLOCK},
                "auto": {"quant_hosts": 2}}
    out["rounds"] = {name: run_engine(
        mesh, config(aggregation_backend=name, **kw), pad_to=pad)
        for name, kw in backends.items()}
    # a second 'auto' engine in the process (another update type, as the
    # driver's sweep builds): the plan's signature hits in rank 0's cache
    out["auto_again"] = run_engine(
        mesh, config(aggregation_backend="auto", **backends["auto"]),
        pad_to=pad, update_type="avg", rounds=1)
    out["jax_init"] = run_engine(mesh, config(), pad_to=pad, init=init)
    if w == 4:
        out["fifty"] = run_engine(mesh, config(network_size=50, epochs=1,
                                               num_participants=0.2),
                                  n_real=50, pad_to=52, rounds=1)
        return out
    from fedmse_tpu_torch.chaos import ChaosSpec
    from fedmse_tpu_torch.federation.elastic import ElasticSpec
    out["hooks"] = run_engine(
        mesh, config(num_rounds=4), pad_to=pad, rounds=4,
        chaos=ChaosSpec(dropout_p=0.2, straggler_p=0.1, crash_p=0.5,
                        broadcast_loss_p=0.2),
        elastic=ElasticSpec(leave_p=0.2, join_p=0.5, preempt_p=0.1))
    from fedmse_tpu_torch.cluster import ClusterSpec
    out["clustered"] = run_engine(
        mesh, config(num_rounds=4, aggregation_backend="quantized",
                     quant_hosts=2, quant_block_size=BLOCK), pad_to=pad,
        rounds=4, cluster=ClusterSpec(k=2, personalize=True, refit_every=2))
    out["early_stop"] = early_stop_run(mesh)
    out["adam"] = sharded_adam(mesh)
    out["tier_plain"] = run_tier(mesh, ratio=0.5)
    out["tier_pod"] = run_tier(mesh, host_sharded=True,
                               resume_dir=ckpt_dir or None)
    out["tier_refit"] = run_tier(mesh, host_sharded=True, cluster_refit=2,
                                 rounds=4)
    # the same ranks named as two hosts: host-sharded whatever the flag
    # says; named as one host: the plain tier
    out["tier_two_hosts"] = run_tier(mesh, hosts=["h0", "h1"])
    out["tier_two_hosts_half"] = run_tier(mesh, ratio=0.5,
                                          hosts=["h0", "h1"])
    out["tier_one_host"] = run_tier(mesh, ratio=0.5, hosts=["h0", "h0"])
    out["tier_local"] = run_tier(mesh, host_sharded=True, local_data=True)
    out["serving"] = serving(mesh)
    out["plan"] = plan(mesh, cache_path)
    return out

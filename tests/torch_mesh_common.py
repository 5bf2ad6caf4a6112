"""Shared set-up of the port's client-mesh tests: one gloo launch per world
size per test session, and the JAX package's side of the comparisons.

`rank_session(tmp_path_factory, W)` spawns W CPU ranks of
tests/torch_mesh_jobs.py `session` once (each rank runs every check of the
session and returns its results; parallel/launch.spawn: a FileStore under
the session's temp dir, bounded waits, one retry of a spawn-level failure)
and caches the ranks' results on disk, under a lock, for every xdist
worker of the run. Before the spawn it runs the JAX package's fused engine
sharded over `client_mesh(W)` on the same federation and hands its init to
the ranks, so the port's sharded run starts from the JAX init; the JAX
run's results are cached beside the ranks'.
"""

from __future__ import annotations

import fcntl
import os
import pickle

import numpy as np
import torch

import torch_mesh_jobs as jobs

TESTS = os.path.dirname(os.path.abspath(__file__))


def shared_dir(tmp_path_factory):
    """A directory every xdist worker of this run shares."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    return base


def jax_sharded_run(world: int, init_path: str = "", fused: bool = True):
    """The JAX engine over client_mesh(world), fused or per-phase (hybrid /
    mse_avg, the tie-break off): its init written for the ranks when
    `init_path` is given, then 3 rounds (round 1 alone); (results, round-1
    params [N, P])."""
    import jax
    from fedmse_tpu.config import CompatConfig as JaxCompat
    from fedmse_tpu.config import ExperimentConfig as JaxConfig
    from fedmse_tpu.data import stack_clients as jax_stack
    from fedmse_tpu.data.synthetic import synthetic_clients as jax_synthetic
    from fedmse_tpu.federation import RoundEngine as JaxEngine
    from fedmse_tpu.models import make_model as jax_make_model
    from fedmse_tpu.parallel import client_mesh, shard_federation
    from fedmse_tpu.utils.seeding import ExperimentRngs as JaxRngs
    from fedmse_tpu_torch.federation import client_states_from_numpy

    n = jobs.N_CLIENTS
    pad = -(-n // world) * world
    kw, _, dev_x = jobs.federation_clients(n)
    cfg = JaxConfig(dim_features=jobs.DIMS[0], hidden_neus=jobs.DIMS[1],
                    latent_dim=jobs.DIMS[2], network_size=n, epochs=3,
                    num_rounds=3, compat=JaxCompat(vote_tie_break=False))
    data = jax_stack(jax_synthetic(**kw), dev_x, 12, pad_clients_to=pad)
    mesh = client_mesh(world)
    eng = JaxEngine(jax_make_model("hybrid", *jobs.DIMS, cfg.shrink_lambda),
                    cfg, data, n_real=n, rngs=JaxRngs(run=0),
                    model_type="hybrid", update_type="mse_avg", fused=fused,
                    mesh=mesh)
    eng.data, eng.states = shard_federation(data, eng.states, mesh)
    eng._ver_x, eng._ver_m = eng._verification_tensors()
    if init_path:
        torch.save(client_states_from_numpy(
            jax.tree.map(np.array, eng.states), jobs.LAYOUT, device="cpu"),
            init_path)
    res = [eng.run_round(0)]
    p1 = flat(eng.states.params)
    res += [eng.run_round(r) for r in (1, 2)]
    keep = ("selected", "aggregator", "client_metrics", "agg_weights",
            "backend")
    return [{k: getattr(r, k, None) for k in keep} for r in res], p1


def flat(tree) -> np.ndarray:
    import jax
    return jobs.LAYOUT.flatten(jax.tree.map(
        lambda t: torch.from_numpy(np.array(t, np.float32)), tree)).numpy()


def write_dataset(root: str, n: int = 5) -> str:
    """A CSV federation of n clients (6 features) under `root` for the
    driver; the path of its dataset config."""
    import json
    from fedmse_tpu_torch.config import DatasetConfig
    from tests.test_data import _write_client_csvs
    _write_client_csvs(root, n, dim=6, n_normal=60, n_abnormal=24)
    path = os.path.join(root, "config.json")
    with open(path, "w") as f:
        json.dump(DatasetConfig.for_client_dirs(root, n).to_json(), f)
    return path


def rank_session(tmp_path_factory, world: int):
    """(per-rank results, the JAX runs) of the world-`world` session: the
    JAX runs are {"fused": ..., "phase": ...}, each (results, round-1
    params). The world-2 session also runs the driver on a CSV
    federation (`write_dataset`)."""
    from fedmse_tpu_torch.parallel.launch import spawn
    base = shared_dir(tmp_path_factory)
    root = base / f"torch_mesh_w{world}"
    done = root / "result.pkl"
    with open(base / f"torch_mesh_w{world}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not done.exists():
                root.mkdir(exist_ok=True)
                init = str(root / "jax_init.pt")
                jax_run = {"fused": jax_sharded_run(world, init),
                           "phase": jax_sharded_run(world, fused=False)}
                dataset = (write_dataset(str(root / "driver" / "shards"))
                           if world == 2 else "")
                outs = spawn(world, "torch_mesh_jobs:session",
                             {"init_path": init,
                              "ckpt_dir": str(root / "ckpt"),
                              "cache_path": str(root / "tune.json"),
                              "dataset": dataset},
                             device="cpu", workdir=str(root / "ranks"),
                             timeout_s=600,
                             pythonpath=[TESTS],
                             env={k: v for k, v in os.environ.items()
                                  if k not in ("XLA_FLAGS",)})
                with open(str(done) + ".tmp", "wb") as f:
                    pickle.dump((outs, jax_run), f)
                os.replace(str(done) + ".tmp", done)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    with open(done, "rb") as f:
        outs, jax_run = pickle.load(f)
    outs = list(outs)
    for o in outs:
        o["root"] = str(root)
    return outs, jax_run


def assert_tree_equal(a, b, path="") -> None:
    """Two nested results equal bit for bit (NaN where NaN)."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), path
    else:
        assert a == b, path


def close(a, b, tol: float) -> None:
    """|a - b| <= tol, scale-normalized by max(1, max|b|)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(1.0, float(np.nanmax(np.abs(b))) if b.size else 1.0)
    err = float(np.nanmax(np.abs(a - b))) if a.size else 0.0
    assert err <= tol * scale, (err, tol * scale)

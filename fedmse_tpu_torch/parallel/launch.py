"""The rank entry: spawn W processes that join one process group and each
run a job on its rank of the client mesh.

    python -m fedmse_tpu_torch.parallel.launch --job MODULE:FUNCTION
        --world W --rank R --store FILE --out DIR [--backend gloo|nccl]
        [--device cuda|cpu] [--args FILE.json]

runs on the card (NCCL, cuda:R) unless `--device cpu` (gloo) is given;
without a card the cuda default raises in the rank.

joins a group through a `torch.distributed.FileStore` (no port is bound),
builds the mesh (`mesh.client_mesh`), calls FUNCTION(mesh, **args) and
pickles {"ok": True, "result": ...} or {"ok": False, "error": traceback}
to DIR/rank{R}.pkl. `spawn` starts the W processes with
`subprocess.Popen` (never a fork: a parent that touched CUDA must not
fork), waits with a bound, kills what is left in `finally`, and returns
the ranks' results. A spawn-level failure (a rank that exits without its
result, or the bound) is retried once with a fresh store; a job's own
failure is raised at once, never retried. On the card, build the kernels
in the parent before spawning: the ranks then load the built libraries.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import traceback
from typing import Any, Dict, List, Optional, Sequence


class RankJobError(RuntimeError):
    """A rank's job raised: its traceback, not a spawn failure."""


def spawn(world_size: int, job: str, args: Optional[Dict[str, Any]] = None,
          *, backend: Optional[str] = None, device: str = "cuda",
          workdir: Optional[str] = None, timeout_s: float = 300.0,
          env: Optional[Dict[str, str]] = None, retries: int = 1,
          pythonpath: Sequence[str] = ()) -> List[Any]:
    """Run `job` (MODULE:FUNCTION) on `world_size` ranks; its results in
    rank order."""
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="fedmse_ranks_")
    try:
        for attempt in range(retries + 1):
            try:
                return _spawn_once(world_size, job, args or {}, backend,
                                   device, os.path.join(workdir,
                                                        f"try{attempt}"),
                                   timeout_s, env, pythonpath)
            except RankJobError:
                raise
            except RuntimeError:
                if attempt == retries:
                    raise
    finally:
        if own:
            shutil.rmtree(workdir, ignore_errors=True)
    raise AssertionError("unreachable")


def _spawn_once(world, job, args, backend, device, root, timeout_s, env,
                pythonpath) -> List[Any]:
    os.makedirs(root, exist_ok=True)
    args_path = os.path.join(root, "args.json")
    with open(args_path, "w") as f:
        json.dump(args, f)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    child_env = dict(os.environ if env is None else env)
    child_env["PYTHONPATH"] = os.pathsep.join(
        [repo, *pythonpath, child_env.get("PYTHONPATH", "")]).rstrip(
            os.pathsep)
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                "LOCAL_RANK"):
        child_env.pop(var, None)
    procs = []
    logs = []
    try:
        for rank in range(world):
            log = open(os.path.join(root, f"rank{rank}.log"), "w")
            logs.append(log)
            rank_env = {**child_env, "LOCAL_RANK": str(rank)}
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "fedmse_tpu_torch.parallel.launch",
                 "--job", job, "--world", str(world), "--rank", str(rank),
                 "--store", os.path.join(root, "store"), "--out", root,
                 "--device", device, "--args", args_path,
                 *(["--backend", backend] if backend else [])],
                stdout=log, stderr=subprocess.STDOUT, env=rank_env))
        for p in procs:
            try:
                p.communicate(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        for log in logs:
            log.close()
    results = []
    for rank in range(world):
        path = os.path.join(root, f"rank{rank}.pkl")
        if not os.path.exists(path):
            tail = open(os.path.join(root, f"rank{rank}.log")).read()[-3000:]
            raise RuntimeError(f"rank {rank} of {world} left no result "
                               f"(exit {procs[rank].returncode}):\n{tail}")
        with open(path, "rb") as f:
            out = pickle.load(f)
        if not out["ok"]:
            raise RankJobError(f"rank {rank} of {world}:\n{out['error']}")
        results.append(out["result"])
    return results


def run_rank(job: str, world: int, rank: int, store_path: str, out_dir: str,
             backend: Optional[str], device: str, args: Dict[str, Any]
             ) -> None:
    import torch
    import torch.distributed as dist

    from fedmse_tpu_torch.parallel.mesh import client_mesh
    from fedmse_tpu_torch.parallel.multihost import initialize, shutdown

    torch.set_num_threads(1)
    out_path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        initialize(store=dist.FileStore(store_path, world), world_size=world,
                   rank=rank, backend=backend, device=device, timeout_s=60.0)
        mesh = client_mesh(device=device if device == "cpu" else None)
        module, fn = job.split(":")
        result = getattr(importlib.import_module(module), fn)(mesh, **args)
        payload = {"ok": True, "result": result}
    except Exception:
        payload = {"ok": False, "error": traceback.format_exc()}
    finally:
        try:
            shutdown()
        except Exception:
            pass
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, out_path)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--job", required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--store", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--backend", default=None,
                   help="default: nccl for cuda, gloo for cpu")
    p.add_argument("--device", default="cuda")
    p.add_argument("--args", default=None)
    a = p.parse_args(argv)
    args = {}
    if a.args:
        with open(a.args) as f:
            args = json.load(f)
    run_rank(a.job, a.world, a.rank, a.store, a.out, a.backend, a.device,
             args)


if __name__ == "__main__":
    main()

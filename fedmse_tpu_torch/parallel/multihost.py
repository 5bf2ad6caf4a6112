"""Joining a launch of many ranks, and the host-side control plane across
them (port of fedmse_tpu/parallel/multihost.py).

`initialize()` makes the default `torch.distributed` process group from the
launcher's environment (torchrun's RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT) or from explicit arguments (a `store`, say a
FileStore, with `world_size` and `rank`). It picks NCCL for CUDA ranks and
gloo on the CPU; a caller may name gloo for CUDA ranks that share one card,
which NCCL refuses. The driver calls it before any other CUDA use. A
configured launch that fails to join raises: a broken launch must not
train W disjoint federations. With no configuration at all the process
stays at world 1 and makes no group.

Launch on a host with W cards:

    torchrun --nproc-per-node W -m fedmse_tpu_torch.main --use-mesh ...

The control plane's helpers keep the JAX package's contracts:
`allgather_tree_sum` sums per-rank partials in rank order (every rank the
same bits), `allgather_blocks` reassembles per-rank row blocks, and
`uniform_decision` broadcasts rank 0's decision. Each reports its bytes to
the seam counters (parallel/costmodel.py).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Any, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

LAUNCH_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def local_rank() -> int:
    """This process's index on its host (torchrun's LOCAL_RANK; 0)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def launcher_configured() -> bool:
    """Whether the environment carries a launch of many ranks."""
    return bool(os.environ.get("WORLD_SIZE")) and bool(
        os.environ.get("RANK"))


def initialize(*, store: Any = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None,
               device: Any = "cuda", init_method: Optional[str] = None,
               timeout_s: float = 600.0) -> bool:
    """Join the launch. Returns True when a process group is up (made here
    or before), False when the process runs alone. `device` says where the
    ranks compute ("cuda": NCCL, and each rank's card is set to
    cuda:LOCAL_RANK; "cpu": gloo) unless `backend` names one."""
    import torch.distributed as dist
    if dist.is_initialized():
        return True
    explicit = (store is not None or init_method is not None
                or world_size is not None or rank is not None)
    if not explicit and not launcher_configured():
        return False
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA launch needs a card; pass "
                               "device='cpu' for gloo on the CPU")
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
    kw = {"backend": backend,
          "timeout": datetime.timedelta(seconds=timeout_s)}
    if store is not None:
        kw.update(store=store, world_size=int(world_size), rank=int(rank))
    else:
        kw["init_method"] = init_method or "env://"
        if world_size is not None:
            kw.update(world_size=int(world_size), rank=int(rank))
    dist.init_process_group(**kw)  # raises on a configured launch's failure
    logger.info("multihost: rank %d/%d on %s", dist.get_rank(),
                dist.get_world_size(), backend)
    return True


def shutdown() -> None:
    """Leave the process group, if any."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _mesh(mesh):
    from fedmse_tpu_torch.parallel.mesh import default_mesh
    return mesh if mesh is not None else default_mesh()


def allgather_tree_sum(tree: Any, mesh=None) -> Any:
    """A small host-numpy tree summed across ranks, in rank order: the same
    fleet total on every rank. Identity at world 1."""
    from fedmse_tpu_torch.parallel.costmodel import seam
    from fedmse_tpu_torch.parallel.mesh import _tree_map
    mesh = _mesh(mesh)
    leaves = []
    _tree_map(lambda leaf: leaves.append(np.asarray(leaf)), tree)
    payload = int(sum(leaf.nbytes for leaf in leaves))
    seam.add_host_collective("allgather_tree_sum", payload,
                             (mesh.world_size - 1) * payload)
    if not mesh.sharded:
        return tree

    def total(leaf):
        stack = mesh.gather_host(np.asarray(leaf))
        out = stack[0].copy()
        for j in range(1, stack.shape[0]):
            out = out + stack[j]
        return out
    return _tree_map(total, tree)


def allgather_blocks(local, blocks, process_order, mesh=None) -> np.ndarray:
    """Per-rank leading-axis blocks reassembled into the fleet-width array
    on every rank. `blocks[j]` is the [start, stop) of rank
    `process_order[j]`; ragged blocks ride one gather padded to the widest,
    the pad dropped. Identity at world 1."""
    from fedmse_tpu_torch.parallel.costmodel import seam
    mesh = _mesh(mesh)
    local = np.asarray(local)
    widest = max(hi - lo for lo, hi in blocks)
    row = int(np.prod(local.shape[1:], dtype=np.int64))
    seam.add_host_collective("allgather_blocks", int(local.nbytes),
                             (mesh.world_size - 1) * widest * row
                             * local.dtype.itemsize)
    if not mesh.sharded:
        return local
    padded = np.zeros((widest,) + local.shape[1:], local.dtype)
    padded[: local.shape[0]] = local
    stacked = mesh.gather_host(padded)
    return np.concatenate([stacked[p][: hi - lo]
                           for p, (lo, hi) in zip(process_order, blocks)],
                          axis=0)


def uniform_decision(flag: bool, mesh=None) -> bool:
    """Rank 0's decision on every rank (a rank that decides otherwise would
    deadlock at the next collective). Identity at world 1."""
    mesh = _mesh(mesh)
    if not mesh.sharded:
        return flag
    return bool(mesh.broadcast_host(np.asarray([flag], np.uint8))[0])

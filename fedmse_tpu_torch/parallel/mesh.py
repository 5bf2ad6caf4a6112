"""The client mesh: the federation's client axis spread over ranks (port of
fedmse_tpu/parallel/mesh.py).

The JAX package maps the client axis onto a 1-D `jax.sharding.Mesh`: one
controller, N local devices, and XLA writes the collectives. PyTorch's
idiom for many devices is one process per device, so here a mesh is a
`torch.distributed` process group of W ranks (`ClientMesh`), each with its
device and the contiguous block of client rows it owns:

  * the padded client axis N is a multiple of W, and rank j owns rows
    [j N/W, (j + 1) N/W) (`process_client_rows`): its clients' states, data
    and training live on its device only;
  * what crosses ranks is an explicit all-gather (`ClientMesh.all_gather`):
    the vote's scores, the merge's partials, the chaos mean, the chunk's
    outputs. Sums over the gathered [W, ...] stack run in rank order on
    every rank, so every rank holds the same bits (parallel/collectives.py);
  * on NCCL (CUDA ranks, one card each) the gather moves device tensors;
    on gloo a CUDA payload goes through pinned host tensors, by design of
    the backend (gloo moves host memory), and a CPU payload directly.

The placement helpers slice this rank's block: `shard_clients`,
`shard_federation`, `replicate`, `place_cohort`, `local_shard_rows`.
`host_fetch` gathers per-rank blocks into the full value on every rank
(`host_fetch_async` overlaps the copy only at world 1; at world > 1 it is
the synchronous gather, as the JAX package's multi-process seam is).

The pure arithmetic (`pad_to_multiple`, `process_client_rows`,
`mesh_process_indices`, `process_tier_blocks`, `my_tier_block`) takes
(world size, rank) where the JAX package takes a Mesh, and returns its
numbers.
"""

from __future__ import annotations

import dataclasses
import socket
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fedmse_tpu_torch.device import resolve_device
from fedmse_tpu_torch.ops import graphs


def pad_to_multiple(n: int, multiple: int) -> int:
    """The client count rounded up to a multiple of the rank count."""
    return -(-n // multiple) * multiple


def process_client_rows(n_pad: int, world_size: int, rank: int
                        ) -> Tuple[int, int]:
    """[start, stop) of the padded client axis that `rank` owns."""
    if n_pad % world_size != 0:
        raise ValueError(f"padded client count {n_pad} must be a multiple "
                         f"of the mesh size {world_size}")
    per = n_pad // world_size
    return rank * per, (rank + 1) * per


def mesh_process_indices(world_size: int) -> List[int]:
    """The ranks in mesh order: the canonical host order of tier blocks,
    cohort lane blocks and control-plane gathers."""
    return list(range(world_size))


def process_tier_blocks(n_real: int, world_size: int) -> List[Tuple[int, int]]:
    """Contiguous [start, stop) blocks of the REAL client axis, one per rank
    in mesh order (which clients each rank tiers): near-equal sizes, the
    first `n_real % W` ranks one row more."""
    if n_real < world_size:
        raise ValueError(f"{n_real} clients cannot shard over "
                         f"{world_size} hosts")
    base, rem = divmod(n_real, world_size)
    blocks, lo = [], 0
    for j in range(world_size):
        hi = lo + base + (1 if j < rem else 0)
        blocks.append((lo, hi))
        lo = hi
    return blocks


def my_tier_block(n_real: int, world_size: int, rank: int) -> Tuple[int, int]:
    """`rank`'s [start, stop) tier block (process_tier_blocks)."""
    return process_tier_blocks(n_real, world_size)[rank]


@dataclasses.dataclass(eq=False)
class Group:
    """Ranks that gather together: the mesh's default group or a subgroup
    (the quantized merge's host groups and lanes). `pg` is None for a
    subgroup of one rank, and for a mesh made with no process group; a
    world-1 group's gathers go through its backend all the same."""

    ranks: Tuple[int, ...]
    pg: Any = None

    @property
    def size(self) -> int:
        return len(self.ranks)


class ClientMesh:
    """A 1-D client mesh over `world_size` ranks: this process is `rank`,
    computing on `device`, and talking over `backend` ('nccl', 'gloo', or
    'none' at world 1 without a process group). `hosts[j]` names rank j's
    host: the real topology of `collectives.host_groups(num_groups=0)`."""

    def __init__(self, world_size: int = 1, rank: int = 0,
                 device: torch.device = torch.device("cpu"),
                 backend: str = "none", pg: Any = None,
                 hosts: Optional[Sequence[str]] = None,
                 axis_name: str = "clients"):
        if (world_size > 1 or pg is not None) \
                and backend not in ("nccl", "gloo"):
            raise ValueError(f"a mesh of {world_size} ranks needs a process "
                             f"group (nccl or gloo), got {backend!r}")
        self.world_size, self.rank = int(world_size), int(rank)
        self.device = torch.device(device)
        self.backend = backend
        self.axis_name = axis_name
        self.hosts = list(hosts) if hosts is not None \
            else [socket.gethostname()] * self.world_size
        self.group = Group(tuple(range(self.world_size)), pg)
        self._subgroups: Dict[Tuple[int, ...], Group] = {}

    def __repr__(self) -> str:
        return (f"ClientMesh(world_size={self.world_size}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend!r})")

    @property
    def sharded(self) -> bool:
        """Whether the client axis is split: more than one rank."""
        return self.world_size > 1

    def block(self, n_pad: int) -> Tuple[int, int]:
        """This rank's rows of a padded client axis of n_pad."""
        return process_client_rows(n_pad, self.world_size, self.rank)

    def subgroups(self, partition: Sequence[Sequence[int]]) -> List[Group]:
        """A Group per part of a partition of the ranks, made collectively
        (every rank creates every group, in the same order) and cached."""
        import torch.distributed as dist
        out = []
        for part in partition:
            key = tuple(int(r) for r in part)
            if key not in self._subgroups:
                if len(key) == self.world_size:
                    self._subgroups[key] = self.group
                else:
                    pg = dist.new_group(list(key), backend=self.backend) \
                        if self.world_size > 1 else None
                    self._subgroups[key] = Group(
                        key, pg if len(key) > 1 else None)
            out.append(self._subgroups[key])
        return out

    # ---- the one collective of the port's mesh ---- #

    def all_gather(self, x: torch.Tensor, group: Optional[Group] = None
                   ) -> torch.Tensor:
        """[G, *x.shape]: every member's `x`, in the group's rank order.
        Inside a split CapturedBody it cuts the capture (ops/graphs.py)."""
        g = self.group if group is None else group
        staged: Dict[str, torch.Tensor] = {}

        def alloc(src: torch.Tensor) -> torch.Tensor:
            return torch.empty((g.size,) + tuple(src.shape), dtype=src.dtype,
                               device=src.device)

        def run(src: torch.Tensor, dst: torch.Tensor) -> None:
            self._gather_into(dst, src, g, staged)

        return graphs.collective(x.contiguous(), alloc, run)

    def _gather_into(self, dst: torch.Tensor, src: torch.Tensor, g: Group,
                     staged: Dict[str, torch.Tensor]) -> None:
        import torch.distributed as dist
        if g.pg is None:  # one rank and no process group: a copy
            dst[0].copy_(src)
            return
        if self.backend == "nccl":
            dist.all_gather_into_tensor(dst, src, group=g.pg)
            return
        if not src.is_cuda:  # gloo on host tensors
            dist.all_gather(list(dst.unbind(0)), src, group=g.pg)
            return
        # gloo moves host memory: a CUDA payload is staged through pinned
        # host tensors made at the first call
        if "src" not in staged:
            staged["src"] = torch.empty(src.shape, dtype=src.dtype,
                                        pin_memory=True)
            staged["dst"] = torch.empty(dst.shape, dtype=dst.dtype,
                                        pin_memory=True)
        staged["src"].copy_(src)
        dist.all_gather(list(staged["dst"].unbind(0)), staged["src"],
                        group=g.pg)
        dst.copy_(staged["dst"])

    def comm_device(self) -> torch.device:
        """Where a host value is put to be gathered: the card for NCCL,
        the CPU otherwise."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def gather_host(self, a: np.ndarray, group: Optional[Group] = None
                    ) -> np.ndarray:
        """A host array's all-gather, [G, *a.shape] numpy, outside any
        body."""
        a = np.ascontiguousarray(a)
        if self.world_size == 1 and group is None:
            return a[None]
        t = torch.from_numpy(a.view(np.uint8) if a.dtype == bool else a)
        out = self.all_gather(t.to(self.comm_device()), group).cpu().numpy()
        return out.view(bool) if a.dtype == bool else out

    def broadcast_host(self, a: np.ndarray, src: int = 0) -> np.ndarray:
        """Rank `src`'s host array on every rank."""
        return self.gather_host(a)[src]

    def barrier(self) -> None:
        if self.world_size > 1:
            import torch.distributed as dist
            dist.barrier()


_DEFAULT: Optional[ClientMesh] = None


def client_mesh(device: Any = None, axis_name: str = "clients"
                ) -> ClientMesh:
    """The mesh of the default process group (parallel/multihost.py
    `initialize`): every rank of the launch, or a mesh of one rank when no
    group was made. `device` defaults to the rank's card
    (cuda:LOCAL_RANK modulo the visible cards), and then raises without
    one; a CPU mesh is asked for with device='cpu'."""
    global _DEFAULT
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        backend = dist.get_backend()
    else:
        world, rank, backend = 1, 0, "none"
    if device is None:
        from fedmse_tpu_torch.parallel.multihost import local_rank
        resolve_device("cuda")
        device = torch.device("cuda", local_rank()
                              % torch.cuda.device_count())
    device = resolve_device(device)
    hosts = [socket.gethostname()]
    if world > 1:
        hosts = [None] * world
        dist.all_gather_object(hosts, socket.gethostname())
    mesh = ClientMesh(world, rank, device, backend,
                      pg=dist.group.WORLD if backend != "none" else None,
                      hosts=hosts, axis_name=axis_name)
    _DEFAULT = mesh
    return mesh


def default_mesh() -> ClientMesh:
    """The last mesh `client_mesh` made (a one-rank CPU mesh if none)."""
    return _DEFAULT if _DEFAULT is not None else ClientMesh()


# ---- placement ---- #

def _tree_map(fn: Callable, tree: Any) -> Any:
    """fn over the tensors and arrays of a tree of dicts, lists, tuples
    (NamedTuples too), dataclasses with `apply` (ClientStates) and None."""
    if tree is None:
        return None
    if hasattr(tree, "apply") and dataclasses.is_dataclass(tree):
        return tree.apply(fn)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_clients(tree: Any, mesh: ClientMesh) -> Any:
    """This rank's leading-axis block of every leaf of a full stacked tree,
    on its device (new tensors)."""
    def place(leaf):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(
            np.asarray(leaf))
        lo, hi = mesh.block(t.shape[0])
        return t[lo:hi].to(mesh.device, copy=True)
    return _tree_map(place, tree)


def replicate(tree: Any, mesh: ClientMesh) -> Any:
    """Every leaf whole on this rank's device."""
    return _tree_map(lambda t: torch.as_tensor(t).to(mesh.device, copy=True),
                     tree)


def place_cohort(mesh: Optional[ClientMesh], cohort: int
                 ) -> Callable[[Any], torch.Tensor]:
    """Leaf placement of a [C, ...] cohort slab: this rank's lane block when
    the cohort divides over the mesh, else the whole slab (a copy
    either way)."""
    if mesh is None or not mesh.sharded or cohort % mesh.world_size:
        dev = mesh.device if mesh is not None else None
        return lambda leaf: torch.as_tensor(leaf).to(dev, copy=True) \
            if dev is not None else torch.as_tensor(leaf).clone()
    lo, hi = mesh.block(cohort)
    return lambda leaf: torch.as_tensor(leaf)[lo:hi].to(mesh.device,
                                                        copy=True)


def local_shard_rows(tree: Any) -> Any:
    """This rank's own rows as host numpy: each rank holds only its block,
    so no collective and no other rank's bytes."""
    return _tree_map(lambda t: t.detach().cpu().numpy()
                     if isinstance(t, torch.Tensor) else np.asarray(t), tree)


def host_fetch(tree: Any, mesh: Optional[ClientMesh] = None) -> Any:
    """Every leaf (this rank's leading-axis block of a sharded value) as the
    full value in host numpy, the same on every rank: the blocks gathered
    and concatenated in rank order. At world 1 a plain copy to the host."""
    mesh = mesh or default_mesh()
    if not mesh.sharded:
        return local_shard_rows(tree)
    from fedmse_tpu_torch.parallel.costmodel import seam

    def fetch(leaf):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(
            np.asarray(leaf))
        if t.numel() == 0:  # a leaf of width 0 on every rank: no bytes
            a = t.detach().cpu().numpy()
            return np.empty((mesh.world_size * t.shape[0],) + a.shape[1:],
                            dtype=a.dtype)
        local = t.numel() * t.element_size()
        seam.add_host_collective("host_fetch_allgather", local,
                                 (mesh.world_size - 1) * local)
        g = mesh.gather_host(t.detach().cpu().numpy())
        return g.reshape((-1,) + tuple(t.shape[1:]))
    return _tree_map(fetch, tree)


def host_fetch_async(tree: Any, mesh: Optional[ClientMesh] = None
                     ) -> Callable[[], Any]:
    """Start the device-to-host copies of `tree` now; the returned call
    waits and gives what `host_fetch(tree)` gives. Overlap only at world
    1: at world > 1 the gather is a collective every rank enters together,
    so the call defers to `host_fetch`."""
    mesh = mesh or default_mesh()
    if mesh.sharded:
        return lambda: host_fetch(tree, mesh)
    events = []

    def start(t):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            events.append(ev)
            return host
        return t
    staged = _tree_map(start, tree)

    def harvest():
        for ev in events:
            ev.synchronize()
        return local_shard_rows(staged)
    return harvest


def shard_federation(data, states, mesh: ClientMesh):
    """(data, states) of this rank: every per-client field's block on its
    device, the dev set replicated. The padded client axis must divide
    over the mesh (main.py pads it: `pad_federated_data`)."""
    from fedmse_tpu_torch.data.stacking import FederatedData
    n = data.client_mask.shape[0]
    if n % mesh.world_size:
        raise ValueError(
            f"padded client count {n} must be a multiple of the mesh size "
            f"{mesh.world_size}; pad with pad_federated_data(data, "
            f"pad_to_multiple(n, mesh.world_size))")
    lo, hi = mesh.block(n)
    sharded = FederatedData(**{
        f.name: (getattr(data, f.name).to(mesh.device, copy=True)
                 if f.name == "dev_x"
                 else getattr(data, f.name)[lo:hi].to(mesh.device, copy=True))
        for f in dataclasses.fields(FederatedData)})
    return sharded, (None if states is None
                     else shard_clients(states, mesh))

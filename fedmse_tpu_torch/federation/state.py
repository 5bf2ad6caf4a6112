"""Federation state: all N clients stacked on a leading axis (port of
fedmse_tpu/federation/state.py).

`ClientStates` holds every per-client quantity as an [N, ...] tensor on the
device. Parameters are ONE flat [N, P] f32 buffer (models/flat.py), and so
are the Adam moments, the previous global model and the verifier's
history: each update of the round is a few ops on one tensor.

  params       the client's model
  opt_state    its Adam state (created once, kept across rounds)
  prev_global  the last verified broadcast (FedProx's anchor)
  hist_params / hist_perf / hist_seen
               the verifier's history: the last RECEIVED broadcast and its
               measured performance
  rejected     consecutive rejected broadcasts
  waived       cumulative Frobenius movement accepted through the hardened
               verifier's recovery waiver
  stats        the model's running statistics beside its params, [N, Q]:
               KitNET's min-max normalisation (lo, hi) of its members'
               RMSEs, Q = 2k (models/kitnet.py); Q = 0 for the
               autoencoders, whose gathers, scatters and merges of it
               are then empty. Training updates it, a merge takes the min
               and max over the merged clients, an accepted broadcast
               brings the merge's, a rejected one keeps the client's own

`HostState` keeps the election's counters on the host.
`TieredClientStore` keeps the same ClientStates as CPU tensors: the whole
fleet on the host, of which the tiered engine (federation/tiered.py) moves
only each round's cohort to the device (`gather` / `scatter`, keyed by
absolute client id; `gather_rows` gives negative ids zero rows).
`TieredShardStore` is one rank's block of that tier (a host-sharded tier
over a client mesh, parallel/).
`init_client_states` draws the real clients from the run's generator and
the pad clients of a padded axis from a keyed stream of their own, so
padding leaves the real clients' init as it is;
`init_batched_client_states` stacks R runs' inits run by run, [R·N, ...]
(the batched round, federation/batched.py).
`client_states_from_numpy` takes the JAX package's ClientStates (as numpy),
so both packages can start from one init: jax.random's draws cannot be
reproduced in torch; `client_states_to_numpy` is its inverse, in the JAX
package's structure (the checkpoint's leaves, checkpointing/io.py).
The per-client selects and the divergence observable of the fault hooks
(federation/fused.py) close the module.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from fedmse_tpu_torch.device import DeviceLike, resolve_device
from fedmse_tpu_torch.federation.aggregation import weighted_mean
from fedmse_tpu_torch.federation.optim import (AdamState, adam_init,
                                               adam_step,
                                               opt_state_from_numpy,
                                               opt_state_to_numpy)
from fedmse_tpu_torch.models.autoencoder import (init_kernels,
                                                 init_pad_params,
                                                 init_stacked_params)
from fedmse_tpu_torch.models.flat import ParamLayout


@dataclasses.dataclass
class ClientStates:
    params: torch.Tensor       # [N, P] f32
    opt_state: AdamState
    prev_global: torch.Tensor  # [N, P]
    hist_params: torch.Tensor  # [N, P]
    hist_perf: torch.Tensor    # [N] f32
    hist_seen: torch.Tensor    # [N] bool
    rejected: torch.Tensor     # [N] int32
    waived: torch.Tensor       # [N] f32
    stats: Optional[torch.Tensor] = None  # [N, Q] f32; None: Q = 0

    def __post_init__(self):
        if self.stats is None:
            self.stats = self.params.new_zeros((self.params.shape[0], 0))

    def replace(self, **kw: Any) -> "ClientStates":
        return dataclasses.replace(self, **kw)

    def apply(self, fn) -> "ClientStates":
        """fn applied to every tensor (the Adam state's too)."""
        def each(v):
            return AdamState(*map(fn, v)) if isinstance(v, AdamState) \
                else fn(v)
        return ClientStates(**{f.name: each(getattr(self, f.name))
                               for f in dataclasses.fields(self)})

    def clone(self) -> "ClientStates":
        """A device snapshot: every tensor copied (the rewind's snapshot)."""
        return self.apply(torch.clone)

    def copy_(self, other: "ClientStates") -> None:
        """Restore `other`'s values into these tensors, in place: the
        buffers a captured round reads keep their addresses."""
        for f in dataclasses.fields(self):
            getattr(self, f.name).copy_(getattr(other, f.name))

    def where_(self, keep: torch.Tensor, new: "ClientStates") -> None:
        """Take `new`'s values where the device predicate `keep` holds, in
        place: a branch without a host read. `keep` is a 0-d bool, or [N]
        per client (the batched round's per-run selects)."""
        for f in dataclasses.fields(self):
            mine, theirs = getattr(self, f.name), getattr(new, f.name)
            pairs = zip(mine, theirs) if isinstance(mine, AdamState) \
                else [(mine, theirs)]
            for a, b in pairs:
                k = keep if keep.dim() == 0 else keep.view(
                    (-1,) + (1,) * (a.dim() - 1))
                torch.where(k, b, a, out=a)

    def select(self, keep: torch.Tensor, other: "ClientStates"
               ) -> "ClientStates":
        """Per client: this state's rows where keep [N] is true, `other`'s
        elsewhere (new tensors)."""
        def each(a, b):
            if isinstance(a, AdamState):
                return AdamState(*map(each, a, b))
            return tree_select_clients(keep, a, b)
        return ClientStates(**{f.name: each(getattr(self, f.name),
                                            getattr(other, f.name))
                               for f in dataclasses.fields(self)})

    def to(self, device: DeviceLike) -> "ClientStates":
        dev = resolve_device(device)
        return self.apply(lambda t: t.to(dev))

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor with data in a row, in field order, the Adam
        state's flattened (a width-0 `stats` has none)."""
        out: List[torch.Tensor] = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out.extend(t for t in (v if isinstance(v, AdamState) else [v])
                       if math.prod(t.shape[1:]))
        return out

    def empty_rows(self, rows: int, *, device: Optional[torch.device] = None,
                   pin: bool = False) -> "ClientStates":
        """Uninitialized [rows, ...] tensors typed like these (a cohort
        slab), on `device` (default: these tensors'), pinned if `pin`."""
        return self.apply(lambda t: torch.empty(
            (rows,) + tuple(t.shape[1:]), dtype=t.dtype,
            device=t.device if device is None else device, pin_memory=pin))


@dataclasses.dataclass
class HostState:
    """The election's host counters (numpy, one entry per real client)."""

    aggregation_count: np.ndarray
    votes_received: np.ndarray
    rounds_aggregated: list

    def copy(self) -> "HostState":
        return HostState(self.aggregation_count.copy(),
                         self.votes_received.copy(),
                         list(self.rounds_aggregated))

    @staticmethod
    def create(n_real: int) -> "HostState":
        return HostState(np.zeros(n_real, dtype=np.int64),
                         np.zeros(n_real, dtype=np.int64), [])


def fresh_states(params: torch.Tensor,
                 stats: Optional[torch.Tensor] = None) -> ClientStates:
    """States of clients that start at `params` [N, P]: zero Adam state,
    prev_global = params, empty verifier history; running statistics
    `stats` [N, Q] (KitNET's; None: Q = 0)."""
    n = params.shape[0]
    dev = params.device
    return ClientStates(
        params=params, opt_state=adam_init(params),
        prev_global=params.clone(), hist_params=torch.zeros_like(params),
        hist_perf=torch.zeros(n, device=dev),
        hist_seen=torch.zeros(n, dtype=torch.bool, device=dev),
        rejected=torch.zeros(n, dtype=torch.int32, device=dev),
        waived=torch.zeros(n, device=dev), stats=stats)


def init_client_states(model, n_clients: int,
                       generator: torch.Generator, *,
                       n_pad: Optional[int] = None,
                       pad_key: Optional[Tuple[int, int]] = None,
                       device: DeviceLike = "cuda", mesh=None
                       ) -> ClientStates:
    """N independent clients from the port's own init
    (models/autoencoder.init_stacked_params, drawn from `generator`),
    then, when `n_pad` > N, the pad clients [N, n_pad) from the keyed
    stream `pad_key` (ExperimentRngs.init_pad_key; models/autoencoder.
    init_pad_params). The generator draws N clients whatever the padding,
    so the real rows are the unpadded init's bits and the generator ends
    where the unpadded init leaves it. With a sharded `mesh`
    (parallel.ClientMesh) the padded fleet is made on the CPU and the rank
    keeps its block on its device: the dense init's bits, the generator
    advanced alike on every rank. A KitNET model draws Kitsune's init
    (models/kitnet.init_flat) and starts from empty statistics."""
    n_pad = n_clients if n_pad is None else n_pad
    if mesh is not None and mesh.sharded:
        return shard_client_states(
            init_client_states(model, n_clients, generator, n_pad=n_pad,
                               pad_key=pad_key, device="cpu"), mesh)
    dev = resolve_device(device)
    layout = ParamLayout.of(model)
    stats = None
    if layout.family == "kitnet":
        from fedmse_tpu_torch.models import kitnet
        params = kitnet.init_flat(layout, n_clients, generator, device=dev)
        stats = kitnet.fresh_stats(n_pad, layout, dev)

        def pad(ids):
            return kitnet.init_pad_flat(layout, ids, pad_key, device=dev)
    else:
        params = layout.flatten(init_stacked_params(model, n_clients,
                                                    generator, device=dev))

        def pad(ids):
            return layout.flatten(init_pad_params(model, ids, pad_key,
                                                  device=dev))
    if n_pad > n_clients:
        if pad_key is None:
            raise ValueError(f"{n_pad - n_clients} pad clients need a "
                             "pad_key (ExperimentRngs.init_pad_key)")
        params = torch.cat([params, pad(range(n_clients, n_pad))])
    return fresh_states(params, stats)


def init_batched_client_states(model, generators: Sequence[torch.Generator],
                               n_clients: int, *,
                               n_pad: Optional[int] = None,
                               pad_keys: Optional[Sequence] = None,
                               device: DeviceLike = "cuda") -> ClientStates:
    """R runs' clients stacked run by run, [R·n_pad, ...] (the batched
    round's layout, federation/batched.py): rows [r n_pad, (r + 1) n_pad)
    are `init_client_states` of run r's generator (and `pad_keys[r]`),
    bit for bit."""
    keys = pad_keys if pad_keys is not None else [None] * len(generators)
    per_run = [init_client_states(model, n_clients, g, n_pad=n_pad,
                                  pad_key=k, device=device)
               for g, k in zip(generators, keys)]
    return concat_states(per_run)


def concat_states(states: Sequence[ClientStates]) -> ClientStates:
    """States stacked on the client axis, in order (new tensors)."""
    def each(name):
        parts = [getattr(s, name) for s in states]
        if isinstance(parts[0], AdamState):
            return AdamState(*map(torch.cat, zip(*parts)))
        return torch.cat(parts)
    return ClientStates(**{f.name: each(f.name)
                           for f in dataclasses.fields(ClientStates)})


def client_states_from_numpy(states: Any, layout: ParamLayout, *,
                             device: DeviceLike = "cuda") -> ClientStates:
    """The port's ClientStates from the JAX package's, converted to numpy
    (e.g. jax.tree.map(np.asarray, engine.states)): params, optax's Adam
    state, prev_global, the verifier history, rejected and waived."""
    dev = resolve_device(device)

    def flat(tree):
        return layout.flatten({c: {d: {k: torch.from_numpy(
            np.array(v, dtype=np.float32)) for k, v in layer.items()}
            for d, layer in coder.items()}
            for c, coder in tree.items()}).to(dev)

    def vec(a, dtype):
        return torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dtype)

    return ClientStates(
        params=flat(states.params),
        opt_state=opt_state_from_numpy(states.opt_state, layout, device=dev),
        prev_global=flat(states.prev_global),
        hist_params=flat(states.hist_params),
        hist_perf=vec(states.hist_perf, torch.float32),
        hist_seen=vec(states.hist_seen, torch.bool),
        rejected=vec(states.rejected, torch.int32),
        waived=vec(states.waived, torch.float32))


def gather_rows(leaf: torch.Tensor, ids, out: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Rows `ids` (absolute client ids, numpy) of a host tensor [N, ...]
    into `out` (a pinned staging slab, say; default a new tensor). A
    negative id gives a zero row: a cohort's pad lane."""
    ids = np.asarray(ids, dtype=np.int64)
    rows = torch.from_numpy(np.maximum(ids, 0))
    if out is None:
        out = leaf.index_select(0, rows)
    else:
        torch.index_select(leaf, 0, rows, out=out)
    pad = ids < 0
    if pad.any():
        out[torch.from_numpy(pad)] = 0
    return out


def _client_bytes(states: ClientStates) -> int:
    """Bytes of one client's row of every tensor."""
    return sum(t[0].numel() * t.element_size() for t in states.tensors())


class TieredClientStore:
    """The whole fleet's ClientStates as pageable CPU tensors [N, ...] (port
    of fedmse_tpu/federation/state.py `TieredClientStore`): a round moves
    only its cohort's rows to the device (federation/tiered.py). At the
    paper's width a client is 135 KB, so 100k clients are 13.5 GB of host
    memory and a 512-client slab 69.3 MB on the card.

    Rows are keyed by ABSOLUTE client id. `create` draws the dense init's
    stream in the dense init's order, so row i is bit for bit row i of
    `init_client_states(model, N, generator)` and the generator ends where
    the dense init leaves it; `init_chunk` bounds only the working set of
    one draw."""

    def __init__(self, host: ClientStates, n_clients: int):
        self.host = host  # CPU tensors [N, ...]
        self.n_clients = n_clients

    @staticmethod
    def create(model, n_clients: int, generator: torch.Generator,
               init_chunk: int = 4096) -> "TieredClientStore":
        """N clients' init straight into host tensors: each layer's kernels
        in turn, `init_chunk` clients a draw, into the layer's columns of
        the flat [N, P] params (the dense init draws every client's kernel
        of a layer before the next layer's; biases start at zero)."""
        layout = ParamLayout.of(model)
        params = torch.zeros((n_clients, layout.size))
        chunk = max(1, min(int(init_chunk), n_clients))
        for _, off, shape in layout.leaves():
            if len(shape) != 2:
                continue
            fan_in, fan_out = shape
            cols = slice(off, off + fan_in * fan_out)
            for start in range(0, n_clients, chunk):
                stop = min(start + chunk, n_clients)
                params[start:stop, cols] = init_kernels(
                    stop - start, fan_in, fan_out, generator).reshape(
                        stop - start, -1)
        return TieredClientStore(fresh_states(params), n_clients)

    @staticmethod
    def from_dense(states: ClientStates) -> "TieredClientStore":
        """A tier of a dense [N, ...] ClientStates' rows (host copies): a
        restored snapshot, or an init made elsewhere."""
        host = states.apply(
            lambda t: t.detach().to("cpu", copy=True).contiguous())
        return TieredClientStore(host, int(host.hist_perf.shape[0]))

    def gather(self, ids, out: Optional[ClientStates] = None
               ) -> ClientStates:
        """The cohort `ids`' rows [C, ...] on the host, into `out` when
        given (negative ids: zero rows)."""
        if out is None:
            return self.host.apply(lambda t: gather_rows(t, ids))
        for src, dst in zip(self.host.tensors(), out.tensors()):
            gather_rows(src, ids, out=dst)
        return out

    def scatter(self, ids, slab: ClientStates) -> None:
        """Write a round's output slab (host tensors [C, ...]) back into
        the tier; pad lanes (negative ids) are dropped."""
        ids = np.asarray(ids, dtype=np.int64)
        real = ids >= 0
        rows = torch.from_numpy(ids[real])
        lanes = None if real.all() else torch.from_numpy(np.flatnonzero(real))
        for dst, src in zip(self.host.tensors(), slab.tensors()):
            dst.index_copy_(0, rows, src if lanes is None
                            else src.index_select(0, lanes))

    def host_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.host.tensors())

    def slab_bytes(self, cohort: int) -> int:
        """Bytes of one [C, ...] cohort slab."""
        return cohort * _client_bytes(self.host)


class TieredShardStore(TieredClientStore):
    """A host-sharded tier (port of fedmse_tpu/federation/state.py
    `TieredShardStore`): this rank holds rows [start, stop) of the fleet
    only (parallel.mesh.process_tier_blocks). The API stays keyed by
    ABSOLUTE client id: `gather` gives an id outside the shard a zero row
    (another rank's lane) and `scatter` drops it. A shard of the whole
    fleet is the plain tier, bit for bit."""

    def __init__(self, host: ClientStates, n_clients: int, start: int,
                 stop: int):
        if not 0 <= start < stop <= n_clients:
            raise ValueError(f"shard [{start}, {stop}) outside the "
                             f"[0, {n_clients}) client axis")
        super().__init__(host, n_clients)
        self.start, self.stop = start, stop

    @staticmethod
    def create_shard(model, n_clients: int, generator: torch.Generator,
                     start: int, stop: int, init_chunk: int = 4096
                     ) -> "TieredShardStore":
        """Rows [start, stop) of `TieredClientStore.create`'s init: the
        whole fleet's stream is drawn in the same order, chunk by chunk,
        and only this shard's rows are kept, so row i is bit for bit row i
        of the dense init and the generator ends where the dense init
        leaves it."""
        layout = ParamLayout.of(model)
        params = torch.zeros((stop - start, layout.size))
        chunk = max(1, min(int(init_chunk), n_clients))
        for _, off, shape in layout.leaves():
            if len(shape) != 2:
                continue
            fan_in, fan_out = shape
            cols = slice(off, off + fan_in * fan_out)
            for lo in range(0, n_clients, chunk):
                hi = min(lo + chunk, n_clients)
                draw = init_kernels(hi - lo, fan_in, fan_out,
                                    generator).reshape(hi - lo, -1)
                a, b = max(lo, start), min(hi, stop)
                if a < b:
                    params[a - start:b - start, cols] = draw[a - lo:b - lo]
        return TieredShardStore(fresh_states(params), n_clients, start, stop)

    @staticmethod
    def from_dense_slice(states: ClientStates, n_clients: int, start: int,
                         stop: int) -> "TieredShardStore":
        """Rows [start, stop) of a dense-width snapshot (host copies): a
        restore into any shard layout."""
        host = states.apply(lambda t: t[start:stop].detach().to(
            "cpu", copy=True).contiguous())
        return TieredShardStore(host, n_clients, start, stop)

    def _localize(self, ids) -> np.ndarray:
        """Absolute ids -> local rows; ids outside the shard (and pad
        lanes) -> -1."""
        ids = np.asarray(ids, dtype=np.int64)
        local = ids - self.start
        local[(ids < self.start) | (ids >= self.stop)] = -1
        return local

    def gather(self, ids, out: Optional[ClientStates] = None
               ) -> ClientStates:
        return super().gather(self._localize(ids), out)

    def scatter(self, ids, slab: ClientStates) -> None:
        super().scatter(self._localize(ids), slab)


def shard_client_states(states: ClientStates, mesh) -> ClientStates:
    """This rank's block of a whole fleet's states on its device (the
    canonical layout of every per-client tensor over a client mesh: the
    Adam moments live only on the rank that trains the client)."""
    from fedmse_tpu_torch.parallel.mesh import shard_clients
    return shard_clients(states, mesh)


def make_sharded_client_update(lr: float, mesh=None):
    """fn(grads [n, P], opt_state, params [n, P]) -> (params, opt_state):
    one Adam step of the clients a rank holds (every client of the fleet
    without a mesh). The step is per client, so a rank's block is bit for
    bit those rows of the whole fleet's step, and no rank holds another's
    moments."""
    del mesh  # the block is the rank's own tensors: nothing crosses ranks

    def update(grads, opt_state: AdamState, params):
        step = torch.ones(params.shape[0], dtype=torch.bool,
                          device=params.device)
        return adam_step(params, opt_state, grads, step, lr)

    return update


def dense_state_bytes(model, n_clients: int) -> int:
    """Bytes of a dense ClientStates of N clients (never allocated)."""
    return n_clients * _client_bytes(fresh_states(
        torch.zeros((1, ParamLayout.of(model).size))))


def tree_select_clients(accept: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """Per-client select: rows of `a` where accept [N] is true, of `b`
    elsewhere (`a` may be one [P] row, broadcast to every client)."""
    return torch.where(accept.reshape(-1, *([1] * (b.dim() - 1))), a, b)


class AdamNumpy(NamedTuple):
    """optax's ScaleByAdamState fields, as numpy."""

    count: np.ndarray
    mu: Dict[str, Any]
    nu: Dict[str, Any]


class NumpyClientStates(NamedTuple):
    """ClientStates in the JAX package's structure, numpy leaves: param
    trees, and the Adam state as optax chains it (a tuple whose first
    element holds count, mu and nu)."""

    params: Dict[str, Any]
    opt_state: Tuple[AdamNumpy]
    prev_global: Dict[str, Any]
    hist_params: Dict[str, Any]
    hist_perf: np.ndarray
    hist_seen: np.ndarray
    rejected: np.ndarray
    waived: np.ndarray


def client_states_to_numpy(states: ClientStates,
                           layout: ParamLayout) -> NumpyClientStates:
    """The inverse of `client_states_from_numpy`."""
    def tree(t):
        return {c: {d: {k: v.numpy() for k, v in layer.items()}
                    for d, layer in coder.items()}
                for c, coder in layout.tree(t.detach().cpu()).items()}

    def vec(t, dtype):
        return t.detach().cpu().numpy().astype(dtype)

    return NumpyClientStates(
        params=tree(states.params),
        opt_state=(AdamNumpy(**opt_state_to_numpy(states.opt_state,
                                                  layout)),),
        prev_global=tree(states.prev_global),
        hist_params=tree(states.hist_params),
        hist_perf=vec(states.hist_perf, np.float32),
        hist_seen=vec(states.hist_seen, bool),
        rejected=vec(states.rejected, np.int32),
        waived=vec(states.waived, np.float32))


def client_mean_weights(client_mask: torch.Tensor) -> torch.Tensor:
    """The uniform mean's weights over client_mask [N], with the empty-mask
    clamp (all zeros: a zero model)."""
    return client_mask / torch.clamp(client_mask.sum(), min=1.0)


def tree_client_divergence(params: torch.Tensor,
                           client_mask: torch.Tensor) -> torch.Tensor:
    """Per-client L2 distance [N] of each params row [N, P] from the
    client_mask-weighted mean model, in f32: the chaos axis's resilience
    observable (padded clients weigh nothing but report a distance)."""
    mean = weighted_mean(params, client_mean_weights(client_mask))
    d = params.to(torch.float32) - mean
    return torch.sqrt((d * d).sum(dim=1))

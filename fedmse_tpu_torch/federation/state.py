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

`HostState` keeps the election's counters on the host.
`client_states_from_numpy` takes the JAX package's ClientStates (as numpy),
so both packages can start from one init: jax.random's draws cannot be
reproduced in torch.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from fedmse_tpu_torch.device import DeviceLike, resolve_device
from fedmse_tpu_torch.federation.optim import (AdamState, adam_init,
                                               opt_state_from_numpy)
from fedmse_tpu_torch.models.autoencoder import init_stacked_params
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
        """Take `new`'s values where the device predicate `keep` (a 0-d
        bool) holds, in place: a branch without a host read."""
        for f in dataclasses.fields(self):
            mine, theirs = getattr(self, f.name), getattr(new, f.name)
            pairs = zip(mine, theirs) if isinstance(mine, AdamState) \
                else [(mine, theirs)]
            for a, b in pairs:
                torch.where(keep, b, a, out=a)

    def to(self, device: DeviceLike) -> "ClientStates":
        dev = resolve_device(device)
        return self.apply(lambda t: t.to(dev))


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


def fresh_states(params: torch.Tensor) -> ClientStates:
    """States of clients that start at `params` [N, P]: zero Adam state,
    prev_global = params, empty verifier history."""
    n = params.shape[0]
    dev = params.device
    return ClientStates(
        params=params, opt_state=adam_init(params),
        prev_global=params.clone(), hist_params=torch.zeros_like(params),
        hist_perf=torch.zeros(n, device=dev),
        hist_seen=torch.zeros(n, dtype=torch.bool, device=dev),
        rejected=torch.zeros(n, dtype=torch.int32, device=dev),
        waived=torch.zeros(n, device=dev))


def init_client_states(model, n_clients: int,
                       generator: torch.Generator, *,
                       device: DeviceLike = "cuda") -> ClientStates:
    """N independent clients from the port's own init
    (models/autoencoder.init_stacked_params, drawn from `generator`)."""
    tree = init_stacked_params(model, n_clients, generator,
                               device=resolve_device(device))
    return fresh_states(ParamLayout.of(model).flatten(tree))


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


def tree_select_clients(accept: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """Per-client select: rows of `a` where accept [N] is true, of `b`
    elsewhere (`a` may be one [P] row, broadcast to every client)."""
    return torch.where(accept.reshape(-1, *([1] * (b.dim() - 1))), a, b)

"""ChaosSpec -> per-round fault masks, on the host (port of
fedmse_tpu/chaos/masks.py).

`make_chaos_masks` expands a spec into [T, N] availability, straggler and
broadcast-loss masks and [T] aggregator-crash bits; the fused round
(federation/fused.py) takes one round's slice from a device buffer that
each chunk uploads. The effective cohort is selected ∧ available ∧
¬straggler, a crash bit triggers the re-election, and broadcast-loss
clients keep their state.

Determinism: client i's draws at round t come from
`stream_rng(chaos_key, 0, t, i)` alone and the crash bit from
`stream_rng(chaos_key, 1, t, 0)`, with t and i absolute, so the masks do
not depend on chunking or on padding of the client axis. Outside the
[start_round, stop_round) window every mask is all-clear, and a zero
probability never fires (u < 0 is false for u in [0, 1)). The
re-election's tie-break draws come from the same stream
(`reelection_draws`). `make_batched_chaos_masks` stacks R runs' masks,
each from its own run's chaos key, on a [T, R, ...] layout (the batched
round, federation/batched.py).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

from fedmse_tpu_torch.chaos.spec import ChaosSpec
from fedmse_tpu_torch.utils.seeding import StreamKey, stream_rng

_CLIENT, _CRASH, _REELECT = 0, 1, 2  # sub-streams of the chaos stream


class ChaosMasks(NamedTuple):
    """Per-round fault masks, numpy, on a leading [T] rounds axis."""

    available: np.ndarray   # [T, N] f32: 1 = the client is up
    straggler: np.ndarray   # [T, N] f32: 1 = trained past the deadline
    crash: np.ndarray       # [T] bool: the elected aggregator crashes
    bcast_drop: np.ndarray  # [T, N] f32: 1 = misses the broadcast


def all_clear_masks(n_clients: int) -> ChaosMasks:
    """The no-fault masks of one round (what a null spec draws), [1, N]."""
    return ChaosMasks(available=np.ones((1, n_clients), np.float32),
                      straggler=np.zeros((1, n_clients), np.float32),
                      crash=np.zeros(1, bool),
                      bcast_drop=np.zeros((1, n_clients), np.float32))


def make_chaos_masks(spec: ChaosSpec, chaos_key: StreamKey, start_round: int,
                     n_rounds: int, n_clients: int) -> ChaosMasks:
    """Masks of rounds [start_round, start_round + n_rounds)."""
    t_all = np.arange(start_round, start_round + n_rounds)
    in_window = t_all >= spec.start_round
    if spec.stop_round is not None:
        in_window &= t_all < spec.stop_round
    u = np.empty((n_rounds, n_clients, 3))
    crash_u = np.empty(n_rounds)
    for r, t in enumerate(t_all):
        for i in range(n_clients):
            u[r, i] = stream_rng(chaos_key, _CLIENT, t, i).random(3)
        crash_u[r] = stream_rng(chaos_key, _CRASH, t, 0).random()
    win = in_window[:, None]
    f32 = np.float32
    return ChaosMasks(
        available=np.where(win & (u[..., 0] < spec.dropout_p), 0, 1
                           ).astype(f32),
        straggler=(win & (u[..., 1] < spec.straggler_p)).astype(f32),
        crash=in_window & (crash_u < spec.crash_p),
        bcast_drop=(win & (u[..., 2] < spec.broadcast_loss_p)).astype(f32))


def reelection_draws(chaos_key: StreamKey, start_round: int, n_rounds: int,
                     voters: int, n_clients: int) -> np.ndarray:
    """[n_rounds, voters, n_clients] f32 tie-break uniforms of the crash
    re-election (voter s jitters client i with [r, s, i]); client i's
    column at round t from (t, i) alone."""
    out = np.empty((n_rounds, voters, n_clients), np.float32)
    for r in range(n_rounds):
        for i in range(n_clients):
            out[r, :, i] = stream_rng(chaos_key, _REELECT, start_round + r,
                                      i).random(voters, dtype=np.float32)
    return out


def make_batched_chaos_masks(spec: ChaosSpec, chaos_keys: Sequence[StreamKey],
                             start_round: int, n_rounds: int,
                             n_clients: int) -> ChaosMasks:
    """R runs' masks, run r's from its own key (what R sequential runs
    draw), leaves stacked [T, R, ...]."""
    per_run = [make_chaos_masks(spec, key, start_round, n_rounds, n_clients)
               for key in chaos_keys]
    return ChaosMasks(*(np.stack(leaves, axis=1)
                        for leaves in zip(*per_run)))

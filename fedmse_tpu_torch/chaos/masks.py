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
probability never fires (u < 0 is false for u in [0, 1)). Below the
vote tie-break's size rule (federation/voting.keyed_tie_break) the
re-election's tie-break draws come from the same stream
(`reelection_draws`); above it the engines build no [T, S, N] horizon
and the re-election reads keyed rows under the chaos key
(utils/seeding.ExperimentRngs.reelect_key), one voter's row at a time. `chaos_columns` and `reelection_columns` draw one
round at given absolute clients only (a tiered cohort's); the whole-fleet
masks are made of them.
`make_batched_chaos_masks` stacks R runs' masks,
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
    ids = np.arange(n_clients)
    f32 = np.float32
    out = ChaosMasks(available=np.empty((n_rounds, n_clients), f32),
                     straggler=np.empty((n_rounds, n_clients), f32),
                     crash=np.empty(n_rounds, bool),
                     bcast_drop=np.empty((n_rounds, n_clients), f32))
    for r in range(n_rounds):
        for mask, row in zip(out, chaos_columns(spec, chaos_key,
                                                start_round + r, ids)):
            mask[r] = row[0]
    return out


def reelection_draws(chaos_key: StreamKey, start_round: int, n_rounds: int,
                     voters: int, n_clients: int) -> np.ndarray:
    """[n_rounds, voters, n_clients] f32 tie-break uniforms of the crash
    re-election (voter s jitters client i with [r, s, i]); client i's
    column at round t from (t, i) alone."""
    out = np.empty((n_rounds, voters, n_clients), np.float32)
    for r in range(n_rounds):
        out[r] = reelection_columns(chaos_key, start_round + r, voters,
                                    np.arange(n_clients))
    return out


def chaos_columns(spec: ChaosSpec, chaos_key: StreamKey, round_index: int,
                  ids) -> ChaosMasks:
    """Round `round_index`'s masks at the absolute clients `ids`, [1, C]
    (the crash bit [1]): client i's draws from (round, i) alone, so these
    are make_chaos_masks' columns `ids`."""
    ids = np.asarray(ids, dtype=np.int64)
    t = round_index
    win = t >= spec.start_round and (spec.stop_round is None
                                     or t < spec.stop_round)
    u = (np.stack([stream_rng(chaos_key, _CLIENT, t, int(i)).random(3)
                   for i in ids]) if len(ids) else np.empty((0, 3)))
    crash_u = stream_rng(chaos_key, _CRASH, t, 0).random()
    f32 = np.float32
    return ChaosMasks(
        available=np.where(win & (u[:, 0] < spec.dropout_p), 0, 1
                           ).astype(f32)[None],
        straggler=(win & (u[:, 1] < spec.straggler_p)).astype(f32)[None],
        crash=np.array([win and crash_u < spec.crash_p]),
        bcast_drop=(win & (u[:, 2] < spec.broadcast_loss_p)
                    ).astype(f32)[None])


def reelection_columns(chaos_key: StreamKey, round_index: int, voters: int,
                       ids) -> np.ndarray:
    """[voters, C] re-election draws of round `round_index` at the absolute
    clients `ids` (reelection_draws' columns `ids`)."""
    cols = [stream_rng(chaos_key, _REELECT, round_index, int(i)).random(
        voters, dtype=np.float32) for i in np.asarray(ids)]
    return (np.stack(cols, axis=1) if cols
            else np.empty((voters, 0), np.float32))


def make_batched_chaos_masks(spec: ChaosSpec, chaos_keys: Sequence[StreamKey],
                             start_round: int, n_rounds: int,
                             n_clients: int) -> ChaosMasks:
    """R runs' masks, run r's from its own key (what R sequential runs
    draw), leaves stacked [T, R, ...]."""
    per_run = [make_chaos_masks(spec, key, start_round, n_rounds, n_clients)
               for key in chaos_keys]
    return ChaosMasks(*(np.stack(leaves, axis=1)
                        for leaves in zip(*per_run)))

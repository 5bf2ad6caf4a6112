"""Elastic federation: dynamic membership as per-round masks (port of
fedmse_tpu/federation/elastic.py).

The federation is a pool of N client slots. A *leave* retires a slot: no
training, vote, aggregation weight or broadcast, its Adam moments zeroed,
its evaluation metric NaN. A *join* recycles a retired slot for a new
tenant: its generation counter advances, its params and prev_global are
the incumbent-mean model (the uniform f32 mean of every member slot that
is not itself joining; zeros when there is none), its Adam moments are
zeroed and its verifier history cleared. A *preempt* is a leave and a join
in one round on an occupied slot. The fused round applies these as masked
selects at its entry (federation/fused.py), from [T, N] masks each chunk
uploads, so nothing is captured again when the roster changes.

`make_membership_masks` expands an `ElasticSpec` on the host into the
member / joined / left / generation timeline. It is a Markov chain, so it
always expands from round 0 (the engine caches the whole horizon and
slices it per chunk; a longer horizon extends it without changing its
prefix). Slot i's draws at round t come from `stream_rng(elastic_key, 0,
t, i)` alone (utils/seeding.py), so padding the client axis cannot change
a real slot's timeline, and a null spec draws the all-member masks.

`make_batched_membership_masks` stacks R runs' timelines, each from its
own run's elastic key, on a [T, R, N] layout (the batched round,
federation/batched.py). `apply_membership_transitions` applies one round's
entry transitions to the host tier's rows instead (the tiered layout,
federation/tiered.py, whose round sees only its cohort).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np

from fedmse_tpu_torch.utils.seeding import StreamKey, stream_rng

_RATE_FIELDS = ("leave_p", "join_p", "preempt_p")
_WINDOW_FIELDS = ("leave_window", "join_window", "preempt_window")
_STEP, _INIT = 0, 1  # sub-streams of the elastic stream


@dataclasses.dataclass(frozen=True)
class ElasticSpec:
    """Membership-event rates and their windows.

    `leave_p` / `join_p` / `preempt_p` are per-slot per-round transition
    probabilities: leave fires on occupied slots, join on retired ones,
    preempt on occupied slots that did not just leave. The global
    [start_round, stop_round) window bounds all three; each kind may
    override it with its own (start, stop) (stop None: to the end).
    `initial_member_frac` < 1 starts the pool partly empty."""

    leave_p: float = 0.0
    join_p: float = 0.0
    preempt_p: float = 0.0
    start_round: int = 0
    stop_round: Optional[int] = None
    leave_window: Optional[Tuple[int, Optional[int]]] = None
    join_window: Optional[Tuple[int, Optional[int]]] = None
    preempt_window: Optional[Tuple[int, Optional[int]]] = None
    initial_member_frac: float = 1.0

    def __post_init__(self):
        for name in _RATE_FIELDS:
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        if not 0.0 < self.initial_member_frac <= 1.0:
            raise ValueError("initial_member_frac must be in (0, 1], got "
                             f"{self.initial_member_frac} (an empty initial "
                             "pool would have no model to join from)")
        if self.start_round < 0:
            raise ValueError(
                f"start_round must be >= 0, got {self.start_round}")
        if self.stop_round is not None and self.stop_round <= self.start_round:
            raise ValueError(
                f"stop_round ({self.stop_round}) must be > start_round "
                f"({self.start_round}); the window [start, stop) is else "
                f"empty and the spec is a silent no-op")
        for name in _WINDOW_FIELDS:
            win = getattr(self, name)
            if win is None:
                continue
            if len(win) != 2:
                raise ValueError(f"{name} must be (start, stop), got {win!r}")
            start, stop = win
            if start < 0:
                raise ValueError(f"{name} start must be >= 0, got {start}")
            if stop is not None and stop <= start:
                raise ValueError(
                    f"{name} ({win}) is empty: stop must be > start")

    @property
    def is_null(self) -> bool:
        """True when the spec changes nothing (every rate zero, the pool
        full)."""
        return (all(getattr(self, n) == 0.0 for n in _RATE_FIELDS)
                and self.initial_member_frac == 1.0)

    def window_for(self, kind: str) -> Tuple[int, Optional[int]]:
        """(start, stop) of 'leave', 'join' or 'preempt'."""
        win = getattr(self, f"{kind}_window")
        return (self.start_round, self.stop_round) if win is None else win

    def signature(self) -> str:
        """The checkpoint's record of the timeline: a snapshot resumes only
        under the spec it was written with (the JAX package's spelling)."""
        def w(win):
            return "-" if win is None else f"{win[0]}.{win[1]}"
        return (f"l{self.leave_p:g}j{self.join_p:g}p{self.preempt_p:g}"
                f"s{self.start_round}e{self.stop_round}"
                f"wl{w(self.leave_window)}wj{w(self.join_window)}"
                f"wp{w(self.preempt_window)}m{self.initial_member_frac:g}")


class MembershipMasks(NamedTuple):
    """The membership timeline, numpy, on a leading [T] rounds axis."""

    member: np.ndarray      # [T, N] f32: 1 = slot occupied this round
    joined: np.ndarray      # [T, N] f32: 1 = a new tenant's first round
    left: np.ndarray        # [T, N] f32: 1 = the tenant left at entry
    generation: np.ndarray  # [T, N] int32: tenant generation of the slot


def all_member_masks(n_clients: int) -> MembershipMasks:
    """One round of the static federation (what a null spec draws)."""
    return MembershipMasks(member=np.ones((1, n_clients), np.float32),
                           joined=np.zeros((1, n_clients), np.float32),
                           left=np.zeros((1, n_clients), np.float32),
                           generation=np.zeros((1, n_clients), np.int32))


def _in_window(t: int, window: Tuple[int, Optional[int]]) -> bool:
    start, stop = window
    return t >= start and (stop is None or t < stop)


def make_membership_masks(spec: ElasticSpec, elastic_key: StreamKey,
                          n_rounds: int, n_clients: int) -> MembershipMasks:
    """The timeline of rounds [0, n_rounds)."""
    member = np.ones(n_clients, bool)
    if spec.initial_member_frac < 1.0:
        member = np.asarray([stream_rng(elastic_key, _INIT, 0, i).random()
                             < spec.initial_member_frac
                             for i in range(n_clients)])
    gen = np.zeros(n_clients, np.int32)
    out = {k: np.empty((n_rounds, n_clients), np.float32)
           for k in ("member", "joined", "left")}
    generation = np.empty((n_rounds, n_clients), np.int32)
    for t in range(n_rounds):
        u = np.stack([stream_rng(elastic_key, _STEP, t, i).random(3)
                      for i in range(n_clients)]) if n_clients else \
            np.empty((0, 3))
        leave = ((u[:, 0] < spec.leave_p)
                 & _in_window(t, spec.window_for("leave")) & member)
        join = ((u[:, 1] < spec.join_p)
                & _in_window(t, spec.window_for("join")) & ~member)
        pre = ((u[:, 2] < spec.preempt_p)
               & _in_window(t, spec.window_for("preempt")) & member & ~leave)
        member = (member & ~leave) | join
        recycled = join | pre
        gen = gen + recycled.astype(np.int32)
        out["member"][t], out["joined"][t] = member, recycled
        out["left"][t], generation[t] = leave, gen
    return MembershipMasks(generation=generation, **out)


def make_batched_membership_masks(spec: ElasticSpec,
                                  elastic_keys: Sequence[StreamKey],
                                  n_rounds: int,
                                  n_clients: int) -> MembershipMasks:
    """R runs' timelines, run r's from its own key (what R sequential runs
    draw), leaves stacked [T, R, N]."""
    per_run = [make_membership_masks(spec, key, n_rounds, n_clients)
               for key in elastic_keys]
    return MembershipMasks(*(np.stack(leaves, axis=1)
                             for leaves in zip(*per_run)))


def membership_at(masks: MembershipMasks, round_index: int,
                  n_real: Optional[int] = None):
    """(member bool, generation int64) after `round_index` rounds: the full
    generation-0 pool before any round."""
    if round_index <= 0:
        n = masks.member.shape[1]
        member, gen = np.ones(n, bool), np.zeros(n, np.int64)
    else:
        member = np.asarray(masks.member[round_index - 1]) > 0
        gen = np.asarray(masks.generation[round_index - 1]).astype(np.int64)
    if n_real is not None:
        member, gen = member[:n_real], gen[:n_real]
    return member, gen


def apply_membership_transitions(store, member: np.ndarray,
                                 joined: np.ndarray, left: np.ndarray,
                                 assignment: Optional[np.ndarray] = None,
                                 k: int = 1, merge_partials=None) -> None:
    """One round's entry transitions on a host tier's rows, in place (port
    of fedmse_tpu/federation/elastic.py `apply_membership_transitions`;
    `store` a federation/state.TieredClientStore). A joining slot takes the
    incumbent mean (the uniform f32 mean of every member slot that is not
    itself joining, over the WHOLE fleet, in numpy) as its params and
    prev_global, zeroed Adam state and a cleared verifier history
    (hist_params, hist_perf, hist_seen, rejected; `waived` is kept, as in
    the JAX tier); a leaving slot's Adam state is zeroed. With
    `assignment` ([N] gateway -> cluster) and k > 1 a joiner takes its
    own cluster's incumbent mean, the fleet's when its cluster has no
    incumbent.

    A host-sharded tier (state.TieredShardStore) holds only rows [start,
    stop): the masks stay fleet-wide, the mean's sums run over the local
    columns, and `merge_partials` (parallel.multihost.allgather_tree_sum)
    adds the ranks' partials in rank order; every rank must call it
    whenever the fleet has joiners. Writes touch local rows only. A store
    of the whole fleet with no `merge_partials` is the plain sum, bit for
    bit."""
    member = np.asarray(member) > 0
    joined_b = np.asarray(joined) > 0
    left_b = np.asarray(left) > 0
    n = len(member)
    start = getattr(store, "start", 0)
    stop = getattr(store, "stop", n)
    host = store.host
    if joined_b.any():
        incumbents = (member & ~joined_b).astype(np.float32)
        fleet_w = incumbents / max(float(incumbents.sum()), 1.0)
        rows = np.flatnonzero(joined_b)
        params = host.params.numpy()
        p32 = params.astype(np.float32, copy=False)
        if assignment is not None and k > 1:
            assignment = np.asarray(assignment)
            sheet = np.zeros((k, len(incumbents)), np.float32)
            sheet[assignment, np.arange(len(incumbents))] = 1.0
            sheet *= incumbents[None, :]
            counts = sheet.sum(axis=1)
            has = counts > 0
            sheet /= np.maximum(counts, 1.0)[:, None]
            w_rows = np.where(has[assignment[rows], None],
                              sheet[assignment[rows]], fleet_w[None, :])
            mean = np.einsum("jn,n...->j...", w_rows[:, start:stop], p32)
        else:
            mean = np.einsum("n,n...->...", fleet_w[start:stop], p32)
        if merge_partials is not None:
            mean = merge_partials([mean])[0]
        mean = mean.astype(params.dtype)
        mine = (rows >= start) & (rows < stop)
        local = rows[mine] - start
        if mean.ndim == 2:
            mean = mean[mine]
        params[local] = mean
        host.prev_global.numpy()[local] = mean
        host.hist_params.numpy()[local] = 0
        host.hist_perf.numpy()[local] = 0.0
        host.hist_seen.numpy()[local] = False
        host.rejected.numpy()[local] = 0
    reset = (joined_b | left_b)[start:stop]
    if reset.any():
        rows = np.flatnonzero(reset)
        for t in host.opt_state:
            t.numpy()[rows] = 0

"""Pipelined chunk execution: the host's bookkeeping of chunk k overlaps
chunk k + 1 on the card (port of fedmse_tpu/federation/pipeline.py
`run_pipelined_schedule`).

  1. **Pre-dispatch.** Chunk k + 1's selections and draws are made and its
     rounds enqueued before chunk k's outputs are touched. The only data
     dependency between chunks, the aggregation quota that gates the
     election, is carried on the device (`InFlightChunk.agg_count`): the
     dispatch does not wait for the host's counters.
  2. **Late harvest.** Each chunk's outputs start their copy into pinned
     memory at the end of its dispatch; the harvest, one chunk late, finds
     them there, and the RoundResults, logging and the ResultsWriter's IO
     run while the next chunk computes.
  3. **Late early stop.** A stop found in chunk k's results while chunk
     k + 1 is in flight rewinds with the snapshots: a stop before chunk
     k's last round restores chunk k's entry states and host counters and
     replays the prefix with the recorded selections and draws; a stop at
     its last round takes chunk k + 1's entry snapshot. Chunk k + 1 is
     discarded, never harvested, so the final states are the serial
     loop's.

The host snapshot a chunk needs for its rewind (the host counters at its
entry) is attached lazily, once its predecessor has been absorbed: only
then are the counters those of its entry.

A clustered engine fits its assignment at a chunk's entry from the states
every earlier round left. So when a refit is due at chunk k + 1
(`engine.cluster_refit_due`), and only then, the loop absorbs chunk k
before it dispatches chunk k + 1: a fit never reads states still in
flight, and a stop in chunk k ends the run before the refit. A rewind
replays its chunk's prefix under the assignment the chunk ran with.

On the card a fused chunk's dispatch returns once its last round's final
epoch is enqueued (the host reads each epoch's early-stop flag an epoch
behind the card, federation/fused.py), so the overlap is what the card
still has queued then: that epoch and the round's close.

`pipelined=False` is the serial chunk loop (the driver's
`--no-pipeline`, and `--resume-dir`): each chunk is harvested and absorbed
before the next is dispatched, with the same rewind, and `on_chunk` sees
the rounds done after each chunk (the driver checkpoints there: the state
is never speculative, and a rewound chunk has been replayed by then).

`PipelineStats.host_gaps` records at each chunk boundary t_dispatch(k + 1)
- t_harvest_done(k), negative by construction when pipelined.

`run_pipelined_batched` drives a BatchedRunEngine (federation/batched.py)
the same way, with the batched stop protocol: a run that stops in chunk k
while chunk k + 1 is in flight makes chunk k + 1 wrong (it ran the stopped
lane live), so chunk k + 1 is discarded and dispatched again with the same
selections and draws, the corrected lane mask and the host's quota; a stop
before chunk k's last round first rewinds chunk k to its entry snapshot
and replays it with the per-round freeze matrix and its entry quota.

`PrefetchedCohort` and `TieredStats` are the tiered layout's prefetch slot
and its telemetry (federation/tiered.py): round k + 1's cohort is gathered
on the host and copied to the card on a side stream while round k runs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

import numpy as np

from fedmse_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class InFlightChunk:
    """One dispatched, not yet harvested chunk of fused rounds."""

    start_round: int
    n_rounds: int
    schedule: list                 # the selections (a rewind's replay input)
    draws: Any                     # [R, S, N] tie-break uniforms or None
    agg_count: Any                 # the device quota after the chunk
    harvest: Callable[[], list]    # waits for the outputs: FusedRoundOuts
    t_dispatch: float              # host clock when the chunk was enqueued
    snap_states: Any = None        # the chunk-entry device snapshot
    host_snap: Any = None          # the host counters at entry (lazily)
    cluster_in: Any = None         # the [N] assignment it ran under
    active: Any = None             # batched: [R] runs live at dispatch
    entry_agg: Any = None          # batched: [R, N] quota at entry (lazily)


@dataclasses.dataclass
class PipelineStats:
    """Per-run telemetry of the pipelined executor."""

    chunks: int = 0
    host_gaps: List[float] = dataclasses.field(default_factory=list)
    redispatches: int = 0  # batched: speculative chunks dispatched again

    def summary(self) -> dict:
        gaps = self.host_gaps
        return {"chunks": self.chunks, "host_gap_s": gaps,
                "redispatches": self.redispatches,
                # every next dispatch was enqueued before the previous
                # harvest completed
                "overlapped": bool(gaps) and all(g <= 0 for g in gaps)}


@dataclasses.dataclass
class PrefetchedCohort:
    """One round's cohort, prefetched while the previous round computes
    (port of fedmse_tpu/federation/pipeline.py `PrefetchedCohort`): the
    host gather of the cohort's state and data rows into a pinned staging
    slab, and their copy to the card's prefetch slab on a side stream,
    issued while round k runs. Rows that round k is changing are stale
    here; the engine patches them on the card from round k's output
    before the round reads them. The verification rows need no slab of
    their own: a client's are its valid rows in the data, or one pair all
    share, set once."""

    plan: Any                  # CohortPlan (federation/tiered.py)
    slab: Any                  # ClientStates [C] on the engine's device
                               # (None: the gather waits for the round's
                               # entry, as under elastic membership)
    data: Any                  # the cohort's data rows, by field name
    ready: Any = None          # the side stream's copy event (the card)
    t_issue_start: float = 0.0  # host clock: the gather began
    t_issue_end: float = 0.0    # host clock: every copy enqueued


@dataclasses.dataclass
class TieredStats:
    """Per-run telemetry of the tiered cohort loop (port of
    fedmse_tpu/federation/pipeline.py `TieredStats`)."""

    rounds: int = 0
    prefetch_issue_s: List[float] = dataclasses.field(default_factory=list)
    prefetch_wait_s: List[float] = dataclasses.field(default_factory=list)
    overlapped_issue: List[bool] = dataclasses.field(default_factory=list)

    def summary(self) -> dict:
        waits = self.prefetch_wait_s
        return {
            "rounds": self.rounds,
            "prefetch_issue_s": [round(g, 5) for g in self.prefetch_issue_s],
            # the prefetch gap: host seconds a round waited for its
            # prefetched cohort to land (~0 when the copy overlapped the
            # previous round)
            "prefetch_gap_s": [round(g, 5) for g in waits],
            "prefetch_gap_mean_s": (round(float(np.mean(waits)), 5)
                                    if waits else None),
            # every prefetch was issued before the previous round's
            # harvest completed (the loop's order, not the copy's)
            "overlapped": bool(self.overlapped_issue) and
            all(self.overlapped_issue),
        }


def run_pipelined_schedule(engine, start_round: int, num_rounds: int,
                           chunk_size: int,
                           consume: Callable[[list, float], Optional[int]],
                           can_rewind: bool = True,
                           pipelined: bool = True,
                           on_chunk: Optional[Callable[[int], None]] = None
                           ) -> PipelineStats:
    """Drive a RoundEngine's fused schedule in chunks, double-buffered
    unless `pipelined=False` (the serial chunk loop).

    `consume(results, sec_per_round)` absorbs one harvested chunk's
    RoundResults (logging, writer IO, early stop) and returns the 0-based
    position of the stop round inside the chunk, or None; when pipelined
    it runs while the next chunk is in flight. `can_rewind=False` promises
    it never stops, and no snapshot is taken. `on_chunk(rounds_done)`, of
    the serial loop only, runs after each absorbed chunk with the absolute
    number of rounds done."""
    if on_chunk is not None and pipelined:
        raise ValueError("on_chunk needs the serial chunk loop "
                         "(pipelined=False): a pipelined boundary's state "
                         "is speculative")
    stats = PipelineStats()
    prev: Optional[InFlightChunk] = None
    round_index = start_round

    def absorb(chunk: InFlightChunk,
               successor: Optional[InFlightChunk]) -> Optional[int]:
        """Harvest and consume a chunk, rewinding on a stop inside it:
        None, or the rounds of the chunk done when the run stops."""
        results, schedule, draws = engine.harvest_schedule_chunk(chunk)
        t_done = time.time()
        if successor is not None:
            stats.host_gaps.append(successor.t_dispatch - t_done)
        sec = (t_done - chunk.t_dispatch) / chunk.n_rounds
        with span("fused.pipeline.consume", chunk.start_round):
            stop = consume(results, sec)
        if stop is None:
            return None
        done = stop + 1
        if done < chunk.n_rounds:
            # a mid-chunk stop: rewind to the chunk's entry and replay the
            # prefix with the same inputs
            engine.states = chunk.snap_states
            engine.host = chunk.host_snap
            for j in range(done):
                engine.run_round_fused(
                    chunk.start_round + j, selected=schedule[j],
                    draws=None if draws is None else draws[j],
                    cluster_in=chunk.cluster_in)
        elif successor is not None:
            # a stop at the chunk's last round with the successor in
            # flight: its entry snapshot is the state after the stop
            engine.states = successor.snap_states
        return done

    while round_index < num_rounds:
        k = min(chunk_size, num_rounds - round_index)
        if prev is not None and engine.cluster_refit_due(round_index):
            # the refit reads the states chunk `prev` leaves: wait for it
            if absorb(prev, None) is not None:
                return stats
            prev = None
        cur = engine.dispatch_schedule_chunk(
            round_index, k, agg_count=None if prev is None else prev.agg_count,
            snapshot=can_rewind)
        stats.chunks += 1
        round_index += k
        if prev is not None and absorb(prev, cur) is not None:
            return stats  # cur is speculative: never harvested
        if can_rewind:
            cur.host_snap = engine.host.copy()
        prev = cur
        if not pipelined:
            prev = None
            done = absorb(cur, None)
            if on_chunk is not None:
                on_chunk(cur.start_round + (k if done is None else done))
            if done is not None:
                return stats
    if prev is not None:
        absorb(prev, None)
    return stats


def run_pipelined_batched(engine, num_rounds: int, chunk_size: int,
                          consume: Callable, pipelined: bool = True
                          ) -> PipelineStats:
    """Drive a BatchedRunEngine's schedule in chunks, double-buffered unless
    `pipelined=False` (the serial chunk loop).

    `consume(outs, schedule, start_round, k, sec, active)` absorbs one
    harvested chunk, calling `engine.process_round` for every (round, run)
    up to that run's stop, and returns per run the position of its stop
    inside the chunk, or None. Runs whose `active` flag is False are
    frozen already and must be skipped. The stop protocol is the module
    docstring's; a re-dispatch costs one extra chunk, paid only when a run
    stops with its successor in flight."""
    runs = engine.runs
    stopped = np.zeros(runs, dtype=bool)
    stats = PipelineStats()
    prev: Optional[InFlightChunk] = None
    round_index = 0

    def fix_states(chunk: InFlightChunk, stop_pos,
                   successor: Optional[InFlightChunk]) -> bool:
        """The serial loop's device state after chunk's stops; True when a
        run newly stopped (the successor must be dispatched again)."""
        if not any(p is not None for p in stop_pos):
            return False
        if any(p is not None and p < chunk.n_rounds - 1 for p in stop_pos):
            # a mid-chunk stop: rewind, and replay with the freeze matrix
            # and the chunk's entry quota
            engine.states = chunk.snap_states
            act = np.zeros((chunk.n_rounds, runs), dtype=bool)
            for i in range(chunk.n_rounds):
                for r in range(runs):
                    act[i, r] = chunk.active[r] and (
                        stop_pos[r] is None or i <= stop_pos[r])
            engine.run_schedule_chunk(
                chunk.start_round, chunk.n_rounds, chunk.active,
                schedule=chunk.schedule, draws=chunk.draws,
                active_rounds=act, agg_count=chunk.entry_agg)
        elif successor is not None:
            # stops at the chunk's last round only: the successor's entry
            # snapshot is the state after them
            engine.states = successor.snap_states
        return True

    def absorb(chunk: InFlightChunk, successor: Optional[InFlightChunk]):
        outs, schedule, _ = engine.harvest_schedule_chunk(chunk)
        t_done = time.time()
        if successor is not None:
            stats.host_gaps.append(successor.t_dispatch - t_done)
        sec = (t_done - chunk.t_dispatch) / chunk.n_rounds
        with span("fused.pipeline.consume", chunk.start_round):
            stop_pos = consume(outs, schedule, chunk.start_round,
                               chunk.n_rounds, sec, chunk.active)
        fired = fix_states(chunk, stop_pos, successor)
        for r in range(runs):
            if stop_pos[r] is not None:
                stopped[r] = True
        return fired

    while round_index < num_rounds and not stopped.all():
        k = min(chunk_size, num_rounds - round_index)
        active = ~stopped
        cur = engine.dispatch_schedule_chunk(
            round_index, k, active,
            agg_count=None if prev is None else prev.agg_count,
            snapshot=True)
        cur.active = active.copy()
        stats.chunks += 1
        if prev is not None and absorb(prev, cur):
            if stopped.all():
                return stats  # cur is discarded; the states are fixed
            # cur ran a stopped lane live (and, after a rewind, from the
            # states before the replay): dispatch it again with the same
            # selections and draws and the corrected lane mask
            active = ~stopped
            cur = engine.dispatch_schedule_chunk(
                cur.start_round, cur.n_rounds, active,
                schedule=cur.schedule, draws=cur.draws, snapshot=True)
            cur.active = active.copy()
            stats.redispatches += 1
        # the host counters are current through cur's predecessor now
        cur.entry_agg = engine.host_agg_count()
        prev = cur
        round_index += k
        if not pipelined:
            prev = None
            absorb(cur, None)
    if prev is not None:
        absorb(prev, None)
    return stats

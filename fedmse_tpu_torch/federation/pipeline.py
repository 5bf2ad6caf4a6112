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

On the card a fused chunk's dispatch returns once its last round's final
epoch is enqueued (the host reads each epoch's early-stop flag an epoch
behind the card, federation/fused.py), so the overlap is what the card
still has queued then: that epoch and the round's close.

`pipelined=False` is the serial chunk loop (the driver's
`--no-pipeline`): each chunk is harvested and absorbed before the next is
dispatched, with the same rewind.

`PipelineStats.host_gaps` records at each chunk boundary t_dispatch(k + 1)
- t_harvest_done(k), negative by construction when pipelined.
`run_pipelined_batched` and the tiered prefetch of the JAX module wait for
the batched and tiered engines.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

import numpy as np


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


@dataclasses.dataclass
class PipelineStats:
    """Per-run telemetry of the pipelined executor."""

    chunks: int = 0
    host_gaps: List[float] = dataclasses.field(default_factory=list)

    def summary(self) -> dict:
        gaps = self.host_gaps
        return {"chunks": self.chunks, "host_gap_s": gaps,
                "host_gap_mean_s": float(np.mean(gaps)) if gaps else None,
                # every next dispatch was enqueued before the previous
                # harvest completed
                "overlapped": bool(gaps) and all(g <= 0 for g in gaps)}


def run_pipelined_schedule(engine, start_round: int, num_rounds: int,
                           chunk_size: int,
                           consume: Callable[[list, float], Optional[int]],
                           can_rewind: bool = True,
                           pipelined: bool = True) -> PipelineStats:
    """Drive a RoundEngine's fused schedule in chunks, double-buffered
    unless `pipelined=False` (the serial chunk loop).

    `consume(results, sec_per_round)` absorbs one harvested chunk's
    RoundResults (logging, writer IO, early stop) and returns the 0-based
    position of the stop round inside the chunk, or None; when pipelined
    it runs while the next chunk is in flight. `can_rewind=False` promises
    it never stops, and no snapshot is taken."""
    stats = PipelineStats()
    prev: Optional[InFlightChunk] = None
    round_index = start_round

    def absorb(chunk: InFlightChunk,
               successor: Optional[InFlightChunk]) -> bool:
        results, schedule, draws = engine.harvest_schedule_chunk(chunk)
        t_done = time.time()
        if successor is not None:
            stats.host_gaps.append(successor.t_dispatch - t_done)
        sec = (t_done - chunk.t_dispatch) / chunk.n_rounds
        stop = consume(results, sec)
        if stop is None:
            return False
        done = stop + 1
        if done < chunk.n_rounds:
            # a mid-chunk stop: rewind to the chunk's entry and replay the
            # prefix with the same inputs
            engine.states = chunk.snap_states
            engine.host = chunk.host_snap
            for j in range(done):
                engine.run_round_fused(
                    chunk.start_round + j, selected=schedule[j],
                    draws=None if draws is None else draws[j])
        elif successor is not None:
            # a stop at the chunk's last round with the successor in
            # flight: its entry snapshot is the state after the stop
            engine.states = successor.snap_states
        return True

    while round_index < num_rounds:
        k = min(chunk_size, num_rounds - round_index)
        cur = engine.dispatch_schedule_chunk(
            round_index, k, agg_count=None if prev is None else prev.agg_count,
            snapshot=can_rewind)
        stats.chunks += 1
        round_index += k
        if prev is not None and absorb(prev, cur):
            return stats  # cur is speculative: never harvested
        if can_rewind:
            cur.host_snap = engine.host.copy()
        prev = cur
        if not pipelined:
            prev = None
            if absorb(cur, None):
                return stats
    if prev is not None:
        absorb(prev, None)
    return stats

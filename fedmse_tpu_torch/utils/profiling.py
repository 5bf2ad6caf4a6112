"""Tracing, device spans, the fused round's ledger and phase timing (port
of fedmse_tpu/utils/profiling.py).

  * `trace(log_dir)`  torch.profiler over the block, CPU and CUDA
                      activities, written to `log_dir` as a Chrome trace
                      (chrome://tracing or Perfetto): the program's spans
                      (`span`, every name `fused.*`) and the card's
                      kernels, copies and idle time on one clock;
  * `span(name, index)`  a program span, `record_function("name@index")`,
                      entered only while a profiler records: without one
                      it costs one flag check;
  * `DeviceSpan`      device time between two timing-enabled CUDA events
                      on the current stream, read only once the second
                      is complete: nothing waits for the card when it is
                      recorded;
  * `RoundLedger`     the fused round's flight recorder
                      (federation/fused.py): a marker event before and
                      after every body replay (`enter`, each `epoch`,
                      `leave`), resolved at the chunk's harvest, after its
                      wait, into per-round device ms and idle ms and the
                      train lanes replayed and active. Always on. The last
                      `CHUNKS_KEPT` chunks' records are `recent_chunks()`;
                      `ledger_window` sums those of a window;
  * `PhaseTimer`      seconds per named phase, accumulated across calls:
                      on a card each phase's device time (a `DeviceSpan`,
                      no synchronization), on the CPU its host time;
                      disabled it is a no-op.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import time
from collections import defaultdict
from typing import Deque, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import record_function

from fedmse_tpu_torch.device import DeviceLike


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile everything inside the block; the trace lands in
    `log_dir/trace.json` when the block ends. The program's `fused.*`
    spans are in it, beside the card's activity on the same clock."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


_OFF = contextlib.nullcontext()


def span(name: str, index: int):
    """The program span `name@index` (`index` the round's absolute index,
    or the chunk's first round) while a profiler records; else a null
    context. Names start with `fused.`: tools that read a trace tell the
    program's spans (and their mirrors on the card's timeline) from
    device work by that prefix."""
    if _profiler_enabled():
        return record_function(f"{name}@{index}")
    return _OFF


def _event(stream=None) -> torch.cuda.Event:
    event = torch.cuda.Event(enable_timing=True)
    event.record(stream)
    return event


class DeviceSpan:
    """Device time from `start` to `end`, two timing-enabled CUDA events
    recorded on one stream. `open` records the start on the device's
    current stream, `close` the end; `ms` reads the span once the end
    event is complete: after a wait that covers it (a harvest's), or the
    end event's own `synchronize()`."""

    __slots__ = ("start", "end")

    def __init__(self, start: torch.cuda.Event,
                 end: Optional[torch.cuda.Event] = None):
        self.start, self.end = start, end

    @classmethod
    def open(cls, device: DeviceLike = None) -> "DeviceSpan":
        return cls(_event(torch.cuda.current_stream(device)))

    def close(self, device: DeviceLike = None) -> "DeviceSpan":
        self.end = _event(torch.cuda.current_stream(device))
        return self

    def ms(self) -> float:
        return self.start.elapsed_time(self.end)


# ---- the fused round's ledger ---- #

# the chunks whose records recent_chunks() keeps: a 51-s window of 1-round
# chunks at ~100 ms a round is ~500
CHUNKS_KEPT = 1024
_CHUNKS: Deque[Dict] = collections.deque(maxlen=CHUNKS_KEPT)
_SEQ = itertools.count()

# a round record's device fields, in ms (None off a card)
ROUND_MS = ("enter_ms", "train_ms", "speculative_ms", "leave_ms",
            "idle_in_round_ms", "idle_round_edge_ms")


def recent_chunks() -> List[Dict]:
    """The ledger's records of the last CHUNKS_KEPT harvested chunks of
    every fused round in this process, oldest first. A chunk: `seq`, its
    `first_round` (absolute), `t_dispatch` and `t_harvest`
    (time.perf_counter() at its dispatch and at the end of its harvest),
    `edge_from` (the `seq` of the chunk dispatched before it on the same
    round, or None), `idle_chunk_edge_ms` (device ms from that chunk's
    last marker to this one's first: the output copy, the next uploads and
    what the card waited for the host), `span_ms` (first marker to last),
    and `rounds`, one record each: `round`, `epochs_run` (the epochs that
    trained), `epoch_replays` (with the speculative one), `lanes` (train
    lanes replayed: the launch width x epoch replays), `active_lanes`
    (lanes whose client was active: the `tracking` active column) and the
    device ms of ROUND_MS: `enter`, the trained epochs, the speculative
    epoch (0 when the round ran every epoch), `leave`, the idle before
    each epoch and before `leave`, and the idle since the previous round's
    `leave` (0 for a chunk's first round: its edge is the chunk's). Off a
    card the device fields are None and the counts are kept."""
    return list(_CHUNKS)


class ChunkRecord:
    """One chunk's markers as its rounds are dispatched (RoundLedger.open),
    resolved by `close` at its harvest."""

    def __init__(self, ledger: "RoundLedger", first_round: int,
                 width: int):
        self.ledger, self.first_round, self.width = ledger, first_round, \
            width
        self.seq = next(_SEQ)
        self.edge_from, self.prev = ledger.last
        self.stream = torch.cuda.current_stream() if ledger.cuda else None
        self.t_dispatch = time.perf_counter()
        # per round: [bodies [(name, DeviceSpan | None)], epochs trained]
        self.rounds: List[list] = []
        self.taken: List[torch.cuda.Event] = []

    def marker(self) -> Optional[torch.cuda.Event]:
        """A timing event recorded on the current stream now (a pooled
        one), or None off a card."""
        if not self.ledger.cuda:
            return None
        pool = self.ledger.pool
        event = pool.pop() if pool else torch.cuda.Event(enable_timing=True)
        event.record(self.stream)
        self.taken.append(event)
        return event

    def body(self, name: str, start, end) -> None:
        if name == "enter":
            self.rounds.append([[], 0])
        self.rounds[-1][0].append(
            (name, None if start is None else DeviceSpan(start, end)))

    def trained(self, epochs: int) -> None:
        self.rounds[-1][1] = epochs

    def sealed(self) -> None:
        """Every round dispatched: the last marker is the next chunk's
        edge."""
        last = self.rounds[-1][0][-1][1] if self.rounds else None
        self.ledger.last = (self.seq, None if last is None else last.end)

    def close(self, active_lanes: Sequence[int]) -> Dict:
        """Resolve the markers (all complete: the caller waited for the
        chunk's outputs, recorded after them), keep the record and give
        the events back to the pool but the last, which the next chunk
        reads."""
        cuda = self.ledger.cuda
        out, prev_end = [], None
        for (bodies, ran), active in zip(self.rounds, active_lanes):
            epochs = [s for name, s in bodies if name == "epoch"]
            rec = {"round": self.first_round + len(out),
                   "epochs_run": ran, "epoch_replays": len(epochs),
                   "lanes": self.width * len(epochs),
                   "active_lanes": int(active)}
            if cuda:
                ms = [s.ms() for s in epochs]
                spans = [s for _, s in bodies]
                rec.update(
                    enter_ms=spans[0].ms(), train_ms=sum(ms[:ran]),
                    speculative_ms=sum(ms[ran:]), leave_ms=spans[-1].ms(),
                    idle_in_round_ms=sum(
                        DeviceSpan(a.end, b.start).ms()
                        for a, b in zip(spans, spans[1:])),
                    idle_round_edge_ms=0.0 if prev_end is None else
                    DeviceSpan(prev_end, spans[0].start).ms())
                prev_end = spans[-1].end
            else:
                rec.update(dict.fromkeys(ROUND_MS))
            out.append(rec)
        first = self.rounds[0][0][0][1] if cuda and self.rounds else None
        record = {"seq": self.seq, "first_round": self.first_round,
                  "t_dispatch": self.t_dispatch, "t_harvest": None,
                  "edge_from": self.edge_from,
                  "idle_chunk_edge_ms": None, "span_ms": None,
                  "rounds": out}
        if first is not None:
            record["span_ms"] = DeviceSpan(first.start, prev_end).ms()
            if self.prev is not None:
                record["idle_chunk_edge_ms"] = DeviceSpan(
                    self.prev, first.start).ms()
        self.ledger.pool.extend(e for e in self.taken if e is not prev_end)
        self.taken = []
        record["t_harvest"] = time.perf_counter()
        _CHUNKS.append(record)
        return record


class RoundLedger:
    """A fused round's ledger: the pool of marker events its chunks reuse
    (an event goes back once its chunk is resolved) and the last marker
    of the chunk dispatched last, where the next chunk's edge starts."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.pool: List[torch.cuda.Event] = []
        self.last: Tuple[Optional[int], Optional[torch.cuda.Event]] = (
            None, None)

    def open(self, first_round: int, width: int) -> ChunkRecord:
        """The record of a chunk dispatched now, starting at the absolute
        round `first_round`, its train launches `width` lanes wide."""
        return ChunkRecord(self, first_round, width)


def ledger_window(t_open: float, seconds: float,
                  chunks: Optional[List[Dict]] = None) -> Optional[Dict]:
    """Sums over the chunks (default: recent_chunks()) dispatched at or
    after `t_open` and harvested by `t_open + seconds`: `rounds`, `lanes`,
    `active_lanes`, the rounds' ROUND_MS and `idle_chunk_edge_ms` over the
    edges between two of those chunks. None when no chunk is in the window
    or its records hold no device time (no card)."""
    chunks = recent_chunks() if chunks is None else chunks
    inside = [c for c in chunks if c["t_dispatch"] >= t_open
              and c["t_harvest"] <= t_open + seconds]
    rounds = [r for c in inside for r in c["rounds"]]
    if not rounds or any(r["train_ms"] is None for r in rounds):
        return None
    seqs = {c["seq"] for c in inside}
    out = {k: sum(r[k] for r in rounds)
           for k in ROUND_MS + ("lanes", "active_lanes")}
    out["rounds"] = len(rounds)
    out["idle_chunk_edge_ms"] = sum(
        c["idle_chunk_edge_ms"] for c in inside
        if c["edge_from"] in seqs and c["idle_chunk_edge_ms"] is not None)
    return out


# ---- phase timing ---- #

class PhaseTimer:
    """Seconds per named phase; `timings()` returns them. `device` is the
    card whose current stream a phase's device span is recorded on (None
    or a CPU device: the host clock). Nothing synchronizes the card: the
    phases' device spans are read at the next `timings()`, which waits
    for the last one's end event (the card has nearly always reached it:
    the per-phase round reads its results on the host before)."""

    def __init__(self, enabled: bool = False,
                 device: Optional[DeviceLike] = None):
        self.enabled = enabled
        self.device = None if device is None else torch.device(device)
        self._acc: Dict[str, float] = defaultdict(float)
        self._spans: List[Tuple[str, DeviceSpan]] = []

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        if self.device is not None and self.device.type == "cuda":
            s = DeviceSpan.open(self.device)
            try:
                yield
            finally:
                self._spans.append((name, s.close(self.device)))
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name] += time.perf_counter() - t0

    def timings(self) -> Dict[str, float]:
        if self._spans:  # one stream: the last end is the last to finish
            self._spans[-1][1].end.synchronize()
        for name, s in self._spans:
            self._acc[name] += s.ms() / 1e3
        self._spans.clear()
        return dict(self._acc)

    def reset(self) -> None:
        self._acc.clear()
        self._spans.clear()

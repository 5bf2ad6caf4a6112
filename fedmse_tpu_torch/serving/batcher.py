"""Host-side dynamic micro-batcher in front of the bucketed engine (a
numpy-only copy of fedmse_tpu/serving/batcher.py).

Live traffic arrives one row at a time; the engine wants full buckets (a
launch costs more than the marginal compute at this model size). The
batcher accumulates submitted rows until `max_batch` rows are pending or
the oldest pending row has waited `max_wait_ms`, then pads the batch up to
the engine's next bucket and dispatches once — the classic
throughput/latency knob pair.

Single-threaded by design: `submit()` checks the flush condition inline
and time-based flushes happen on the next `submit()`/`poll()` call, so
behavior is deterministic and testable (the clock is injectable). A
serving loop that may go idle should call `poll()` on its idle ticks.

Accounting: per-request latency (enqueue -> scored) percentiles
p50/p95/p99, rows/sec (both wall-clock and engine-service based), and a
per-dispatch batch-size trace. Latency/batch traces are bounded ring
buffers (`stats_window` samples) so a long-lived server's accounting
stays O(1) in memory: percentiles describe the most recent window,
totals (rows, dispatches, service time) are exact lifetime counters.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List, Optional

import numpy as np


class Ticket:
    """One submitted row's result slot (filled at flush time)."""

    __slots__ = ("score", "verdict", "done", "latency_s")

    def __init__(self):
        self.score: Optional[float] = None
        self.verdict: Optional[bool] = None
        self.done: bool = False
        self.latency_s: Optional[float] = None


class MicroBatcher:
    """Accumulate rows until max_batch or max_wait_ms, then dispatch.

    `calibration` (optional) turns scores into verdicts on the way out;
    `drift` (optional, anything with `update(scores, gateway_ids)`, such as
    drift.DriftMonitor) absorbs every served batch.
    """

    def __init__(self, engine, max_batch: int = 1024,
                 max_wait_ms: float = 5.0, calibration=None, drift=None,
                 clock: Callable[[], float] = time.perf_counter,
                 stats_window: int = 100_000):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_batch > engine.max_bucket:
            raise ValueError(f"max_batch {max_batch} exceeds the engine's "
                             f"max_bucket {engine.max_bucket}")
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self.calibration = calibration
        self.drift = drift
        self.clock = clock
        self._rows: List[np.ndarray] = []
        self._gateways: List[int] = []
        self._enqueued_at: List[float] = []
        self._tickets: List[Ticket] = []
        # accounting: bounded windows + exact lifetime totals. The three
        # per-row deques (latency, enqueue time, result time) share one
        # maxlen so every windowed stat describes the SAME most-recent rows
        self._latencies: collections.deque = collections.deque(
            maxlen=stats_window)
        self._win_enqueued: collections.deque = collections.deque(
            maxlen=stats_window)
        self._win_resulted: collections.deque = collections.deque(
            maxlen=stats_window)
        self.rows_served = 0
        self.dispatch_count = 0
        self.dispatch_batch_sizes: collections.deque = collections.deque(
            maxlen=stats_window)
        self.service_s = 0.0   # time inside engine.score
        self._first_submit: Optional[float] = None
        self._last_result: Optional[float] = None

    # ----------------------------- intake ------------------------------- #

    def submit(self, x, gateway_id: int = 0) -> Ticket:
        """Enqueue one row; returns its Ticket (filled at flush)."""
        now = self.clock()
        if self._first_submit is None:
            self._first_submit = now
        # a due time-based flush fires BEFORE enqueueing, so the new row
        # starts a fresh window instead of riding the expired one
        if self._rows and now - self._enqueued_at[0] >= self.max_wait_s:
            self.flush()
        ticket = Ticket()
        self._rows.append(np.asarray(x, np.float32))
        self._gateways.append(int(gateway_id))
        self._enqueued_at.append(now)
        self._tickets.append(ticket)
        if len(self._rows) >= self.max_batch:
            self.flush()
        return ticket

    def poll(self) -> bool:
        """Flush if the oldest pending row's wait expired; returns whether
        a dispatch happened (serving loops call this on idle ticks)."""
        if self._rows and self.clock() - self._enqueued_at[0] >= self.max_wait_s:
            self.flush()
            return True
        return False

    # ----------------------------- dispatch ------------------------------ #

    def flush(self) -> int:
        """Dispatch everything pending (one engine call, padded to the
        bucket); returns the number of rows served."""
        if not self._rows:
            return 0
        rows = np.stack(self._rows, axis=0)
        gws = np.asarray(self._gateways, np.int32)
        tickets, enq = self._tickets, self._enqueued_at
        self._rows, self._gateways = [], []
        self._enqueued_at, self._tickets = [], []

        t0 = self.clock()
        scores = self.engine.score(rows, gws)
        t1 = self.clock()
        self.service_s += t1 - t0
        verdicts = (self.calibration.verdicts(scores, gws)
                    if self.calibration is not None else None)
        if self.drift is not None:
            self.drift.update(scores, gws)
        for i, tk in enumerate(tickets):
            tk.score = float(scores[i])
            if verdicts is not None:
                tk.verdict = bool(verdicts[i])
            tk.latency_s = t1 - enq[i]
            tk.done = True
            self._latencies.append(tk.latency_s)
            self._win_enqueued.append(enq[i])
            self._win_resulted.append(t1)
        self.rows_served += len(tickets)
        self.dispatch_count += 1
        self.dispatch_batch_sizes.append(len(tickets))
        self._last_result = t1
        return len(tickets)

    def drain(self) -> int:
        """Flush the tail regardless of batch/wait state (shutdown path)."""
        return self.flush()

    # ---------------------------- accounting ----------------------------- #

    def stats(self) -> Dict:
        lat = np.asarray(self._latencies)
        # rows_per_sec_wall is WINDOWED, matching the latency percentiles:
        # rows in the current window over the span that produced them
        # (first enqueue in the window -> last result); the lifetime rate
        # rides along under the _lifetime key for long-horizon accounting.
        win_wall = ((self._win_resulted[-1] - self._win_enqueued[0])
                    if self._win_resulted else 0.0)
        life_wall = ((self._last_result - self._first_submit)
                     if self._latencies else 0.0)
        p = (lambda q: float(np.percentile(lat, q) * 1000.0)) if len(lat) \
            else (lambda q: None)
        return {
            "rows_served": self.rows_served,
            "dispatches": self.dispatch_count,
            "mean_batch": (self.rows_served / self.dispatch_count
                           if self.dispatch_count else None),
            "max_batch": self.max_batch,
            "max_wait_ms": self.max_wait_s * 1000.0,
            "latency_p50_ms": p(50), "latency_p95_ms": p(95),
            "latency_p99_ms": p(99),
            "rows_per_sec_wall": (len(self._win_resulted) / win_wall
                                  if win_wall > 0 else None),
            "rows_per_sec_wall_lifetime": (self.rows_served / life_wall
                                           if life_wall > 0 else None),
            "rows_per_sec_service": (self.rows_served / self.service_s
                                     if self.service_s > 0 else None),
            "service_s": self.service_s,
        }

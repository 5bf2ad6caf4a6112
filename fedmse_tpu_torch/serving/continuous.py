"""Continuous-batching serving front: double-buffered dispatch + hot swap
(port of fedmse_tpu/serving/continuous.py).

The MicroBatcher (batcher.py) waits, flushes, BLOCKS on the scores, fills
its tickets and only then accumulates again, so the card idles while the
host accumulates and the host idles while the card scores. This front
overlaps the two halves:

  * **Forming / in-flight double buffer.** Rows are admitted into the
    *forming* bucket while the *in-flight* bucket is still on the card.
    `flush()` dispatches batch k+1 (`engine.dispatch`: the launch and a
    non-blocking copy of the scores into pinned host memory behind a CUDA
    event) BEFORE harvesting batch k, so the host's intake, verdict and
    drift work for one batch runs while the card scores the next.
  * **O(1)-per-batch harvest.** Tickets resolve lazily out of their
    batch's score / verdict / latency ARRAYS (a `StreamTicket` is a record
    pointer and a row index), so harvesting a bucket is a handful of
    vectorized numpy ops, not one Python attribute write per row.
  * **Adaptive bucket pick.** Each forming window targets the largest
    power-of-two bucket the CURRENT arrival rate (an EMA of rows/s) fills
    within the latency budget: slow traffic dispatches small buckets at
    the budget deadline, saturating traffic ramps to `max_batch`.
  * **Drift-triggered hot swap.** `swap()` installs recalibrated
    thresholds, a newer checkpoint or a refreshed kNN bank between
    dispatches with zero dropped or re-scored tickets: the engine hands
    its state dict to each launch as an operand (engine.py), so a swap is
    one rebind; batches in flight keep the state and the calibration
    snapshot they were dispatched with. `DriftMonitor.report()
    ["swap_recommended_gateways"]` is the intended trigger.

Single-threaded by design, like the MicroBatcher: `submit()` checks the
flush condition inline, time-based flushes happen on the next
`submit()`/`poll()`, and `poll()` also harvests a ready in-flight batch.
The clock is injectable, so behavior is deterministic and testable. The
flywheel's `intake=` tap (flywheel/buffer.py `FlywheelBuffer.tap`) sees each
harvested batch's rows, gateways, scores and verdicts in one call.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from fedmse_tpu_torch.serving.engine import UnknownGatewayError


class BatchRecord:
    """One batch's shared result arrays (filled at harvest time)."""

    __slots__ = ("pend", "enq", "gws", "calibration", "drift", "n", "done",
                 "scores", "verdicts", "lat", "rows", "intake")

    def __init__(self):
        self.pend = None          # PendingScores once dispatched
        self.enq = None           # [n] enqueue times
        self.gws = None           # [n] int32 gateway ids
        self.calibration = None   # calibration snapshot at dispatch
        self.drift = None         # drift sink snapshot at dispatch
        self.n = 0
        self.done = False
        self.scores = None        # [n] f32, at harvest
        self.verdicts = None      # [n] bool or None
        self.lat = None           # [n] seconds, at harvest
        self.rows = None          # [n, D] f32, kept only for an intake
        self.intake = None        # intake snapshot at dispatch


class StreamTicket(tuple):
    """One submitted row's handle: resolves score/verdict/latency out of
    its batch record's arrays (O(1)-per-batch harvest — no per-row fill
    loop on the hot path). API-compatible with batcher.Ticket.

    A tuple subclass of (record, row_index) so the submit hot path can
    construct it with C-level `tuple.__new__` instead of a Python
    `__init__` per row."""

    __slots__ = ()

    def __new__(cls, rec: BatchRecord, idx: int):
        return tuple.__new__(cls, (rec, idx))

    @property
    def done(self) -> bool:
        return self[0].done

    @property
    def score(self) -> Optional[float]:
        rec = self[0]
        return float(rec.scores[self[1]]) if rec.done else None

    @property
    def verdict(self) -> Optional[bool]:
        rec = self[0]
        if not rec.done or rec.verdicts is None:
            return None
        return bool(rec.verdicts[self[1]])

    @property
    def latency_s(self) -> Optional[float]:
        rec = self[0]
        return float(rec.lat[self[1]]) if rec.done else None


_new_ticket = tuple.__new__  # module-level: dodge two attr lookups/row


def _assemble(buf):
    """Forming buffer -> (rows [n, D] f32, gateways [n] i32, enqueued [n])
    for a window that mixes per-row tuples and _Block burst slices, in
    submission order."""
    row_parts, gw_parts, t_parts = [], [], []
    singles: list = []

    def drain_singles():
        xs, gs, ts = zip(*singles)
        row_parts.append(np.asarray(xs, np.float32))
        gw_parts.append(np.asarray(gs, np.int32))
        t_parts.append(np.asarray(ts))
        singles.clear()

    for e in buf:
        if type(e) is tuple:
            singles.append(e)
        else:
            if singles:
                drain_singles()
            row_parts.append(e.xs)
            gw_parts.append(e.gws)
            t_parts.append(np.full(len(e.gws), e.t))
    if singles:
        drain_singles()
    if len(row_parts) == 1:
        return row_parts[0], gw_parts[0], t_parts[0]
    return (np.concatenate(row_parts), np.concatenate(gw_parts),
            np.concatenate(t_parts))


class _Block:
    """One burst's forming-buffer entry: a contiguous slice of rows that
    arrived together (submit_many). Stored as ARRAYS, not per-row tuples,
    so burst intake is O(1) python work per burst."""

    __slots__ = ("xs", "gws", "t")

    def __init__(self, xs, gws, t):
        self.xs = xs
        self.gws = gws
        self.t = t


class TicketBlock:
    """Lazy ticket sequence for one burst (submit_many's return).

    Holds (record, base, n) segments — a burst can span window
    boundaries — and materializes StreamTickets only on access, so
    admitting a burst costs O(segments), not O(rows). `done` /
    `scores` / `verdicts` / `latencies_s` give the vectorized view."""

    __slots__ = ("_segs",)

    def __init__(self, segs):
        self._segs = segs

    def __len__(self) -> int:
        return sum(n for _, _, n in self._segs)

    def __iter__(self):
        for rec, base, n in self._segs:
            for i in range(n):
                yield _new_ticket(StreamTicket, (rec, base + i))

    def __getitem__(self, i: int) -> StreamTicket:
        if i < 0:
            i += len(self)
        if i < 0:  # still negative: would silently index a wrong row
            raise IndexError("ticket index out of range")
        for rec, base, n in self._segs:
            if i < n:
                return _new_ticket(StreamTicket, (rec, base + i))
            i -= n
        raise IndexError("ticket index out of range")

    @property
    def done(self) -> bool:
        return all(rec.done for rec, _, _ in self._segs)

    @property
    def scores(self):
        """float32 [len] scores in submission order (None until done)."""
        if not self.done:
            return None
        parts = [rec.scores[base:base + n] for rec, base, n in self._segs]
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    @property
    def verdicts(self):
        if not self.done or any(rec.verdicts is None
                                for rec, _, _ in self._segs):
            return None
        parts = [rec.verdicts[base:base + n] for rec, base, n in self._segs]
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    @property
    def latencies_s(self):
        if not self.done:
            return None
        parts = [rec.lat[base:base + n] for rec, base, n in self._segs]
        return parts[0] if len(parts) == 1 else np.concatenate(parts)


class ContinuousBatcher:
    """Continuous-batching front over a ServingEngine.

    Parameters mirror MicroBatcher where they overlap; `latency_budget_ms`
    replaces `max_wait_ms` (it bounds the forming window AND steers the
    adaptive bucket pick). `calibration`/`drift` are absorbed per harvested
    batch exactly like the sync batcher. `stats_window` bounds the latency
    window (percentiles and the windowed wall throughput describe the most
    recent ~stats_window rows; totals are exact lifetime counters).

    `intake` is the flywheel's admission tap (flywheel/): a callable
    `(rows, gateway_ids, scores, verdicts)` called ONCE per harvested batch
    with that batch's arrays, after its verdicts and drift update: O(1)
    Python work per batch, downstream of the dispatch. With an intake
    installed a batch keeps its rows from dispatch to harvest (then drops
    them), and the intake is snapshotted at dispatch like the calibration;
    with None nothing is kept and the front is byte for byte the
    intake-free one.
    """

    def __init__(self, engine, max_batch: int = 1024,
                 latency_budget_ms: float = 5.0, calibration=None,
                 drift=None, clock: Callable[[], float] = time.perf_counter,
                 stats_window: int = 100_000, intake=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_batch > engine.max_bucket:
            raise ValueError(f"max_batch {max_batch} exceeds the engine's "
                             f"max_bucket {engine.max_bucket}")
        self.engine = engine
        self.intake = intake
        self.max_batch = max_batch
        self.budget_s = latency_budget_ms / 1000.0
        self.calibration = calibration
        self.drift = drift
        self.clock = clock
        self.stats_window = stats_window
        # forming bucket (host side), packed into ONE six-slot list the
        # submit closure indexes at C speed: [buf, window_first_enqueue,
        # record, target_bucket, row_count, has_blocks]. buf entries are
        # (row, gateway, enqueued) tuples (submit) or _Block burst slices
        # (submit_many); row_count tracks ROWS (not entries) so tickets
        # index correctly across mixed granularity. The intake state is
        # cell/index-addressed to keep attribute loads off the per-row
        # path; see _bind_submit.
        self._hot: list = [[], 0.0, None, max_batch, 0, False]
        # in-flight bucket (device side)
        self._inflight: Optional[BatchRecord] = None
        # arrival-rate EMA (rows/sec) steering the adaptive bucket pick
        self._rate: Optional[float] = None
        # accounting: exact lifetime totals + bounded windows
        # (rows_submitted is DERIVED — see the property — to keep the
        # per-row submit path counter-free)
        self.rows_served = 0
        self.dispatch_count = 0
        self.dispatch_batch_sizes: collections.deque = collections.deque(
            maxlen=stats_window)
        self.host_blocked_s = 0.0  # time the host waited in harvest
        self.swaps: List[Dict] = []
        self._lat_chunks: collections.deque = collections.deque()
        self._lat_total = 0
        # per-batch (first_enqueue, done, rows), pruned in lockstep with
        # _lat_chunks so the windowed wall rate covers the same recent
        # ~stats_window rows the percentiles do
        self._window: collections.deque = collections.deque()
        self._first_submit: Optional[float] = None
        self._last_result: Optional[float] = None
        # the submit hot path is BUILT per instance with its state in
        # closure cells (self.submit shadows any class-level attribute)
        self.submit = self._bind_submit()

    # ------------------------------ intake ------------------------------- #

    def _bind_submit(self):
        """Build the per-row intake hot path as a closure.

        submit() runs once per row, so every attribute load on it counts.
        Everything the path touches is bound once: immutable knobs (clock,
        budget) as closure cells, the mutable window state as C-indexed
        slots of the `_hot` list, the ticket as a tuple-subclass
        constructed via `tuple.__new__`.
        Consequence: `clock` and `budget_s` are fixed at construction —
        mutating them afterwards does not reach the bound hot path."""
        hot = self._hot
        clock = self.clock
        budget = self.budget_s
        start_window = self._start_window
        flush = self.flush
        new, ticket = _new_ticket, StreamTicket
        # roster validation at INTAKE, not dispatch: a retired-slot row
        # admitted into the forming bucket would poison the whole batch's
        # dispatch later — reject it before it joins the window. The
        # roster is read LIVE from the engine (one attribute load per row,
        # like submit_many): a roster installed directly via
        # ServingEngine.swap_state(roster=...) — the documented hot-swap
        # path — must reach intake even when the caller never touches
        # ContinuousBatcher.swap.
        engine = self.engine
        unknown = UnknownGatewayError

        def submit(x, gateway_id: int = 0) -> StreamTicket:
            """Admit one row into the forming bucket; returns its ticket.

            The ticket completes when its batch is HARVESTED — one flush
            later than the sync batcher (the in-flight batch is harvested
            right after its successor dispatches), or on
            `poll()`/`drain()`."""
            roster = getattr(engine, "roster", None)
            if roster is not None and not roster.member[gateway_id]:
                raise unknown(
                    f"UNKNOWN_GATEWAY: gateway slot {gateway_id} is "
                    f"retired; swap in an updated roster if it was "
                    f"recycled (ContinuousBatcher.swap(roster=...))")
            now = clock()
            buf = hot[0]
            if buf:
                # a due time-based flush fires BEFORE enqueueing, so the
                # new row starts a fresh window, not the expired one
                if now - hot[1] >= budget:
                    flush()
                    buf = hot[0]
            if not buf:
                start_window(now)
                buf = hot[0]
            idx = hot[4]
            hot[4] = idx + 1
            tk = new(ticket, (hot[2], idx))
            buf.append((x, gateway_id, now))
            if idx + 1 >= hot[3]:
                flush()
            return tk

        return submit

    def submit_many(self, xs, gateway_ids) -> TicketBlock:
        """Burst admission: O(1) python work per burst for a block of
        rows that arrived together (the NIC-poll shape real gateway
        traffic has — a socket read hands the front tens of rows, not
        one). Semantically identical to submitting each row at the same
        instant; the burst lands in the forming buffer as contiguous
        array slices (_Block) and the returned TicketBlock materializes
        per-row tickets lazily, so burst intake stays off the per-row
        python path entirely."""
        xs_in, gw_in = xs, gateway_ids
        xs = np.asarray(xs, np.float32)
        if xs is xs_in:
            # detach from the caller's buffer: the burst sits in the
            # forming window as SLICES until the flush, and the NIC-poll
            # caller this path exists for reuses its read buffer — an
            # aliased view would silently score later bytes
            xs = xs.copy()
        if xs.ndim == 1:
            xs = xs[None, :]
        n = xs.shape[0]
        gw = np.asarray(gateway_ids, np.int32)
        if gw.shape != (n,):
            gw = np.broadcast_to(gw, (n,)).copy()
        elif gw is gw_in:
            gw = gw.copy()  # same aliasing hazard as the rows
        roster = getattr(self.engine, "roster", None)
        if roster is not None and n:
            bad = ~roster.member[gw]
            if bad.any():
                # reject the burst BEFORE any row is admitted: a partial
                # admit would leave the caller holding tickets for half
                # its rows (same intake-validation rule as submit)
                slots = sorted(set(int(g) for g in gw[bad]))
                raise UnknownGatewayError(
                    f"UNKNOWN_GATEWAY: burst routes rows to retired "
                    f"gateway slot(s) {slots[:5]}"
                    f"{'...' if len(slots) > 5 else ''}; swap in an "
                    f"updated roster if they were recycled")
        now = self.clock()
        hot = self._hot
        segs = []
        start = 0
        while start < n:
            buf = hot[0]
            if buf and now - hot[1] >= self.budget_s:
                self.flush()
                buf = hot[0]
            if not buf:
                self._start_window(now)
                buf = hot[0]
            base = hot[4]
            take = min(n - start, hot[3] - base)
            stop = start + take
            buf.append(_Block(xs[start:stop], gw[start:stop], now))
            hot[4] = base + take
            hot[5] = True
            segs.append((hot[2], base, take))
            if base + take >= hot[3]:
                self.flush()
            start = stop
        return TicketBlock(segs)

    def poll(self) -> bool:
        """Idle tick: flush an expired forming window and/or harvest a
        ready in-flight batch; returns whether either happened."""
        did = False
        hot = self._hot
        if hot[0] and self.clock() - hot[1] >= self.budget_s:
            self.flush()
            did = True
        if self._inflight is not None and self._inflight.pend.is_ready():
            rec, self._inflight = self._inflight, None
            self._harvest(rec)
            did = True
        return did

    # ----------------------- dispatch / harvest -------------------------- #

    def flush(self) -> int:
        """Dispatch the forming bucket, THEN harvest its predecessor —
        the double-buffer step: while the device scores the batch just
        dispatched, the host fills the previous batch's tickets. Returns
        the number of rows dispatched."""
        hot = self._hot
        buf = hot[0]
        if not buf:
            return 0
        rec = hot[2]
        if not hot[5]:  # pure per-row window: one zip, three conversions
            xs, gs, ts = zip(*buf)
            rows = np.asarray(xs, np.float32)
            rec.gws = np.asarray(gs, np.int32)
            rec.enq = np.asarray(ts)
        else:
            rows, rec.gws, rec.enq = _assemble(buf)
        rec.n = rows.shape[0]
        rec.calibration = self.calibration  # verdict snapshot at dispatch
        rec.drift = self.drift              # drift sink for THIS regime
        if self.intake is not None:
            # the tap needs the batch's rows at harvest: keep them only
            # while an intake is installed, snapshotted with it
            rec.rows = rows
            rec.intake = self.intake
        hot[0], hot[2], hot[4], hot[5] = [], None, 0, False
        t0 = self.clock()
        rec.pend = self.engine.dispatch(rows, rec.gws)
        # arrival-rate EMA over the window just closed (intake only — the
        # dispatch itself is not arrival time)
        span = t0 - float(rec.enq[0])
        if span > 0:
            inst = rec.n / span
            self._rate = (inst if self._rate is None
                          else 0.5 * self._rate + 0.5 * inst)
        prev, self._inflight = self._inflight, rec
        if prev is not None:
            self._harvest(prev)
        return rec.n

    def drain(self) -> int:
        """Flush the forming tail and harvest everything in flight
        (shutdown path); returns the rows flushed."""
        n = self.flush()
        if self._inflight is not None:
            rec, self._inflight = self._inflight, None
            self._harvest(rec)
        return n

    def _start_window(self, now: float) -> None:
        if self._first_submit is None:
            self._first_submit = now
        hot = self._hot
        hot[1] = now
        hot[2] = BatchRecord()
        hot[3] = self._pick_bucket()
        hot[4] = 0
        hot[5] = False

    def _pick_bucket(self) -> int:
        """Largest power-of-two bucket the current arrival rate fills
        within the latency budget (clamped to [1, max_batch]); until a
        rate is observed, aim for max_batch and let the budget-expiry
        flush right-size the first window."""
        if self._rate is None:
            return self.max_batch
        expected = self._rate * self.budget_s
        b = 1
        while (b << 1) <= expected and (b << 1) <= self.max_batch:
            b <<= 1
        return b

    def _harvest(self, rec: BatchRecord) -> None:
        t0 = self.clock()
        scores = rec.pend.harvest()
        t1 = self.clock()
        self.host_blocked_s += t1 - t0
        rec.scores = scores
        if rec.calibration is not None:
            rec.verdicts = rec.calibration.verdicts(scores, rec.gws)
        if rec.drift is not None:
            # the record's OWN drift snapshot: a calibration swap
            # rebaselines the monitor and detaches the in-flight batch
            # (swap()), so scores produced under the old regime never
            # seed the new baseline's moments
            rec.drift.update(scores, rec.gws)
        if rec.intake is not None:
            # one vectorized call per batch, then the rows are released
            rec.intake(rec.rows, rec.gws, scores, rec.verdicts)
            rec.rows = rec.intake = None
        rec.lat = t1 - rec.enq
        rec.done = True
        self.rows_served += rec.n
        self.dispatch_count += 1
        self.dispatch_batch_sizes.append(rec.n)
        self._lat_chunks.append(rec.lat)
        self._window.append((float(rec.enq[0]), t1, rec.n))
        self._lat_total += rec.n
        while (self._lat_chunks
               and self._lat_total - len(self._lat_chunks[0])
               >= self.stats_window):
            self._lat_total -= len(self._lat_chunks.popleft())
            self._window.popleft()
        self._last_result = t1

    # ----------------------------- hot swap ------------------------------ #

    def swap(self, *, params=None, centroids=None, banks=None,
             calibration=None, roster=None) -> Dict:
        """Atomically install new serving state between dispatches.

        `params` (a newer checkpoint's stacked tree), `centroids`, and
        `banks` (a refreshed kNN bank — knn.build_banks(existing=...))
        swap through `engine.swap_state` (one rebind, engine.py);
        `calibration` replaces the threshold set used for every batch
        dispatched from now on AND rebaselines the drift monitor (its
        streaming moments restart against the new reference). `roster`
        (a ServingRoster) propagates an elastic federation's membership
        change — joined slots admit traffic again, left slots start
        rejecting at intake with UNKNOWN_GATEWAY; pair it with the
        recycled slots' params/banks/calibration rows in the SAME call so
        a re-tenanted slot never serves its predecessor's model. Batches
        already dispatched keep the state/calibration they captured, so
        every in-flight ticket is scored exactly once under the regime
        that admitted it: zero drops, zero re-scores. Returns the swap
        event (also appended to `self.swaps`)."""
        kinds: List[str] = []
        roster_delta = None
        if roster is not None:
            # membership changes are ADMISSION-boundary events: rows in
            # the forming bucket were validated under the outgoing roster,
            # so they must dispatch under it (engine.dispatch re-validates
            # at flush) — close their batch before the roster flips. The
            # other swap kinds keep the existing boundary (forming rows
            # score under the incoming state).
            self.flush()
        if params is not None or centroids is not None or banks is not None \
                or roster is not None:
            info = self.engine.swap_state(params=params, centroids=centroids,
                                          banks=banks, roster=roster)
            kinds.extend(info["swapped"])
            roster_delta = info.get("roster_delta")
            # intake reads the roster live from the engine, so the new
            # roster takes effect at the very next submit with no rebind
            # (in-flight batches are untouched: their rows were validated
            # under the roster that admitted them)
        if calibration is not None:
            if calibration.num_gateways != self.engine.num_gateways:
                raise ValueError(
                    f"swap calibration covers {calibration.num_gateways} "
                    f"gateways, engine serves {self.engine.num_gateways}")
            self.calibration = calibration
            if self.drift is not None:
                self.drift.rebaseline(calibration)
                if self._inflight is not None:
                    # the in-flight batch was dispatched under the OLD
                    # regime; absorbing its scores into the just-reset
                    # monitor would seed the new baseline with old-
                    # distribution traffic (and could re-recommend the
                    # very swap that just happened)
                    self._inflight.drift = None
            kinds.append("thresholds")
        if not kinds:
            raise ValueError("swap: nothing to swap")
        event = {
            "kinds": kinds,
            "at_rows_submitted": self.rows_submitted,
            "at_dispatches": self.dispatch_count,
        }
        if roster_delta is not None:
            event["roster_delta"] = roster_delta
        self.swaps.append(event)
        return event

    # ---------------------------- accounting ----------------------------- #

    @property
    def forming_rows(self) -> int:
        return self._hot[4]

    @property
    def in_flight_rows(self) -> int:
        return self._inflight.n if self._inflight is not None else 0

    @property
    def rows_submitted(self) -> int:
        return self.rows_served + self.in_flight_rows + self.forming_rows

    def stats(self) -> Dict:
        lat = (np.concatenate(self._lat_chunks) if self._lat_chunks
               else np.empty(0))
        p = (lambda q: float(np.percentile(lat, q) * 1000.0)) if len(lat) \
            else (lambda q: None)
        # windowed wall: recent rows over the span that produced them
        # (same convention as MicroBatcher.stats after the windowed-wall
        # fix: first enqueue in the window -> last result)
        win_rows = sum(n for _, _, n in self._window)
        win_wall = ((self._window[-1][1] - self._window[0][0])
                    if self._window else 0.0)
        life_wall = ((self._last_result - self._first_submit)
                     if self._last_result is not None else 0.0)
        return {
            "front": "continuous",
            "rows_submitted": self.rows_submitted,
            "rows_served": self.rows_served,
            "dispatches": self.dispatch_count,
            "mean_batch": (self.rows_served / self.dispatch_count
                           if self.dispatch_count else None),
            "max_batch": self.max_batch,
            "latency_budget_ms": self.budget_s * 1000.0,
            "target_bucket": self._hot[3],
            "arrival_rate_rows_per_sec": self._rate,
            "latency_p50_ms": p(50), "latency_p95_ms": p(95),
            "latency_p99_ms": p(99),
            "rows_per_sec_wall": (win_rows / win_wall if win_wall > 0
                                  else None),
            "rows_per_sec_wall_lifetime": (self.rows_served / life_wall
                                           if life_wall > 0 else None),
            "host_blocked_s": self.host_blocked_s,
            "host_blocked_fraction": (self.host_blocked_s / life_wall
                                      if life_wall > 0 else None),
            "swaps": list(self.swaps),
        }

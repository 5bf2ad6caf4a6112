"""Roster-aware router over N replicated serving engines (port of
fedmse_tpu/net/router.py).

One `ServingEngine` + `ContinuousBatcher` pair is a single device
queue. The serving plane replicates it: N replicas (in-process over
separate engines, or remote processes behind the same wire protocol,
client.RemoteReplica) sit behind ONE router that owns the three
admission-time decisions:

  * **roster**: a row routed to a retired gateway slot terminates AT THE
    ROUTER with STATUS_UNKNOWN_GATEWAY. Replicas keep their own roster as
    defense in depth, but a left gateway's traffic never reaches a
    replica's dispatch path.
  * **admission**: the tiered token bucket (admission.py): rows the
    measured capacity cannot absorb are shed lowest-tier-first with
    explicit STATUS_SHED verdicts, before any replica sees them.
  * **routing**: admitted rows stripe across replicas in max_batch-sized
    contiguous slices (round-robin start), so every replica's intake
    stays on `submit_many`'s contiguous-slice path and a burst larger
    than one bucket spreads over the fleet.

**One card, many replicas.** The JAX package's replicas are separate
devices or processes. Here N in-process replicas usually share one card,
and every engine launches on the current CUDA stream, so on the default
stream replica B's bucket would queue behind A's. Each `LocalReplica`
over a CUDA engine therefore owns a `torch.cuda.Stream` and runs its
intake, polls, drains and swaps under it: each bucket's staging copies,
kernels and completion event go on the replica's stream, and the card
overlaps what it can. The stream waits on the calling stream at
construction (the engine's state was built there) and before and after
every swap (the payload was written there, and the install may cast it
on the replica's stream); every payload and installed state tensor is
`record_stream`-ed onto it, so the caching allocator never reuses one
while the replica's stream may still read it. A row's score does not depend on the
stream that computed it.

Hot swaps (params / banks / centroids / thresholds / roster) broadcast to
every replica through its own `ContinuousBatcher.swap`, which preserves
PER-REPLICA regime atomicity: each replica's in-flight batch keeps the
snapshot it captured, its forming batch dispatches under the new state,
and no ticket is dropped or re-scored. Replicas flip at slightly
different instants (the broadcast is sequential): the plane's
consistency model is per-replica-atomic, eventually-uniform.

Every submitted row gets EXACTLY ONE terminal status. `RouteResult`
assembles them in submission order from the router-level decisions plus
the replicas' O(1) `TicketBlock` handles.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from fedmse_tpu_torch.net.admission import AdmissionController
from fedmse_tpu_torch.net.wire import (STATUS_ANOMALY, STATUS_NORMAL,
                                       STATUS_SHED, STATUS_UNKNOWN_GATEWAY)

logger = logging.getLogger(__name__)


def _tensors(tree) -> list:
    """Every tensor of an engine's resident state or of a swap payload
    (params leaves, centroid statistics, bank latents and counts)."""
    import torch

    out = []

    def walk(v):
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif v is not None and hasattr(v, "__dataclass_fields__"):
            for name in v.__dataclass_fields__:
                walk(getattr(v, name))

    walk(tree)
    return out


class LocalReplica:
    """One in-process engine replica: a ServingEngine behind its own
    ContinuousBatcher and, on the card, its own CUDA stream (module
    docstring). The router talks to replicas through this interface
    (submit_many / poll / drain / swap / stats); client.RemoteReplica
    implements the same one over the wire."""

    def __init__(self, engine, max_batch: int = 1024,
                 latency_budget_ms: float = 5.0, calibration=None,
                 drift=None, intake=None, name: str = "replica",
                 clock: Callable[[], float] = time.perf_counter):
        from fedmse_tpu_torch.serving.continuous import ContinuousBatcher

        self.engine = engine
        self.name = name
        self.clock = clock
        self._mk = lambda mb: ContinuousBatcher(
            engine, max_batch=mb, latency_budget_ms=latency_budget_ms,
            calibration=calibration, drift=drift, intake=intake,
            clock=clock)
        self.batcher = self._mk(max_batch)
        self.swap_events: List[Dict] = []
        self.stream = None
        device = getattr(engine, "device", None)
        if device is not None and device.type == "cuda":
            import torch
            self.stream = torch.cuda.Stream(device)
            self._adopt(self.engine._state)

    def _adopt(self, tree) -> None:
        """Order the replica's stream after the work on the calling stream
        (which built the engine's state, or wrote a swap's payload), and
        keep the tensors of `tree` from reuse while the stream may read
        them."""
        import torch
        self.stream.wait_stream(torch.cuda.current_stream(self.stream.device))
        for t in _tensors(tree):
            if t.device.type == "cuda":
                t.record_stream(self.stream)

    def on_stream(self):
        """Context under which this replica's device work is issued."""
        if self.stream is None:
            return contextlib.nullcontext()
        import torch
        return torch.cuda.stream(self.stream)

    @property
    def max_batch(self) -> int:
        return self.batcher.max_batch

    @property
    def num_gateways(self) -> int:
        return self.engine.num_gateways

    def submit_many(self, rows: np.ndarray, gws: np.ndarray):
        with self.on_stream():
            return self.batcher.submit_many(rows, gws)

    def poll(self) -> bool:
        with self.on_stream():
            return self.batcher.poll()

    def drain(self) -> None:
        with self.on_stream():
            self.batcher.drain()

    def swap(self, **payload) -> Dict:
        if self.stream is not None:
            # the install may place the payload (a cast to the compute
            # dtype) on this stream: it must read what the caller wrote
            self._adopt(payload)
        with self.on_stream():
            event = self.batcher.swap(**payload)
        if self.stream is not None:
            self._adopt(self.engine._state)
        self.swap_events.append(event)
        return event

    def resize(self, max_batch: int) -> None:
        """Bucket-size scaling (autoscale.py): drain the current front
        and rebuild it at the new max_batch. Calibration/drift/intake
        snapshots carry over via the factory closure; outstanding
        tickets complete in the drain, so a resize never strands one."""
        if max_batch == self.batcher.max_batch:
            return
        old = self.batcher
        self.drain()
        new = self._mk(max_batch)
        # a threshold swap may have replaced the calibration since
        # construction; the live batcher's snapshot is authoritative
        new.calibration = old.calibration
        new.drift = old.drift
        new.intake = old.intake
        self.batcher = new

    def stats(self) -> Dict:
        st = self.batcher.stats()
        st["name"] = self.name
        st["swap_count"] = self.engine.swap_count
        return st


class RouteResult:
    """One submitted burst's per-row outcome, in submission order.

    `statuses` starts with the router-level terminal decisions
    (SHED / UNKNOWN_GATEWAY) and a pending marker for admitted rows;
    `done`/`finalize()` resolve the admitted rows out of their replica
    TicketBlocks — each row exactly once."""

    _PENDING = 255

    __slots__ = ("n", "statuses", "scores", "_segs", "_final")

    def __init__(self, n: int):
        self.n = n
        self.statuses = np.full(n, self._PENDING, np.uint8)
        self.scores = np.full(n, np.nan, np.float32)
        # (ticket_block, positions [k] int64) pairs
        self._segs: List = []
        self._final = False

    @property
    def done(self) -> bool:
        return self._final or all(blk.done for blk, _ in self._segs)

    def finalize(self) -> bool:
        """Resolve completed admitted rows into statuses/scores; returns
        True once every row is terminal (idempotent)."""
        if self._final:
            return True
        if not all(blk.done for blk, _ in self._segs):
            return False
        for blk, pos in self._segs:
            sc = blk.scores
            self.scores[pos] = sc
            raw = getattr(blk, "raw_statuses", None)
            if raw is not None:
                # a remote replica already speaks terminal statuses —
                # pass them THROUGH, never relabel: a worker-side SHED
                # or UNKNOWN_GATEWAY (a misdeployed worker running its
                # own admission) must reach the end client as what it
                # is, not as a NaN-scored "normal"
                self.statuses[pos] = raw
            elif blk.verdicts is None:
                self.statuses[pos] = STATUS_NORMAL
            else:
                self.statuses[pos] = np.where(blk.verdicts, STATUS_ANOMALY,
                                              STATUS_NORMAL).astype(np.uint8)
        self._final = True
        assert not (self.statuses == self._PENDING).any()
        return True


class Router:
    """The serving plane's admission + replication front (module doc)."""

    def __init__(self, replicas: List, roster=None,
                 admission: Optional[AdmissionController] = None,
                 isolation=None,
                 clock: Callable[[], float] = time.perf_counter):
        if not replicas:
            raise ValueError("router needs at least one replica")
        n0 = replicas[0].num_gateways
        for r in replicas:
            if r.num_gateways != n0:
                raise ValueError(
                    f"replica {r.name!r} serves {r.num_gateways} gateways, "
                    f"expected {n0}: replicas must mirror one federation")
        self.replicas: List = list(replicas)
        # the roster is owned HERE (authoritative at admission); default
        # to the first replica's engine roster so a pre-rostered engine
        # fleet keeps its membership view without repeating it
        self.roster = (roster if roster is not None
                       else getattr(replicas[0].engine, "roster", None))
        self.admission = admission
        # optional per-session rate gate (admission.SessionIsolation):
        # rides in front of the SHARED bucket so one flooding session
        # spends its own cap, not the fleet's. Engaged only for bursts
        # that arrive with a session_key (the gateway plane's frontends)
        self.isolation = isolation
        self.clock = clock
        self._rr = 0  # round-robin cursor
        self.rows_routed = 0
        self.rows_unknown = 0
        self.rows_isolated = 0
        self.swaps: List[Dict] = []

    @property
    def num_gateways(self) -> int:
        return self.replicas[0].num_gateways

    # ----------------------------- intake -------------------------------- #

    def submit_many(self, rows, gateway_ids, tiers=None,
                    age_s: Optional[float] = None,
                    session_key=None) -> RouteResult:
        """Route one burst; every row leaves with exactly one terminal
        status (module docstring). `age_s` is how long the burst queued
        before reaching the router (the server computes it from the
        frame's t_sent) — admission's staleness-shedding input."""
        rows = np.asarray(rows, np.float32)
        if rows.ndim == 1:
            rows = rows[None, :]
        n = rows.shape[0]
        gw = np.broadcast_to(np.asarray(gateway_ids, np.int32), (n,))
        res = RouteResult(n)
        if n == 0:
            return res
        alive = np.ones(n, bool)
        if self.roster is not None:
            bad = ~self.roster.member[np.clip(gw, 0, self.num_gateways - 1)]
            bad |= (gw < 0) | (gw >= self.num_gateways)
            if bad.any():
                res.statuses[bad] = STATUS_UNKNOWN_GATEWAY
                alive &= ~bad
                self.rows_unknown += int(bad.sum())
        elif n:
            oob = (gw < 0) | (gw >= self.num_gateways)
            if oob.any():
                res.statuses[oob] = STATUS_UNKNOWN_GATEWAY
                alive &= ~oob
                self.rows_unknown += int(oob.sum())
        if (self.isolation is not None and session_key is not None
                and alive.any()):
            # per-session cap BEFORE the shared bucket: excess rows shed
            # from the burst's tail so the grant stays contiguous-prefix
            # (ordering within a session's burst is oldest-first)
            navl = int(alive.sum())
            grant = self.isolation.allow(session_key, navl, now=self.clock())
            if grant < navl:
                idx = np.flatnonzero(alive)[grant:]
                res.statuses[idx] = STATUS_SHED
                alive[idx] = False
                self.rows_isolated += navl - grant
        if self.admission is not None and alive.any():
            t = (np.zeros(n, np.uint8) if tiers is None
                 else np.minimum(
                     np.broadcast_to(np.asarray(tiers, np.uint8), (n,)),
                     self.admission.tiers - 1))
            admit = self.admission.admit(t[alive], now=self.clock(),
                                         age_s=age_s)
            idx = np.flatnonzero(alive)
            shed_idx = idx[~admit]
            if len(shed_idx):
                res.statuses[shed_idx] = STATUS_SHED
                alive[shed_idx] = False
        if not alive.any():
            res._final = True
            return res
        pos = np.flatnonzero(alive)
        # no detach copy here: the replicas' submit_many already copies
        # whatever reaches the forming window (slices of these arrays
        # included), so one copy per burst happens exactly once, there
        sub_rows = rows[pos] if len(pos) < n else rows
        sub_gws = np.ascontiguousarray(gw[pos])
        self._route(res, sub_rows, sub_gws, pos)
        self.rows_routed += len(pos)
        return res

    def _route(self, res: RouteResult, rows: np.ndarray, gws: np.ndarray,
               pos: np.ndarray) -> None:
        """Stripe admitted rows across replicas in contiguous max_batch
        slices, starting at the round-robin cursor."""
        n = rows.shape[0]
        nrep = len(self.replicas)
        start = 0
        while start < n:
            rep = self.replicas[self._rr % nrep]
            self._rr += 1
            stop = min(n, start + rep.max_batch)
            blk = rep.submit_many(rows[start:stop], gws[start:stop])
            res._segs.append((blk, pos[start:stop]))
            start = stop

    # ------------------------------ drive -------------------------------- #

    def poll(self) -> bool:
        did = False
        for rep in self.replicas:
            did = rep.poll() or did
        return did

    def drain(self) -> None:
        for rep in self.replicas:
            rep.drain()

    # ---------------------------- hot swap ------------------------------- #

    def swap(self, *, params=None, centroids=None, banks=None,
             calibration=None, roster=None) -> Dict:
        """Broadcast one atomic payload to every replica (module
        docstring). The router's roster flips FIRST — a slot the new
        roster retires stops admitting at the very next burst, before
        any replica has installed the change — then each replica
        installs the payload through its own per-replica-atomic swap."""
        if roster is not None:
            self.roster = roster
        events = [rep.swap(params=params, centroids=centroids, banks=banks,
                           calibration=calibration, roster=roster)
                  for rep in self.replicas]
        event = {"kinds": events[0]["kinds"], "replicas": len(events),
                 "per_replica": events}
        self.swaps.append(event)
        return event

    # -------------------------- capacity probe ---------------------------- #

    def calibrate_capacity(self, probe_rows: np.ndarray,
                           probe_gws: np.ndarray, reps: int = 5) -> float:
        """Measure the fleet's capacity (rows/s) from warm CONCURRENT
        full-bucket dispatches (every replica's bucket in flight at once,
        each on its replica's stream, harvested together) and install it
        in the admission controller. Concurrency matters: replicas that
        overlap on the card add up, replicas that contend for it do not,
        and the measurement reflects which; a sequential per-replica sum
        would promise capacity the fleet cannot deliver and admission
        would never shed. Returns the measured total."""
        probes = []
        for rep in self.replicas:
            b = rep.max_batch
            xp = probe_rows[:b]
            gp = probe_gws[:b]
            if len(xp) < b:  # tile a thin probe up to the bucket
                t = -(-b // max(1, len(xp)))
                xp = np.tile(xp, (t, 1))[:b]
                gp = np.tile(gp, t)[:b]
            on_stream = getattr(rep, "on_stream", contextlib.nullcontext)
            with on_stream():
                rep.engine.dispatch(xp, gp).harvest()  # warm the bucket
            probes.append((rep, on_stream, xp, gp))
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            pends = []
            for rep, on_stream, xp, gp in probes:
                with on_stream():
                    pends.append(rep.engine.dispatch(xp, gp))
            for p in pends:
                p.harvest()
            best = min(best, time.perf_counter() - t0)
        total = sum(rep.max_batch for rep in self.replicas) / best
        if self.admission is not None:
            self.admission.set_capacity(total)
        return total

    # ---------------------------- telemetry ------------------------------- #

    def stats(self) -> Dict:
        per = [rep.stats() for rep in self.replicas]
        lat = [s["latency_p99_ms"] for s in per
               if s.get("latency_p99_ms") is not None]
        rates = [s["rows_per_sec_wall"] for s in per
                 if s.get("rows_per_sec_wall")]
        out = {
            "replicas": len(self.replicas),
            "rows_routed": self.rows_routed,
            "rows_unknown_gateway": self.rows_unknown,
            "rows_served": sum(s.get("rows_served", 0) for s in per),
            "latency_p99_ms_worst": max(lat) if lat else None,
            "rows_per_sec_wall_sum": sum(rates) if rates else None,
            "swaps": len(self.swaps),
            "per_replica": per,
        }
        if self.admission is not None:
            out["admission"] = self.admission.stats()
        if self.isolation is not None:
            out["rows_isolated"] = self.rows_isolated
            out["isolation"] = self.isolation.stats()
        return out


def make_local_replicas(engine_factory: Callable[[int], object], n: int,
                        max_batch: int = 1024,
                        latency_budget_ms: float = 5.0, calibration=None,
                        drift=None,
                        clock: Callable[[], float] = time.perf_counter
                        ) -> List[LocalReplica]:
    """N in-process replicas from an engine factory (index -> a fresh
    ServingEngine over the SAME federation state; sharing the stacked
    param arrays between engines is fine — serving never mutates them)."""
    if n < 1:
        raise ValueError(f"need at least one replica, got {n}")
    return [LocalReplica(engine_factory(i), max_batch=max_batch,
                         latency_budget_ms=latency_budget_ms,
                         calibration=calibration, drift=drift,
                         name=f"replica{i}", clock=clock)
            for i in range(n)]

"""Failover striping over scoring replicas: admitted tickets survive
replica death.

The net plane's Router stripes a burst across replicas and trusts each
to answer; a replica process dying mid-flood strands every in-flight
ticket it held — acceptable between co-deployed backends, not for an
ingest plane whose admission contract says an ADMITTED row always gets
a terminal verdict. `FailoverStripe` closes that: it presents ONE
replica-shaped target to the router (submit_many / poll / drain / swap
/ stats / max_batch), stripes internally across its member replicas,
and KEEPS every in-flight piece's rows until its result lands — so
when a member dies (its connection errors, or its oldest piece ages
past `resubmit_after_s`), the stripe re-submits the dead member's
unfinished pieces to survivors and the tickets complete there.

Re-scoring is safe by construction: scoring is a pure function of
(params, rows) and every replica mirrors one federation, so a row
scored twice (dead replica answered, answer lost) produces the same
score on the survivor — the caller observes exactly-once results
because the piece's block identity never changes, only the replica
behind it.

Cost: the stripe holds one extra reference per in-flight burst (the
rows it might need to re-send). For the mostly-idle gateway fleet this
is noise; under flood it is bounded by the in-flight window the
admission bucket already bounds.

Used by gateway/frontend.py as the single "replica" behind its Router
(`Router([stripe], admission=..., roster=...)`) — which is what keeps
the roster-aware routing and SHED-verdict semantics literally the
net plane's code, not a re-implementation.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from fedmse_tpu_torch.net.wire import STATUS_ANOMALY, STATUS_NORMAL

logger = logging.getLogger(__name__)


class StripeExhausted(RuntimeError):
    """Every member replica failed with tickets still in flight."""


class _Piece:
    """One contiguous slice of one burst, currently assigned to one
    member replica. Rows/gws are retained for possible re-submission;
    `owner` is the _StripeBlock assembling this burst (needed when a
    failover split spawns sibling pieces)."""

    __slots__ = ("rep_idx", "blk", "rows", "gws", "lo", "hi",
                 "submitted_at", "owner")

    def __init__(self, rep_idx, blk, rows, gws, lo, hi, now, owner):
        self.rep_idx = rep_idx
        self.blk = blk
        self.rows = rows
        self.gws = gws
        self.lo = lo
        self.hi = hi
        self.submitted_at = now
        self.owner = owner


class _StripeBlock:
    """TicketBlock-alike for one burst through the stripe: done when
    every piece's underlying block is done; statuses/scores assemble
    across pieces in row order. Exposes raw_statuses so RouteResult
    passes member-replica verdicts through verbatim (net/router.py)."""

    __slots__ = ("n", "pieces", "_statuses", "_scores")

    def __init__(self, n: int):
        self.n = n
        self.pieces: List[_Piece] = []
        self._statuses = None
        self._scores = None

    def __len__(self) -> int:
        return self.n

    def _assemble(self) -> bool:
        if self._scores is not None:
            return True
        if not all(p.blk.done for p in self.pieces):
            return False
        statuses = np.empty(self.n, np.uint8)
        scores = np.full(self.n, np.nan, np.float32)
        for p in self.pieces:
            blk = p.blk
            scores[p.lo:p.hi] = blk.scores
            raw = getattr(blk, "raw_statuses", None)
            if raw is not None:
                statuses[p.lo:p.hi] = raw
            elif blk.verdicts is None:
                statuses[p.lo:p.hi] = STATUS_NORMAL
            else:
                statuses[p.lo:p.hi] = np.where(
                    blk.verdicts, STATUS_ANOMALY,
                    STATUS_NORMAL).astype(np.uint8)
        self._statuses, self._scores = statuses, scores
        return True

    @property
    def done(self) -> bool:
        return self._assemble()

    @property
    def scores(self):
        return self._scores if self._assemble() else None

    @property
    def verdicts(self):
        if not self._assemble():
            return None
        return self._statuses == STATUS_ANOMALY

    @property
    def raw_statuses(self):
        return self._statuses if self._assemble() else None


class FailoverStripe:
    """Replica-shaped failover front over member replicas (module doc).

    `resubmit_after_s` None disables age-based failover (connection
    errors still fail a member); the bench sets it so a silently-hung
    member converts to a measured recovery, not a stall."""

    def __init__(self, replicas: List, name: str = "stripe",
                 resubmit_after_s: Optional[float] = None,
                 clock: Callable[[], float] = time.perf_counter):
        if not replicas:
            raise ValueError("stripe needs at least one member replica")
        self.members: List = list(replicas)
        self.alive: List[bool] = [True] * len(replicas)
        self.name = name
        self.engine = None   # roster lives in the owning Router
        self.resubmit_after_s = resubmit_after_s
        self.clock = clock
        self._rr = 0
        self._inflight: List[_Piece] = []
        self.failover_events: List[Dict] = []
        self.rows_resubmitted = 0

    # ------------------------- replica interface ------------------------- #

    @property
    def num_gateways(self) -> int:
        return self.members[0].num_gateways

    @property
    def n_alive(self) -> int:
        return sum(self.alive)

    @property
    def max_batch(self) -> int:
        """The stripe absorbs a burst the size of the whole ALIVE
        fleet's buckets — the owning Router slices at this, the stripe
        re-slices per member."""
        return max(1, sum(m.max_batch for m, a in zip(self.members,
                                                      self.alive) if a))

    def _next_alive(self) -> int:
        for _ in range(len(self.members)):
            i = self._rr % len(self.members)
            self._rr += 1
            if self.alive[i]:
                return i
        raise StripeExhausted(
            f"stripe {self.name!r}: every member replica failed")

    def submit_many(self, rows: np.ndarray, gws: np.ndarray) -> _StripeBlock:
        blk = _StripeBlock(len(rows))
        now = self.clock()
        start = 0
        while start < len(rows):
            i = self._next_alive()
            rep = self.members[i]
            stop = min(len(rows), start + rep.max_batch)
            piece = _Piece(i, None, rows[start:stop], gws[start:stop],
                           start, stop, now, blk)
            try:
                piece.blk = rep.submit_many(piece.rows, piece.gws)
            except Exception as e:  # noqa: BLE001 — any member fault fails it
                self._fail_member(i, e)
                continue            # piece not registered; retry the slice
            blk.pieces.append(piece)
            self._inflight.append(piece)
            start = stop
        return blk

    def poll(self) -> bool:
        did = False
        for i, rep in enumerate(self.members):
            if not self.alive[i]:
                continue
            try:
                did = rep.poll() or did
            except Exception as e:  # noqa: BLE001
                self._fail_member(i, e)
                did = True
        if self.resubmit_after_s is not None and self._inflight:
            cutoff = self.clock() - self.resubmit_after_s
            stale = {}
            for p in self._inflight:
                if not p.blk.done and p.submitted_at < cutoff:
                    stale.setdefault(p.rep_idx, []).append(p)
            for i in stale:
                if self.alive[i]:
                    self._fail_member(
                        i, TimeoutError(
                            f"oldest piece exceeded resubmit_after_s="
                            f"{self.resubmit_after_s}"))
                    did = True
        self._inflight = [p for p in self._inflight if not p.blk.done]
        return did

    def drain(self) -> None:
        deadline = None
        while True:
            self.poll()
            if not self._inflight:
                return
            for i, rep in enumerate(self.members):
                if not self.alive[i]:
                    continue
                try:
                    rep.drain()
                except Exception as e:  # noqa: BLE001
                    self._fail_member(i, e)
            self.poll()
            if not self._inflight:
                return
            # age-based failover still pending: bounded wait, never spin
            if self.resubmit_after_s is None:
                if deadline is None:
                    deadline = time.perf_counter() + 60.0
                elif time.perf_counter() > deadline:
                    raise StripeExhausted(
                        f"stripe {self.name!r}: drain stalled with "
                        f"{len(self._inflight)} pieces in flight")
            time.sleep(0.002)

    # ------------------------------ failover ------------------------------ #

    def _fail_member(self, i: int, err: Exception) -> None:
        """Mark member i dead and re-submit its unfinished pieces to
        survivors (splitting a piece that exceeds a survivor's bucket)."""
        if not self.alive[i]:
            return
        self.alive[i] = False
        t0 = self.clock()
        orphans = [p for p in self._inflight
                   if p.rep_idx == i and not p.blk.done]
        logger.warning("stripe member %s failed (%s); re-submitting %d "
                       "piece(s)", getattr(self.members[i], "name", i),
                       err, len(orphans))
        rows_moved = 0
        for p in orphans:
            self._resubmit(p)
            rows_moved += len(p.rows)
        self.rows_resubmitted += rows_moved
        self.failover_events.append({
            "member": getattr(self.members[i], "name", str(i)),
            "error": f"{type(err).__name__}: {err}",
            "pieces_resubmitted": len(orphans),
            "rows_resubmitted": rows_moved,
            "resubmit_s": round(self.clock() - t0, 6),
        })

    def _resubmit(self, piece: _Piece) -> None:
        """Move one orphaned piece to a survivor. The piece keeps its
        identity (its _StripeBlock still references it) — only the
        replica and underlying block behind it change. A piece larger
        than the survivor's bucket is split in place: this piece keeps
        the head slice, a sibling piece (same owner block) takes the
        tail — the defensive branch; deployments size members alike."""
        i = self._next_alive()
        rep = self.members[i]
        now = self.clock()
        if len(piece.rows) > rep.max_batch:
            cut = rep.max_batch
            sibling = _Piece(piece.rep_idx, piece.blk, piece.rows[cut:],
                             piece.gws[cut:], piece.lo + cut, piece.hi,
                             now, piece.owner)
            piece.rows = piece.rows[:cut]
            piece.gws = piece.gws[:cut]
            piece.hi = piece.lo + cut
            self._inflight.append(sibling)
            piece.owner.pieces.append(sibling)
            self._resubmit(piece)
            self._resubmit(sibling)
            return
        try:
            piece.blk = rep.submit_many(piece.rows, piece.gws)
            piece.rep_idx = i
            piece.submitted_at = now
        except Exception as e:  # noqa: BLE001
            self._fail_member(i, e)
            self._resubmit(piece)

    # --------------------------- control plane ---------------------------- #

    def swap(self, **payload) -> Dict:
        events = []
        for i, rep in enumerate(self.members):
            if not self.alive[i]:
                continue
            try:
                events.append(rep.swap(**payload))
            except Exception as e:  # noqa: BLE001
                self._fail_member(i, e)
        if not events:
            raise StripeExhausted(
                f"stripe {self.name!r}: no member accepted the swap")
        return {"kinds": events[0].get("kinds", []),
                "replicas": len(events), "per_replica": events}

    def resize(self, max_batch: int) -> None:
        for i, rep in enumerate(self.members):
            if self.alive[i] and hasattr(rep, "resize"):
                rep.resize(max_batch)

    def add_member(self, replica) -> None:
        """Live scale-up (frontend autoscale tick): the fresh replica
        enters the rotation immediately."""
        self.members.append(replica)
        self.alive.append(True)

    def remove_member(self) -> None:
        """Live scale-down: drop the last alive member after draining
        it (no ticket stranded — same discipline as NetFront)."""
        for i in range(len(self.members) - 1, -1, -1):
            if self.alive[i]:
                if self.n_alive == 1:
                    raise ValueError("cannot remove the last alive member")
                self.members[i].drain()
                self.alive[i] = False
                return

    def stats(self) -> Dict:
        per = []
        for i, rep in enumerate(self.members):
            if not self.alive[i]:
                per.append({"name": getattr(rep, "name", str(i)),
                            "dead": True})
                continue
            try:
                per.append(rep.stats())
            except Exception:  # noqa: BLE001 — stats never fails the plane
                per.append({"name": getattr(rep, "name", str(i)),
                            "stats_error": True})
        lat = [s.get("latency_p99_ms") for s in per
               if s.get("latency_p99_ms") is not None]
        return {
            "name": self.name,
            "members": len(self.members),
            "alive": self.n_alive,
            "inflight_pieces": len(self._inflight),
            "rows_resubmitted": self.rows_resubmitted,
            "failover_events": self.failover_events,
            "latency_p99_ms": max(lat) if lat else None,
            "per_member": per,
        }

"""Admission control: tiered load shedding against measured capacity (port
of fedmse_tpu/net/admission.py; under one injected clock its decisions are
the JAX package's).

The continuous front's adaptive bucket picker already tracks an
arrival-rate EMA so it can right-size dispatches, but nothing bounds
what the front ACCEPTS: offered load beyond the engines' measured
capacity just grows the forming/in-flight queue and every row's latency
with it. A serving plane needs the opposite failure mode — when the
fleet cannot keep up, the lowest-priority traffic is rejected EXPLICITLY
(a SHED verdict in the response stream, wire.STATUS_SHED) so admitted
rows keep their latency budget and the caller knows exactly which rows
were never scored. Silent drops are forbidden by construction: every
submitted row leaves the router with exactly one terminal status.

Mechanism: a token bucket refilled at `capacity_rows_per_sec *
headroom` with depth `capacity * burst_s` tokens. A burst that arrives
while the bucket holds enough tokens is admitted whole (the common
path: one subtraction). Under sustained overload the bucket runs dry
and the shortfall is shed in PRIORITY ORDER — tier 0 is the GUARANTEED
class (admitted unconditionally, consuming tokens into bounded debt;
its protection is queueing + the autoscaler, never drops), tier 1
drinks what remains before tier 2, so the rows that miss out are
always the lowest tiers present in the burst. The depth converts
transient burstiness into queueing (the continuous front absorbs it)
and only SUSTAINED overload into shedding; `burst_s` is that
distinction's time constant.

Capacity is MEASURED, not configured: the router calibrates it from
warm blocking dispatches of a full bucket per replica
(Router.calibrate_capacity), and the autoscaler rescales it when the
replica count changes. The arrival EMA is kept per tier for telemetry
and for the autoscaler's demand signal (autoscale.py) — admission
itself acts on the bucket, which is exact, not smoothed.

A second, self-correcting gate composes with the bucket: **staleness
shedding** (`stale_after_s`). The capacity probe measures the ENGINES;
a deployed plane also spends cycles on sockets, framing, and host
bookkeeping, and its true capacity moves with co-located load — an
optimistic probe would let the backlog (which lives in kernel socket
buffers, invisible to any rate counter taken at admission time) grow
without ever shedding. Each SUBMIT frame carries its sender wall-clock
timestamp (wire.py), so admission can see how long a burst ALREADY
queued before reaching it: a tier-k row (k >= 1) is shed once its age
exceeds `stale_after_s * (tiers - k)` — lowest tier at 1x, next at 2x,
and so on — while TIER 0 NEVER stale-sheds (the guaranteed tier rides
the queue, which also keeps the engines saturated through a shedding
episode instead of oscillating between shed-everything and idle).
Whatever the probe believed, sustained overload surfaces as queueing
delay and sheds exactly the traffic whose latency budget is already
lost, lowest priority first.

A third gate exists for the gateway plane (fedmse_tpu_torch/gateway/):
**per-session isolation** (`SessionIsolation`). The shared bucket is a
FLEET resource, which makes it an attack surface the moment sessions
are adversarial: a coalition flooding low-tier traffic drains the
shared tokens and pushes HONEST gateways' rows into SHED (the
shed-storm adversary, redteam/ingest.py). The isolation gate caps each
session at `session_share` of fleet capacity BEFORE its rows reach the
shared bucket — a flooder exhausts its own cap, not the fleet's
tokens. No honest gateway operates anywhere near a whole-fleet
fraction, so the cap never touches clean traffic: the defense's clean
cost is structurally zero (measured in redteam_sweep's shed-storm
cell).

Deterministic and clock-injected like the continuous front, so the
overload tests drive it with a synthetic clock.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np


class AdmissionController:
    """Token-bucket admission with strict priority tiers."""

    def __init__(self, tiers: int = 3,
                 capacity_rows_per_sec: Optional[float] = None,
                 headroom: float = 0.9, burst_s: float = 0.25,
                 ema_alpha: float = 0.3,
                 stale_after_s: Optional[float] = None,
                 clock: Callable[[], float] = time.perf_counter):
        if tiers < 1:
            raise ValueError(f"tiers must be >= 1, got {tiers}")
        if not 0.0 < headroom <= 1.0:
            raise ValueError(f"headroom must be in (0, 1], got {headroom}")
        if burst_s <= 0.0:
            raise ValueError(f"burst_s must be > 0, got {burst_s}")
        if stale_after_s is not None and stale_after_s <= 0.0:
            raise ValueError(f"stale_after_s must be > 0, "
                             f"got {stale_after_s}")
        self.tiers = tiers
        self.stale_after_s = stale_after_s
        self.headroom = headroom
        self.burst_s = burst_s
        self.ema_alpha = ema_alpha
        self.clock = clock
        self.capacity_rows_per_sec = None
        self._tokens = 0.0
        self._last_refill: Optional[float] = None
        if capacity_rows_per_sec is not None:
            # same arming rule as a later set_capacity: the bucket
            # starts FULL, so the first burst after construction can
            # never shed (shedding requires sustained overload)
            self.set_capacity(capacity_rows_per_sec)
        # per-tier arrival EMA (rows/sec) + exact lifetime counters
        self._tier_rate = np.zeros(tiers)
        self._last_arrival: Optional[float] = None
        self.offered = np.zeros(tiers, np.int64)
        self.admitted = np.zeros(tiers, np.int64)
        self.shed = np.zeros(tiers, np.int64)
        # the part of `shed` the staleness gate shed, by tier (the rest
        # the bucket shed); kept out of stats(), which is the JAX one's
        self.stale_shed = np.zeros(tiers, np.int64)
        self.shed_events = 0

    # ---------------------------- capacity ------------------------------- #

    def set_capacity(self, rows_per_sec: float) -> None:
        """Install a measured capacity (router calibration / autoscaler
        after a replica change). Arms the bucket FULL so a capacity
        change never sheds the first burst after it."""
        if rows_per_sec <= 0:
            raise ValueError(f"capacity must be > 0 rows/s, "
                             f"got {rows_per_sec}")
        self.capacity_rows_per_sec = float(rows_per_sec)
        self._tokens = self._depth()
        self._last_refill = None

    def _depth(self) -> float:
        return self.capacity_rows_per_sec * self.headroom * self.burst_s

    def _refill(self, now: float) -> None:
        if self._last_refill is not None:
            self._tokens = min(
                self._depth(),
                self._tokens
                + (now - self._last_refill)
                * self.capacity_rows_per_sec * self.headroom)
        self._last_refill = now

    # ---------------------------- admission ------------------------------ #

    def admit(self, tier_values: np.ndarray, now: Optional[float] = None,
              age_s: Optional[float] = None) -> np.ndarray:
        """[n] bool admit mask for one burst's per-row tiers.

        `age_s` is how long the burst already queued before reaching
        admission (receive time minus the frame's t_sent) — the
        staleness gate's input (class docstring); None disables it for
        this burst. The token bucket then applies to the survivors:
        with no measured capacity admission is wide open (the plane
        before calibration — shedding requires evidence), otherwise
        tokens drain tier 0 first and the lowest tiers present are shed
        when the bucket runs dry. Within one tier, earlier rows in the
        burst win (arrival order)."""
        tiers = np.asarray(tier_values, np.uint8)
        n = len(tiers)
        if now is None:
            now = self.clock()
        self._observe_arrival(tiers, now)
        if n == 0:
            return np.ones(0, bool)
        mask = np.ones(n, bool)
        if age_s is not None and self.stale_after_s is not None \
                and age_s > self.stale_after_s:
            # tier k (k >= 1) sheds past stale_after_s * (tiers - k);
            # tier 0 never stale-sheds (the guaranteed tier)
            limit = np.where(
                tiers == 0, np.inf,
                self.stale_after_s * (self.tiers - tiers.astype(np.int64)))
            mask &= age_s <= limit
            self.stale_shed += np.bincount(
                tiers[~mask], minlength=self.tiers)[:self.tiers]
        live = tiers[mask]
        if self.capacity_rows_per_sec is not None and len(live):
            self._refill(now)
            # tier 0 is the GUARANTEED class on this gate too: it is
            # admitted unconditionally and still consumes tokens (debt
            # floored at -depth), so a tier-0 flood starves the lower
            # tiers' budget rather than being dropped. Two reasons: the
            # policy (the highest tier's protection is queueing +
            # autoscaling, never drops), and a failure mode — a server
            # draining a deep backlog presents many bursts to admission
            # within microseconds, which a pure token bucket reads as an
            # instantaneous flood and sheds traffic that merely QUEUED
            # (observed in the bench before the exemption).
            n0 = int((live == 0).sum())
            self._tokens -= n0
            rest = len(live) - n0
            if self._tokens >= rest:
                self._tokens -= rest
            else:
                budget = max(0, int(self._tokens))
                self._tokens -= budget
                keep = live == 0
                # strict priority among tiers >= 1: stable sort by tier
                # keeps arrival order within a tier; the first `budget`
                # non-tier-0 rows of that order win
                lower = np.flatnonzero(live > 0)
                order = lower[np.argsort(live[lower], kind="stable")]
                keep[order[:budget]] = True
                idx = np.flatnonzero(mask)
                mask[idx[~keep]] = False
            self._tokens = max(self._tokens, -self._depth())
        adm = np.bincount(tiers[mask], minlength=self.tiers)
        sh = np.bincount(tiers[~mask], minlength=self.tiers)
        self.admitted += adm[:self.tiers].astype(np.int64)
        self.shed += sh[:self.tiers].astype(np.int64)
        if not mask.all():
            self.shed_events += 1
        return mask

    def _observe_arrival(self, tiers: np.ndarray, now: float) -> None:
        counts = np.bincount(tiers, minlength=self.tiers)[:self.tiers]
        self.offered += counts.astype(np.int64)
        if self._last_arrival is not None:
            span = now - self._last_arrival
            if span > 0:
                a = self.ema_alpha
                self._tier_rate = ((1 - a) * self._tier_rate
                                   + a * (counts / span))
        self._last_arrival = now

    # ---------------------------- telemetry ------------------------------ #

    @property
    def arrival_rate_rows_per_sec(self) -> float:
        return float(self._tier_rate.sum())

    def stats(self) -> Dict:
        return {
            "tiers": self.tiers,
            "capacity_rows_per_sec": self.capacity_rows_per_sec,
            "headroom": self.headroom,
            "burst_s": self.burst_s,
            "stale_after_s": self.stale_after_s,
            "arrival_rate_rows_per_sec": self.arrival_rate_rows_per_sec,
            "arrival_rate_by_tier": [round(float(r), 1)
                                     for r in self._tier_rate],
            "offered_by_tier": self.offered.tolist(),
            "admitted_by_tier": self.admitted.tolist(),
            "shed_by_tier": self.shed.tolist(),
            "shed_total": int(self.shed.sum()),
            "shed_events": self.shed_events,
        }


class SessionIsolation:
    """Per-session rate caps in front of the shared bucket (module
    docstring): session k may consume at most `session_share` of fleet
    capacity, enforced by a lazily-created per-key token bucket (rate
    `capacity * session_share`, depth `rate * burst_s`). `allow()`
    returns how many of a burst's rows may proceed to the shared
    admission gate; the remainder is the session's own excess and the
    CALLER sheds it with an explicit SHED verdict attributed to that
    session. Keys that stop submitting cost nothing (their bucket just
    sits in the dict until `forget()`); at bench scale only submitting
    sessions ever materialize an entry."""

    def __init__(self, capacity_rows_per_sec: Optional[float] = None,
                 session_share: float = 0.25, burst_s: float = 0.25,
                 clock: Callable[[], float] = time.perf_counter):
        if not 0.0 < session_share <= 1.0:
            raise ValueError(f"session_share must be in (0, 1], "
                             f"got {session_share}")
        if burst_s <= 0.0:
            raise ValueError(f"burst_s must be > 0, got {burst_s}")
        self.session_share = session_share
        self.burst_s = burst_s
        self.clock = clock
        self.capacity_rows_per_sec = capacity_rows_per_sec
        # key -> [tokens, last_refill]
        self._buckets: Dict = {}
        self.rows_capped = 0
        self.sessions_capped = 0

    def set_capacity(self, rows_per_sec: float) -> None:
        """Track the fleet capacity the shares are fractions of; resets
        no per-key state (a live capacity change must not refill a
        flooder's bucket)."""
        if rows_per_sec <= 0:
            raise ValueError(f"capacity must be > 0 rows/s, "
                             f"got {rows_per_sec}")
        self.capacity_rows_per_sec = float(rows_per_sec)

    def _rate(self) -> float:
        return self.capacity_rows_per_sec * self.session_share

    def allow(self, key: int, n_rows: int,
              now: Optional[float] = None) -> int:
        """How many of this session's `n_rows` proceed to shared
        admission. With no measured capacity the gate is wide open
        (same evidence rule as the shared bucket)."""
        if self.capacity_rows_per_sec is None or n_rows == 0:
            return n_rows
        if now is None:
            now = self.clock()
        rate = self._rate()
        depth = rate * self.burst_s
        b = self._buckets.get(key)
        if b is None:
            b = self._buckets[key] = [depth, now]  # new sessions start full
        else:
            b[0] = min(depth, b[0] + (now - b[1]) * rate)
            b[1] = now
        grant = int(min(n_rows, max(0.0, b[0])))
        b[0] -= grant
        if grant < n_rows:
            self.rows_capped += n_rows - grant
            self.sessions_capped += 1
        return grant

    def forget(self, key: int) -> None:
        self._buckets.pop(key, None)

    def stats(self) -> Dict:
        return {
            "session_share": self.session_share,
            "burst_s": self.burst_s,
            "capacity_rows_per_sec": self.capacity_rows_per_sec,
            "tracked_sessions": len(self._buckets),
            "rows_capped": int(self.rows_capped),
            "cap_events": int(self.sessions_capped),
        }

"""SLO-driven, cost-aware autoscaling for the replicated serving plane (port
of fedmse_tpu/net/autoscale.py).

Two knobs close the loop the continuous front opened:

  * **replica count** — how many engine replicas the router stripes
    over. Demand is the admission controller's arrival EMA; supply is
    the measured per-replica capacity (router.calibrate_capacity).
    The scaler keeps supply at
    `demand / target_utilization` so the plane runs below the shedding
    knee with headroom for bursts.
  * **bucket size** — each replica's max_batch. The p99 budget
    (`serve_latency_budget_ms`, the same budget the adaptive bucket
    picker steers within one replica) bounds it from above: a bucket
    larger than the per-replica arrival share fills in a budget is pure
    latency; one the share overfills is pure queueing. The scaler picks
    the largest power of two the PER-REPLICA arrival rate fills within
    the budget — the fleet-level generalization of
    `ContinuousBatcher._pick_bucket`.

Cost model (arxiv 2509.14920 — CPU-serverless vs accelerator training
cost curves; the same structure holds for inference): each backend
offers replicas at a fixed `rows_per_sec` capacity and `usd_per_hour`
price. CPU replicas are cheap and slow (cost-efficient at low demand,
where an accelerator would idle below its amortization point);
accelerator replicas amortize a high fixed price over much higher
throughput (cheaper PER ROW once demand fills them). `plan()` picks the
backend mix minimizing $/hour subject to covering demand at the target
utilization — which reproduces the paper's crossover: all-CPU below the
break-even arrival rate, accelerator-anchored above it, with a CPU
remainder only when it undercuts one more accelerator replica.

The scaler only DECIDES; applying a decision is the owner's job
(server.NetFront resizes/adds/removes local replicas via a factory).
Hysteresis: decisions inside `cooldown_s` of the last applied change
return `hold`, and scale-down additionally requires utilization under
`scale_down_utilization` so the plane never flaps around the knee.
Clock-injected, deterministic, engine-free — tests drive it directly.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """One replica flavor the plane can buy (the cost-model row)."""

    name: str                    # 'cpu' | 'cuda' | ...
    rows_per_sec: float          # measured per-replica capacity
    usd_per_hour: float          # price per replica-hour
    max_replicas: int = 8

    def __post_init__(self):
        if self.rows_per_sec <= 0 or self.usd_per_hour < 0:
            raise ValueError(f"backend {self.name!r}: capacity must be > 0 "
                             f"and price >= 0")

    @property
    def usd_per_megarow(self) -> float:
        """$ per 1e6 rows at FULL utilization (the amortized floor)."""
        return self.usd_per_hour / (self.rows_per_sec * 3600.0 / 1e6)


@dataclasses.dataclass(frozen=True)
class FrontendSpec:
    """One ingest-frontend flavor (the gateway plane's cost-model row).

    Frontends are CONNECTION-bound and CPU-cheap: their three capacity
    axes are how many mostly-idle sessions one process can hold
    (session table + epoll budget), how many HMAC handshakes/s it can
    terminate, and how many rows/s it can frame-check and forward (none
    of them scoring compute). The defaults are the JAX package's
    constants, kept so that both packages plan alike; a deployment
    passes its own measured values. A frontend never scores a row, so
    its sizing is INDEPENDENT of the replica mix: plan_split sizes the
    two classes separately."""

    name: str = "frontend"
    max_sessions: int = 200_000
    handshakes_per_sec: float = 3000.0
    mux_rows_per_sec: float = 500_000.0
    usd_per_hour: float = 0.05
    max_frontends: int = 64

    def __post_init__(self):
        if (self.max_sessions <= 0 or self.handshakes_per_sec <= 0
                or self.mux_rows_per_sec <= 0 or self.usd_per_hour < 0):
            raise ValueError(f"frontend {self.name!r}: capacities must be "
                             f"> 0 and price >= 0")


def plan_split(demand_rows_per_sec: float, concurrent_sessions: float,
               handshake_rate_per_sec: float, frontend: FrontendSpec,
               backends: Sequence[BackendSpec],
               target_utilization: float = 0.6) -> Dict:
    """Two-class sizing for the frontend/replica split: frontends by
    the max over their three connection-bound axes, replicas by the
    compute-bound plan_mix — independently, because the classes share
    no resource (a session parked on a frontend costs the scoring fleet
    nothing; a scored row costs the frontend one token check). The bill
    is the sum; `frontend_axis` names which axis bound the frontend
    count (the gateway bench's 1M-session shape is session-bound at
    ~zero rows/s — connection count and rows/s are separate first-class
    axes, which is the whole point of the split)."""
    tu = target_utilization
    axes = {
        "sessions": concurrent_sessions / (frontend.max_sessions * tu),
        "handshakes": handshake_rate_per_sec / (frontend.handshakes_per_sec
                                                * tu),
        "mux_rows": demand_rows_per_sec / (frontend.mux_rows_per_sec * tu),
    }
    axis = max(axes, key=axes.get)
    uncapped = max(1, math.ceil(axes[axis]))
    n_front = min(uncapped, frontend.max_frontends)
    mix = plan_mix(demand_rows_per_sec, backends, tu)
    front_cost = n_front * frontend.usd_per_hour
    replica_cost = sum(b.usd_per_hour * mix.get(b.name, 0)
                       for b in backends)
    return {
        "frontends": n_front,
        "frontends_uncapped": uncapped,
        "frontend_axis": axis,
        "frontend_axis_loads": {k: round(v, 4) for k, v in axes.items()},
        "replicas": mix,
        "frontend_usd_per_hour": round(front_cost, 6),
        "replica_usd_per_hour": round(replica_cost, 6),
        "usd_per_hour": round(front_cost + replica_cost, 6),
    }


@dataclasses.dataclass
class ScaleDecision:
    action: str                  # 'hold' | 'scale_up' | 'scale_down'
    replicas: Dict[str, int]     # target count per backend name
    bucket: int                  # target per-replica max_batch (pow2)
    reason: str
    usd_per_hour: float

    @property
    def total_replicas(self) -> int:
        return sum(self.replicas.values())


def plan_mix(demand_rows_per_sec: float, backends: Sequence[BackendSpec],
             target_utilization: float) -> Dict[str, int]:
    """Cheapest backend mix covering `demand / target_utilization`.

    Exact small search: demand at plane scale needs at most a handful
    of replicas per backend (max_replicas bounds each axis), so
    enumerate counts of the expensive-but-dense backends and fill the
    remainder with the cheapest-per-row option — for the two-backend
    CPU/accelerator case this is exact, and it degrades gracefully for
    more. Every mix keeps >= 1 replica total (an empty plane serves
    nothing)."""
    need = max(demand_rows_per_sec, 0.0) / target_utilization
    ranked = sorted(backends, key=lambda b: b.usd_per_megarow)
    best: Optional[Dict[str, int]] = None
    best_cost = math.inf

    def consider(mix: Dict[str, int]):
        nonlocal best, best_cost
        total = sum(mix.values())
        if total < 1:
            return
        supply = sum(b.rows_per_sec * mix[b.name] for b in backends)
        if supply < need:
            return
        cost = sum(b.usd_per_hour * mix[b.name] for b in backends)
        if cost < best_cost - 1e-12 or (
                abs(cost - best_cost) <= 1e-12
                and best is not None and total < sum(best.values())):
            best, best_cost = dict(mix), cost

    def rec(i: int, mix: Dict[str, int]):
        if i == len(ranked):
            consider(mix)
            return
        b = ranked[i]
        for k in range(b.max_replicas + 1):
            mix[b.name] = k
            rec(i + 1, mix)
        mix[b.name] = 0

    rec(0, {b.name: 0 for b in ranked})
    if best is None:  # demand exceeds the whole fleet: buy everything
        best = {b.name: b.max_replicas for b in backends}
    return best


class SLOAutoscaler:
    """p99-budget + cost-model scaling policy (module docstring)."""

    def __init__(self, budget_ms: float, backends: Sequence[BackendSpec],
                 target_utilization: float = 0.6,
                 scale_down_utilization: float = 0.3,
                 min_bucket: int = 64, max_bucket: int = 4096,
                 cooldown_s: float = 5.0,
                 scale_down_confirm_ticks: int = 1,
                 clock: Callable[[], float] = time.perf_counter):
        if budget_ms <= 0:
            raise ValueError(f"budget_ms must be > 0, got {budget_ms}")
        if not backends:
            raise ValueError("autoscaler needs at least one BackendSpec")
        if not 0 < scale_down_utilization < target_utilization <= 1.0:
            raise ValueError(
                f"need 0 < scale_down_utilization ({scale_down_utilization})"
                f" < target_utilization ({target_utilization}) <= 1")
        self.budget_ms = budget_ms
        self.backends = {b.name: b for b in backends}
        self.target_utilization = target_utilization
        self.scale_down_utilization = scale_down_utilization
        self.min_bucket = min_bucket
        self.max_bucket = max_bucket
        self.cooldown_s = cooldown_s
        # scale-down must be CONFIRMED by this many consecutive
        # shrink-eligible ticks (1 = immediate, the historical
        # behavior). This is the cost-gaming defense (redteam/ingest.py
        # CostGamingAdversary): an adversary squeezing its load into
        # brief lulls can otherwise walk the fleet down right as its
        # next burst lands — paying the scale-up lag on every cycle.
        # Clean cost is zero: a genuinely idle plane still scales down,
        # just `confirm_ticks` ticks later.
        if scale_down_confirm_ticks < 1:
            raise ValueError("scale_down_confirm_ticks must be >= 1")
        self.scale_down_confirm_ticks = scale_down_confirm_ticks
        self.clock = clock
        self._last_change: Optional[float] = None
        self._shrink_streak = 0
        self.decisions: List[ScaleDecision] = []

    # ----------------------------- policy -------------------------------- #

    def _pick_bucket(self, arrival_rows_per_sec: float,
                     replicas: int, p99_ms: Optional[float]) -> int:
        """Largest pow2 the per-replica arrival share fills within the
        budget; a breached budget additionally halves it (smaller
        dispatches drain the forming window sooner)."""
        share = arrival_rows_per_sec / max(replicas, 1)
        expected = share * self.budget_ms / 1000.0
        b = self.min_bucket
        while (b << 1) <= expected and (b << 1) <= self.max_bucket:
            b <<= 1
        if p99_ms is not None and p99_ms > self.budget_ms:
            b = max(self.min_bucket, b >> 1)
        return b

    def decide(self, *, arrival_rows_per_sec: float,
               p99_ms: Optional[float],
               current: Dict[str, int]) -> ScaleDecision:
        """One control tick: (demand EMA, worst replica p99, current
        per-backend replica counts) -> a ScaleDecision. Appended to
        `decisions` so the serving plane's telemetry carries the whole
        trace; callers apply anything with action != 'hold' and then
        `mark_applied()`."""
        now = self.clock()
        cur_total = max(1, sum(current.values()))
        supply = sum(self.backends[n].rows_per_sec * k
                     for n, k in current.items() if n in self.backends)
        util = arrival_rows_per_sec / supply if supply > 0 else math.inf
        target = plan_mix(arrival_rows_per_sec, list(self.backends.values()),
                          self.target_utilization)
        cost = sum(self.backends[n].usd_per_hour * k
                   for n, k in target.items())
        bucket = self._pick_bucket(arrival_rows_per_sec,
                                   sum(target.values()), p99_ms)
        over_budget = p99_ms is not None and p99_ms > self.budget_ms
        # a p99 breach scales up even when the demand EMA looks covered:
        # the SLO signal is ground truth, the EMA can lag a burst
        grow = sum(target.values()) > cur_total or over_budget
        shrink_eligible = (sum(target.values()) < cur_total
                           and util < self.scale_down_utilization
                           and not over_budget)
        self._shrink_streak = (self._shrink_streak + 1 if shrink_eligible
                               else 0)
        shrink = (shrink_eligible
                  and self._shrink_streak >= self.scale_down_confirm_ticks)
        in_cooldown = (self._last_change is not None
                       and now - self._last_change < self.cooldown_s)
        if in_cooldown or not (grow or shrink):
            d = ScaleDecision(
                "hold", dict(current), bucket,
                ("cooldown" if in_cooldown else
                 f"awaiting scale-down confirmation "
                 f"({self._shrink_streak}/{self.scale_down_confirm_ticks})"
                 if shrink_eligible else
                 f"util {util:.2f} within "
                 f"[{self.scale_down_utilization}, "
                 f"{self.target_utilization}], p99 within budget"),
                cost)
        elif grow:
            if over_budget and sum(target.values()) <= cur_total:
                # budget breach without a demand case: add one replica of
                # the cheapest backend that still has headroom
                target = dict(current)
                for b in sorted(self.backends.values(),
                                key=lambda b: b.usd_per_hour):
                    if target.get(b.name, 0) < b.max_replicas:
                        target[b.name] = target.get(b.name, 0) + 1
                        break
                cost = sum(self.backends[n].usd_per_hour * k
                           for n, k in target.items())
            d = ScaleDecision(
                "scale_up", target, bucket,
                f"demand {arrival_rows_per_sec:.0f} rows/s at util "
                f"{util:.2f}"
                + (f", p99 {p99_ms:.1f} ms > budget {self.budget_ms} ms"
                   if over_budget else ""),
                cost)
        else:
            d = ScaleDecision(
                "scale_down", target, bucket,
                f"util {util:.2f} < {self.scale_down_utilization}; "
                f"cheapest covering mix {target}",
                cost)
        self.decisions.append(d)
        return d

    def mark_applied(self) -> None:
        """Arm the cooldown after the owner applies a decision."""
        self._last_change = self.clock()

    def stats(self) -> Dict:
        return {
            "budget_ms": self.budget_ms,
            "target_utilization": self.target_utilization,
            "backends": {n: {"rows_per_sec": b.rows_per_sec,
                             "usd_per_hour": b.usd_per_hour,
                             "usd_per_megarow": round(b.usd_per_megarow, 6),
                             "max_replicas": b.max_replicas}
                         for n, b in self.backends.items()},
            "decisions": [{"action": d.action, "replicas": d.replicas,
                           "bucket": d.bucket, "usd_per_hour":
                           round(d.usd_per_hour, 4), "reason": d.reason}
                          for d in self.decisions[-32:]],
        }

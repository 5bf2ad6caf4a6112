"""Ingest-plane adversaries: shed-storm forcing and cost-model gaming (port
of fedmse_tpu/redteam/ingest.py; the cells' results equal the JAX
package's).

The gateway plane (fedmse_tpu_torch/gateway/) authenticates sessions before a
row byte is parsed, so the interesting adversary is the one who PASSES
the handshake — a coalition of enrolled-but-hostile gateways. Two
attacks on the two decisions the plane makes after auth:

  * **Shed storm** (`ShedStormAdversary`): the shared admission bucket
    (net/admission.py) sheds lowest-tier-first with no notion of WHO
    spent the tokens — and the tier byte in a G_SUBMIT frame is
    CLIENT-controlled, so the coalition claims tier 0, the guaranteed
    class that is never dropped and instead drives the bucket into
    token debt. The debt starves every lower tier's budget and the
    SHED verdicts land on honest gateways' rows — a verdict-level
    denial of service that never breaks a single protocol rule.
    Defense: `SessionIsolation`, the per-session rate cap the router
    applies BEFORE the shared bucket and BEFORE tier priority
    (Router.submit_many `session_key=`, exactly the frontend's call
    path) — a flooder spends its own cap, not the fleet's, whatever
    tier it claims.
  * **Cost gaming** (`CostGamingAdversary`): the SLO autoscaler
    (net/autoscale.py) scales down when utilization stays low. An
    adversary who squeezes its load into lulls baits the fleet down,
    then bursts the moment supply drops — every cycle pays the
    scale-up lag in shed rows and the bill in churned replicas.
    Defense: `scale_down_confirm_ticks` — scale-down must be confirmed
    by k consecutive shrink-eligible ticks, stretching the bait cycle
    without costing a genuinely idle plane anything but k-1 ticks of
    patience.

Both cells are engine-free, clock-injected simulations of the REAL
decision objects (Router + AdmissionController + SessionIsolation;
SLOAutoscaler): here only the decisions are under attack, so the cells
touch no device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from fedmse_tpu_torch.net.admission import AdmissionController, SessionIsolation
from fedmse_tpu_torch.net.autoscale import BackendSpec, SLOAutoscaler
from fedmse_tpu_torch.net.router import Router
from fedmse_tpu_torch.net.wire import STATUS_SHED
from fedmse_tpu_torch.serving.engine import ServingRoster


class _InstantBlock:
    """A done-on-arrival ticket block: scoring is not under attack."""

    __slots__ = ("scores", "verdicts", "done")

    def __init__(self, n: int):
        self.scores = np.zeros(n, np.float32)
        self.verdicts = None
        self.done = True


class InstantReplica:
    """Replica-shaped sink that completes every burst instantly —
    admission/isolation decide everything measurable here, so the cell
    pays zero scoring compute per tick."""

    def __init__(self, num_gateways: int, max_batch: int = 1 << 15,
                 name: str = "instant"):
        self.num_gateways = num_gateways
        self.max_batch = max_batch
        self.name = name
        self.engine = None
        self.rows_served = 0

    def submit_many(self, rows: np.ndarray, gws: np.ndarray) -> _InstantBlock:
        self.rows_served += len(rows)
        return _InstantBlock(len(rows))

    def poll(self) -> bool:
        return False

    def drain(self) -> None:
        pass

    def stats(self) -> Dict:
        return {"name": self.name, "rows_served": self.rows_served}


# ---------------------------------------------------------------------- #
#                              shed storm                                #
# ---------------------------------------------------------------------- #


class ShedStormAdversary:
    """Adaptive flood-rate search for an authenticated coalition.

    Each member offers `rows_per_session` rows per tick and the
    coalition reads back its own admitted fraction — the only feedback
    a real flooder gets. While its rows still mostly land it doubles
    the rate (the bucket is not saturated yet); once its accept
    fraction collapses below `min_accept` it HOLDS, because rows past
    saturation are pure send cost for zero extra honest damage. Under
    the isolation defense the same probe converges at the per-session
    cap instead — the defense deflates the storm's growth, not just
    its effect."""

    def __init__(self, n_sessions: int = 4, start_rows: int = 64,
                 growth: float = 2.0, min_accept: float = 0.05,
                 max_rows: int = 1 << 15):
        if n_sessions < 1:
            raise ValueError(f"need >= 1 session, got {n_sessions}")
        if growth <= 1.0:
            raise ValueError(f"growth must be > 1, got {growth}")
        self.n_sessions = n_sessions
        self.rows_per_session = int(start_rows)
        self.growth = float(growth)
        self.min_accept = float(min_accept)
        self.max_rows = int(max_rows)

    def next_rows(self) -> int:
        """Rows each coalition session offers this tick."""
        return self.rows_per_session

    def observe(self, accept_frac: float) -> None:
        """Feed back the coalition's own admitted fraction last tick."""
        if accept_frac > self.min_accept:
            self.rows_per_session = min(
                self.max_rows,
                max(self.rows_per_session + 1,
                    int(self.rows_per_session * self.growth)))
        # else hold: the bucket (or the cap) is already saturated


def _run_storm(*, attack: bool, defended: bool, ticks: int, dim: int,
               honest: int, attackers: int, honest_rows: int,
               capacity: float, session_share: float, tick_s: float,
               seed: int) -> Dict:
    """One storm configuration against the real router stack."""
    n_gw = honest + attackers
    t = [0.0]
    clk = lambda: t[0]  # noqa: E731 — injected clock, ticks advance it
    roster = ServingRoster(member=np.ones(n_gw, bool),
                           generation=np.zeros(n_gw, np.int64))
    adm = AdmissionController(tiers=2, capacity_rows_per_sec=capacity,
                              clock=clk)
    iso = (SessionIsolation(capacity_rows_per_sec=capacity,
                            session_share=session_share, clock=clk)
           if defended else None)
    router = Router([InstantReplica(n_gw)], roster=roster, admission=adm,
                    isolation=iso, clock=clk)
    adv = ShedStormAdversary(n_sessions=attackers)
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((adv.max_rows, dim)).astype(np.float32)

    honest_offered = honest_shed = 0
    atk_offered = atk_admitted = 0
    for _ in range(ticks):
        t[0] += tick_s
        if attack:
            # the coalition claims tier 0 — the client-controlled tier
            # byte costs an attacker nothing, and the guaranteed class
            # converts its flood into bucket debt instead of drops
            burst = adv.next_rows()
            admitted = 0
            for k in range(attackers):
                gid = honest + k
                res = router.submit_many(pool[:burst], np.int32(gid),
                                         tiers=0, session_key=gid)
                res.finalize()
                admitted += int((res.statuses != STATUS_SHED).sum())
            atk_offered += burst * attackers
            atk_admitted += admitted
            adv.observe(admitted / max(1, burst * attackers))
        for gid in range(honest):
            # honest gateways ride the routine tier — the class the
            # storm's token debt starves
            res = router.submit_many(pool[:honest_rows], np.int32(gid),
                                     tiers=1, session_key=gid)
            res.finalize()
            honest_offered += honest_rows
            honest_shed += int((res.statuses == STATUS_SHED).sum())

    return {
        "attack": attack,
        "defended": defended,
        "honest_offered": honest_offered,
        "honest_shed": honest_shed,
        "honest_shed_frac": honest_shed / max(1, honest_offered),
        "attacker_offered": atk_offered,
        "attacker_admitted": atk_admitted,
        "attacker_rows_per_session_final": adv.rows_per_session,
        "rows_isolated": router.rows_isolated,
        "isolation_rows_capped": (iso.rows_capped if iso is not None
                                  else 0),
    }


def shed_storm_cell(ticks: int = 120, dim: int = 8, honest: int = 8,
                    attackers: int = 4, honest_rows: int = 32,
                    capacity: float = 20_000.0,
                    session_share: float = 0.05, tick_s: float = 0.05,
                    seed: int = 0) -> Tuple[List[Dict], Dict]:
    """Grid the storm over {attack, clean} x {defended, undefended}.

    Defaults put honest demand at ~28% of effective capacity (no clean
    shedding) with each honest session well under the isolation cap,
    and give the coalition room to ramp 3 orders of magnitude past
    capacity. `session_share` is sized so the whole coalition capped at
    its share still leaves capacity for the honest load — the
    deployment rule DESIGN.md §22 states (share * expected-concurrent-
    floods + honest peak < effective capacity)."""
    common = dict(ticks=ticks, dim=dim, honest=honest, attackers=attackers,
                  honest_rows=honest_rows, capacity=capacity,
                  session_share=session_share, tick_s=tick_s, seed=seed)
    rows = [_run_storm(attack=atk, defended=dfd, **common)
            for atk in (True, False) for dfd in (False, True)]
    by = {(r["attack"], r["defended"]): r for r in rows}
    summary = {
        "undefended_honest_shed_frac": by[(True, False)]["honest_shed_frac"],
        "defended_honest_shed_frac": by[(True, True)]["honest_shed_frac"],
        "clean_undefended_shed_frac": by[(False, False)]["honest_shed_frac"],
        "clean_defended_shed_frac": by[(False, True)]["honest_shed_frac"],
        # clean cost of the defense: extra honest shedding + any honest
        # rows the per-session cap touched with no storm running
        "clean_cost_shed_frac": (by[(False, True)]["honest_shed_frac"]
                                 - by[(False, False)]["honest_shed_frac"]),
        "clean_rows_isolated": by[(False, True)]["rows_isolated"],
        "attacker_final_rate_undefended":
            by[(True, False)]["attacker_rows_per_session_final"],
        "attacker_final_rate_defended":
            by[(True, True)]["attacker_rows_per_session_final"],
    }
    return rows, summary


# ---------------------------------------------------------------------- #
#                              cost gaming                               #
# ---------------------------------------------------------------------- #


class CostGamingAdversary:
    """Duty-cycles load against the autoscaler's shrink policy.

    The adversary cannot read the scaler, but it can infer fleet size
    from its own service quality (latency / shed on probe traffic); the
    simulation gives it that inference directly as `supply_replicas`.
    Policy: burst the moment the fleet cannot cover the burst (hit the
    downscaled plane, force shed + a scale-up), idle the moment it can
    (bait the next scale-down). Every completed cycle costs the
    operator shed rows during the scale-up lag and two billed fleet
    changes."""

    def __init__(self, burst_rows_per_sec: float = 30_000.0,
                 idle_rows_per_sec: float = 500.0):
        if burst_rows_per_sec <= idle_rows_per_sec:
            raise ValueError("burst must exceed idle load")
        self.burst = float(burst_rows_per_sec)
        self.idle = float(idle_rows_per_sec)

    def next_load(self, supply_rows_per_sec: float) -> float:
        """Arrival rate this tick, given the inferred fleet supply."""
        return self.burst if supply_rows_per_sec < self.burst else self.idle


def _run_gaming(*, gaming: bool, confirm_ticks: int, ticks: int,
                replica_rows_per_sec: float, usd_per_hour: float,
                max_replicas: int, burst: float, idle: float,
                cooldown_s: float, tick_s: float,
                honest_drop_tick: int) -> Dict:
    """One trace against a real SLOAutoscaler: `gaming=True` runs the
    adaptive adversary; `gaming=False` runs the honest trace (steady
    burst-level load that PERMANENTLY drops to idle at
    `honest_drop_tick` — the clean-cost probe: how much longer does a
    confirmed scale-down keep the big fleet around?)."""
    t = [0.0]
    clk = lambda: t[0]  # noqa: E731
    spec = BackendSpec("cpu", rows_per_sec=replica_rows_per_sec,
                       usd_per_hour=usd_per_hour,
                       max_replicas=max_replicas)
    scaler = SLOAutoscaler(budget_ms=25.0, backends=[spec],
                           cooldown_s=cooldown_s,
                           scale_down_confirm_ticks=confirm_ticks,
                           clock=clk)
    adv = CostGamingAdversary(burst_rows_per_sec=burst,
                              idle_rows_per_sec=idle)
    need = max(1, math.ceil(burst / scaler.target_utilization
                            / replica_rows_per_sec))
    current = {"cpu": min(need, max_replicas)}

    overload_ticks = flaps = 0
    shed_rows = 0.0
    replica_ticks = 0
    scale_down_applied_tick: Optional[int] = None
    for tick in range(ticks):
        t[0] += tick_s
        supply = replica_rows_per_sec * current["cpu"]
        if gaming:
            arrival = adv.next_load(supply)
        else:
            arrival = burst if tick < honest_drop_tick else idle
        if arrival > supply:
            overload_ticks += 1
            shed_rows += (arrival - supply) * tick_s
        d = scaler.decide(arrival_rows_per_sec=arrival, p99_ms=None,
                          current=current)
        if d.action != "hold":
            current = dict(d.replicas)
            scaler.mark_applied()
            flaps += 1
            if (d.action == "scale_down"
                    and scale_down_applied_tick is None
                    and tick >= honest_drop_tick):
                scale_down_applied_tick = tick
        replica_ticks += current["cpu"]

    return {
        "gaming": gaming,
        "confirm_ticks": confirm_ticks,
        "ticks": ticks,
        "overload_ticks": overload_ticks,
        "shed_rows": round(shed_rows, 1),
        "scale_flaps": flaps,
        "replica_ticks": replica_ticks,
        "usd": round(replica_ticks * tick_s / 3600.0 * usd_per_hour, 6),
        "scale_down_lag_ticks": (
            None if scale_down_applied_tick is None
            else scale_down_applied_tick - honest_drop_tick),
    }


def cost_gaming_cell(ticks: int = 240, confirm_defended: int = 8,
                     replica_rows_per_sec: float = 10_000.0,
                     usd_per_hour: float = 0.10, max_replicas: int = 8,
                     burst: float = 30_000.0, idle: float = 500.0,
                     cooldown_s: float = 2.0, tick_s: float = 1.0,
                     honest_drop_tick: int = 60
                     ) -> Tuple[List[Dict], Dict]:
    """Grid the duty-cycle attack over {gaming, honest} x {confirm=1,
    confirm=confirm_defended}. Attack damage = shed rows + scale flaps
    per trace; clean cost = extra idle replica-ticks the confirmed
    scale-down keeps billed after an honest load drop."""
    common = dict(ticks=ticks, replica_rows_per_sec=replica_rows_per_sec,
                  usd_per_hour=usd_per_hour, max_replicas=max_replicas,
                  burst=burst, idle=idle, cooldown_s=cooldown_s,
                  tick_s=tick_s, honest_drop_tick=honest_drop_tick)
    rows = [_run_gaming(gaming=g, confirm_ticks=k, **common)
            for g in (True, False) for k in (1, confirm_defended)]
    by = {(r["gaming"], r["confirm_ticks"]): r for r in rows}
    und, dfd = by[(True, 1)], by[(True, confirm_defended)]
    cl_und, cl_dfd = by[(False, 1)], by[(False, confirm_defended)]
    summary = {
        "undefended_shed_rows": und["shed_rows"],
        "defended_shed_rows": dfd["shed_rows"],
        "undefended_scale_flaps": und["scale_flaps"],
        "defended_scale_flaps": dfd["scale_flaps"],
        "undefended_overload_ticks": und["overload_ticks"],
        "defended_overload_ticks": dfd["overload_ticks"],
        # clean cost: a genuinely idle plane scales down late by
        # ~(confirm_ticks - 1) ticks; billed as extra replica-ticks
        "clean_scale_down_lag_undefended": cl_und["scale_down_lag_ticks"],
        "clean_scale_down_lag_defended": cl_dfd["scale_down_lag_ticks"],
        "clean_extra_replica_ticks": (cl_dfd["replica_ticks"]
                                      - cl_und["replica_ticks"]),
        "clean_extra_usd": round(cl_dfd["usd"] - cl_und["usd"], 6),
        "clean_overload_ticks_defended": cl_dfd["overload_ticks"],
    }
    return rows, summary

"""Red-team attack-success-against-defense grids on the PyTorch port (the
port of redteam_sweep.py, on fedmse_tpu_torch/redteam/).

Each cell attacks one decision surface with an adaptive adversary that
reads the defender's state, and measures the paired defense's bite and
its clean cost:

  * **cluster-assignment poisoning**: insiders of a victim cluster
    scale-poison their updates (the harm: honest co-members' AUC), and
    mimics forge their latent statistics toward the victim's pooled
    Gaussian (mimic_latent_stats, over a grid of blends). Defense:
    assignment hysteresis (refit_with_hysteresis). Where the capture
    window opens depends on the fit, so on the init: the row records the
    blends where the defense holds. Blend 1.0 is the victim's Gaussian
    itself, which no statistics-based assignment can tell apart.
  * **flywheel slow-drift self-poisoning**: SlowDriftAdversary walks its
    traffic toward a target just inside the verdict envelope, and every
    threshold refit over the poisoned reservoir widens the envelope.
    Defense: reservoir admission hardening (FlywheelBuffer margin_frac
    floor and influence_cap). The detector is the analytic
    distance-to-centroid scorer: the attack and the defense live in the
    admission policy.
  * **sybil churn**: a coalition rides elastic joins into the fleet and
    votes for its own candidates (lie_votes). Defense: the tenure gate
    (min_tenure). A paired probe measures the recovery-waiver abuse
    (repeated large-delta broadcasts each accepted as "recovery") against
    the cumulative recovery_budget.
  * **ingest plane** (redteam/ingest.py): the shed storm against
    admission and cost gaming against the autoscaler.

Clean-cost rows pin that the defenses are free when nobody attacks: a
null RedteamSpec is bit-equal to no spec, and each defense's clean AUC
delta is bounded (<= 2e-3).

Writes REDTEAM_torch.json (--out), one JSON line per row. On the card:
`python3 redteam_sweep_torch.py --out REDTEAM_torch_h100.json`; on the
CPU add `--device cpu`.
"""

import dataclasses
import json
import os
import sys
import time

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import sweep_data_torch as sweep  # noqa: E402

DIM = 16
ROUNDS = 6
CLEAN_AUC_EPS = 2e-3
MIMIC_BLENDS = (0.7, 0.75, 0.8, 0.85, 0.9, 0.95, 1.0)
STATE_FIELDS = ("params", "prev_global", "hist_params", "hist_perf",
                "hist_seen", "rejected", "waived")


def base_cfg(**kw):
    from fedmse_tpu_torch.config import CompatConfig, ExperimentConfig
    base = dict(
        dim_features=DIM, hidden_neus=12, latent_dim=5, epochs=6,
        batch_size=16, num_rounds=ROUNDS, network_size=8,
        compat=CompatConfig(vote_tie_break=False))
    base.update(kw)
    return ExperimentConfig(**base)


def _stack(cfg, clients, device):
    from fedmse_tpu_torch.data import build_dev_dataset, stack_clients
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    dev_x = build_dev_dataset(clients, ExperimentRngs(
        run=0, data_seed=cfg.data_seed).data_rng)
    return stack_clients(clients, dev_x, cfg.batch_size,
                         device=device), len(clients)


def build_typed_grid(cfg, n_clients=8, types=2, seed=11, *, device="cuda"):
    from fedmse_tpu_torch.data.synthetic import synthetic_typed_clients
    return _stack(cfg, synthetic_typed_clients(
        n_clients=n_clients, types=types, dim=cfg.dim_features,
        n_normal=200, n_abnormal=80, seed=seed), device)


def build_plain_grid(cfg, n_clients, *, device="cuda"):
    from fedmse_tpu_torch.data import synthetic_clients
    return _stack(cfg, synthetic_clients(
        n_clients=n_clients, dim=cfg.dim_features, n_normal=160,
        n_abnormal=64), device)


def run_cell(cfg, data, n_real, spec=None, elastic=None, redteam=None,
             model_type="autoencoder", label="cell", *, states=None,
             elastic_masks=None):
    """One federation on `data`'s device; returns (per-gateway final AUC,
    results, engine). `states` replaces the engine's own init and
    `elastic_masks` (with an ElasticSpec) the membership timeline."""
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs

    del label
    model = make_model(model_type, cfg.dim_features, cfg.hidden_neus,
                       cfg.latent_dim, shrink_lambda=cfg.shrink_lambda,
                       device=data.train_xb.device)
    engine = RoundEngine(model, cfg, data, n_real=n_real,
                         rngs=ExperimentRngs(run=0, data_seed=cfg.data_seed),
                         model_type=model_type, update_type="mse_avg",
                         fused=True, cluster=spec, elastic=elastic,
                         elastic_masks=elastic_masks, redteam=redteam,
                         states=states)
    results, _, _ = engine.run_schedule_chunk(0, cfg.num_rounds)
    return engine.evaluate(), results, engine


def same_states(a, b) -> bool:
    """Two ClientStates equal bit for bit."""
    return all(torch.equal(getattr(a, k), getattr(b, k))
               for k in STATE_FIELDS) and all(
        torch.equal(x, y) for x, y in zip(a.opt_state, b.opt_state))


# ------------------------------------------------- defenses-off pin ----

def defenses_off_pin(device="cuda", states=None):
    """RedteamSpec() (null) against no spec at all: the states bit for bit
    after a short schedule; defenses off cost nothing."""
    from fedmse_tpu_torch.redteam import RedteamSpec

    cfg = base_cfg(num_rounds=3)
    data, n_real = build_plain_grid(cfg, 6, device=device)
    _, _, plain = run_cell(cfg, data, n_real, label="pin-plain",
                           states=states)
    _, _, null = run_cell(cfg, data, n_real, redteam=RedteamSpec(),
                          label="pin-null", states=states)
    return {"label": "defenses_off_bitwise_pin",
            "states_bit_identical": same_states(plain.states, null.states)}


# ------------------------------------- A. cluster-assignment poisoning ----

def mimicry_captures(fit, k, device):
    """(adversaries, victim, {blend: (plain-refit capture, hysteresis-0.5
    capture)}): two gateways outside gateway 0's cluster forge their
    latent statistics toward it at each of MIMIC_BLENDS."""
    from fedmse_tpu_torch.cluster import refit_with_hysteresis
    from fedmse_tpu_torch.redteam import (assignment_capture_rate,
                                          mimic_latent_stats)
    a = fit.assignment
    victim = int(a[0])
    adv = tuple(int(i) for i in np.flatnonzero(a != victim)[:2])
    captures = {}
    for blend in MIMIC_BLENDS:
        fm, fc = mimic_latent_stats(fit.means, fit.covs, adv,
                                    fit.cl_means[victim],
                                    fit.cl_covs[victim], blend)
        captures[blend] = tuple(assignment_capture_rate(
            refit_with_hysteresis(fm, fc, a, k, h, device=device)
            .assignment, adv, victim) for h in (0.0, 0.5))
    return adv, victim, captures


def defended_blends(captures):
    """The blends where the plain refit captures >= half the coalition and
    hysteresis at most half as many."""
    return [b for b, (plain, held) in captures.items()
            if plain >= 0.5 and held <= 0.5 * plain]


def window_blend(window):
    """The blend the cluster bar is read at: the reference's 0.8 where it
    lies in the defended window, else the window's first blend (0.8 when
    the window is empty, so the bar fails there)."""
    if 0.8 in window or not window:
        return 0.8
    return window[0]


def cluster_cells(device="cuda", states=None):
    from fedmse_tpu_torch.cluster import ClusterSpec
    from fedmse_tpu_torch.redteam import RedteamSpec

    rows = []
    cfg = base_cfg()
    data, n_real = build_typed_grid(cfg, device=device)
    spec = ClusterSpec(k=2)

    # the clean clustered baseline: the fit the mimics forge against
    clean, _, eng = run_cell(cfg, data, n_real, spec=spec, label="clean-k2",
                             states=states)
    fit = eng.cluster_fit
    assignment = fit.assignment
    victim = int(assignment[0])
    members = np.flatnonzero(assignment == victim)
    outsiders = np.flatnonzero(assignment != victim)

    # ---- insider poison harm: 2 victim-cluster insiders scale their
    # updates; success = honest co-members' AUC drop ----
    insiders = tuple(int(i) for i in members[:2])
    honest = np.setdiff1d(members, insiders)
    atk = RedteamSpec(kind="cluster_poison", adversaries=insiders,
                      victim_cluster=victim, poison="scale", strength=8.0)
    poisoned, _, _ = run_cell(cfg, data, n_real, spec=spec, redteam=atk,
                              label="insider-poison", states=states)
    harm = float(np.nanmean(clean[honest]) - np.nanmean(poisoned[honest]))
    rows.append({
        "label": "cluster/insider_poison_harm",
        "victim_cluster": victim, "insiders": list(insiders),
        "honest_members": honest.tolist(),
        "clean_auc_honest": round(float(np.nanmean(clean[honest])), 4),
        "poisoned_auc_honest": round(float(np.nanmean(poisoned[honest])), 4),
        "undefended_auc_drop": round(harm, 4),
        "outsider_auc_delta": round(
            float(np.nanmean(clean[outsiders])
                  - np.nanmean(poisoned[outsiders])), 4),
    })

    # ---- mimicry capture against hysteresis, over the blend grid ----
    adv_ids, _, captures = mimicry_captures(fit, spec.k, device)
    window = defended_blends(captures)
    at = window_blend(window)
    undef, defended = captures[at]
    rows.append({
        "label": "cluster/mimicry_capture",
        "adversaries": list(adv_ids), "victim_cluster": victim,
        "capture_by_blend": {
            str(b): {"undefended_h0": c[0], "hysteresis_h0.5": c[1]}
            for b, c in captures.items()},
        "undefended_capture_at_0.8": captures[0.8][0],
        "defended_capture_at_0.8": captures[0.8][1],
        "defended_blends": window,
        "window_blend": at,
        "provable_failure": "blend=1.0 equals the victim's pooled "
                            "Gaussian exactly; capture_by_blend['1.0'] "
                            "shows hysteresis cannot (and should not "
                            "claim to) separate a perfect forgery",
    })

    # ---- clean cost: hysteresis on a refitting clean run ----
    c0, _, _ = run_cell(cfg, data, n_real,
                        spec=ClusterSpec(k=2, refit_every=2),
                        label="clean-h0", states=states)
    c1, _, _ = run_cell(cfg, data, n_real,
                        spec=ClusterSpec(k=2, refit_every=2, hysteresis=0.5),
                        label="clean-h0.5", states=states)
    clean_delta = float(abs(np.nanmean(c0) - np.nanmean(c1)))
    rows.append({
        "label": "cluster/hysteresis_clean_cost",
        "clean_auc_h0": round(float(np.nanmean(c0)), 4),
        "clean_auc_h0.5": round(float(np.nanmean(c1)), 4),
        "clean_auc_delta": round(clean_delta, 6),
    })
    return rows, {
        "undefended_capture": undef, "defended_capture": defended,
        "defended_blends": window, "window_blend": at,
        "insider_auc_drop": harm, "clean_auc_delta": clean_delta,
    }


# --------------------------------------- B. flywheel slow-drift loop ----

def drift_loop(margin_frac, steps=60, refit_every=3, seed=3):
    """The closed self-poisoning loop: serve -> verdict -> admit ->
    threshold refit over the reservoir -> serve. The adversary observes
    only its own verdicts; the defender's margin floor decides which
    verdicted-normal rows may enter the reservoir the next threshold is
    fitted from. The threshold is mean + 3 std of the pool's scores,
    floored at the audited seed calibration (the envelope never shrinks
    on unaudited reservoir data)."""
    from fedmse_tpu_torch.flywheel.buffer import FlywheelBuffer
    from fedmse_tpu_torch.redteam import SlowDriftAdversary, normal_fraction

    rng = np.random.default_rng(seed)
    mu0 = np.zeros(DIM, np.float32)
    target = np.zeros(DIM, np.float32)
    target[0] = 8.0

    def score(x):
        return np.mean((x - mu0) ** 2, axis=1)

    def fit(pool_scores):
        return float(pool_scores.mean() + 3.0 * pool_scores.std())

    seed_rows = rng.normal(mu0, 1.0, (512, DIM)).astype(np.float32)
    thr = [fit(score(seed_rows))]
    thr0 = thr[0]

    buf = FlywheelBuffer(
        1, DIM, capacity=8192,
        margin_frac=margin_frac,
        thresholds_fn=(lambda: np.array([thr[0]]))
        if margin_frac is not None else None)
    adv = SlowDriftAdversary(mu0, target, seed=seed, step=0.05)
    admitted_adv = 0
    for t in range(steps):
        batch = adv.next_batch(64)
        sc = score(batch)
        verdicts = sc > thr[0]                       # True = anomalous
        adv.observe(normal_fraction(verdicts))
        admitted_adv += buf.admit(batch, np.zeros(len(batch), np.int64),
                                  verdicts=verdicts, scores=sc)
        if (t + 1) % refit_every == 0:
            # refit over the seed calibration and the reservoir's rows
            pool = np.concatenate([seed_rows, buf.rows_for(0)])
            thr[0] = max(fit(score(pool)), thr0)
    return {
        "final_position": round(adv.position, 4),
        "threshold_inflation": round(thr[0] / thr0, 4),
        "admitted_adversarial_rows": int(admitted_adv),
        "reservoir_rows": int(buf.count[0]),
    }


def flywheel_cells():
    from fedmse_tpu_torch.flywheel.buffer import FlywheelBuffer

    rows = []
    undef = drift_loop(margin_frac=None)
    defended = drift_loop(margin_frac=0.7)
    rows.append({
        "label": "flywheel/slow_drift_self_poisoning",
        "undefended": undef, "margin_frac_0.7": defended,
        "note": "undefended, every near-threshold batch the verdicts "
                "pass enters the refit pool and ratchets the envelope "
                "until the adversary reaches its target; the margin "
                "floor admits only rows well inside the envelope, so "
                "the refit pool cannot walk and the adversary stalls at "
                "the fixed envelope's operating point",
    })

    # ---- influence cap: a flooding gateway's share of finetune rows ----
    lens = {}
    for cap in (None, 0.34):
        rng = np.random.default_rng(0)
        buf = FlywheelBuffer(3, DIM, capacity=1024, influence_cap=cap)
        buf.admit(rng.normal(size=(400, DIM)), np.full(400, 0))
        buf.admit(rng.normal(size=(60, DIM)), np.full(60, 1))
        buf.admit(rng.normal(size=(60, DIM)), np.full(60, 2))
        ft = buf.build_finetune_data(
            16, dev_x=np.zeros((8, DIM), np.float32), min_rows=8)
        n = [len(r) for r in ft.train_rows]
        lens[cap] = {"rows_per_gateway": n,
                     "flooder_share": round(n[0] / max(1, sum(n)), 4)}
    rows.append({
        "label": "flywheel/influence_cap",
        "uncapped": lens[None], "cap_0.34": lens[0.34],
    })

    # ---- clean cost: drift-free traffic, margin on and off; the
    # detector's verdict accuracy on held-out normals and fixed anomalies
    # after the loop ----
    rng = np.random.default_rng(9)
    mu0 = np.zeros(DIM, np.float32)

    def fit(pool_scores):
        return float(pool_scores.mean() + 3.0 * pool_scores.std())

    def clean_loop(margin):
        seed_rows = rng.normal(mu0, 1.0, (512, DIM)).astype(np.float32)
        thr0 = fit(np.mean(seed_rows ** 2, axis=1))
        thr = [thr0]
        buf = FlywheelBuffer(
            1, DIM, capacity=4096, margin_frac=margin,
            thresholds_fn=(lambda: np.array([thr[0]]))
            if margin is not None else None)
        streamed = admitted = 0
        for t in range(20):
            batch = rng.normal(mu0, 1.0, (64, DIM)).astype(np.float32)
            sc = np.mean(batch ** 2, axis=1)
            verd = sc > thr[0]
            streamed += int((~verd).sum())
            admitted += buf.admit(batch, np.zeros(64, np.int64),
                                  verdicts=verd, scores=sc)
            if (t + 1) % 5 == 0:
                pool = np.concatenate([seed_rows, buf.rows_for(0)])
                thr[0] = max(fit(np.mean(pool ** 2, axis=1)), thr0)
        return thr[0], admitted / max(1, streamed)

    eval_rng = np.random.default_rng(123)
    normals = eval_rng.normal(mu0, 1.0, (512, DIM)).astype(np.float32)
    anoms = (eval_rng.normal(mu0, 1.0, (512, DIM)).astype(np.float32)
             + 1.2)

    def auc_at(thr):
        # the scorer is fixed, so the defense can only move the threshold:
        # the clean-cost axis is the verdict accuracy at it
        sn = np.mean(normals ** 2, axis=1) > thr
        sa = np.mean(anoms ** 2, axis=1) > thr
        return 0.5 * ((~sn).mean() + sa.mean())

    thr_off, ret_off = clean_loop(None)
    thr_on, ret_on = clean_loop(0.7)
    clean_delta = float(abs(auc_at(thr_on) - auc_at(thr_off)))
    rows.append({
        "label": "flywheel/margin_clean_cost",
        "threshold_margin_off": round(thr_off, 4),
        "threshold_margin_on": round(thr_on, 4),
        "clean_admission_retention": round(ret_on / max(ret_off, 1e-9), 4),
        "clean_verdict_auc_delta": round(clean_delta, 6),
    })
    return rows, {
        "undefended_position": undef["final_position"],
        "defended_position": defended["final_position"],
        "undefended_inflation": undef["threshold_inflation"],
        "defended_inflation": defended["threshold_inflation"],
        "flooder_share_uncapped": lens[None]["flooder_share"],
        "flooder_share_capped": lens[0.34]["flooder_share"],
        "clean_auc_delta": clean_delta,
    }


# ------------------------------------------------- C. sybil churn ----

def sybil_cells(device="cuda", states=None, elastic_masks=None, cfg=None):
    """The join blitz: half the fleet are founders, the other half's slots
    open at round 8 and fill fast; the coalition is exactly the slots the
    wave recycles and bids for the coordinator role. `cfg` (default: 12
    clients, 16 rounds) sizes the fleet; `states` and `elastic_masks`
    replace the init and the membership timeline of every cell."""
    from fedmse_tpu_torch.federation.elastic import ElasticSpec
    from fedmse_tpu_torch.redteam import RedteamSpec

    rows = []
    cfg = cfg or base_cfg(network_size=12, num_rounds=16)
    data, n_real = build_plain_grid(cfg, cfg.network_size, device=device)
    elastic = ElasticSpec(leave_p=0.0, join_p=0.9,
                          initial_member_frac=0.5,
                          join_window=(8, None))
    carry = dict(states=states, elastic_masks=elastic_masks)

    # scout the (red-team-independent) elastic timeline
    clean, clean_res, scout = run_cell(cfg, data, n_real, elastic=elastic,
                                       label="sybil-scout", **carry)
    scout._elastic_masks(0, cfg.num_rounds)
    gen = np.asarray(scout._elastic_premade.generation)[:, :n_real]
    recycled = np.flatnonzero(gen.max(axis=0) > 0)
    adv_ids = tuple(int(i) for i in recycled)

    blitz_start = 8

    def capture(results, start=0):
        agg_rounds = [r.aggregator for r in results[start:]
                      if r.aggregator is not None]
        if not agg_rounds:
            return 0.0, 0
        hits = sum(1 for a in agg_rounds if a in adv_ids)
        return hits / len(agg_rounds), len(agg_rounds)

    cells = {}
    for name, spec in (
            ("undefended", RedteamSpec(kind="sybil", adversaries=adv_ids,
                                       lie_votes=True)),
            ("min_tenure_6", RedteamSpec(kind="sybil", adversaries=adv_ids,
                                         lie_votes=True, min_tenure=6))):
        auc, results, _ = run_cell(cfg, data, n_real, elastic=elastic,
                                   redteam=spec, label=f"sybil-{name}",
                                   **carry)
        rate, n_agg = capture(results)
        wrate, wn = capture(results, blitz_start)
        cells[name] = {"capture_rate": round(rate, 4),
                       "capture_rate_post_blitz": round(wrate, 4),
                       "aggregated_rounds": n_agg,
                       "aggregated_rounds_post_blitz": wn,
                       "auc_mean": round(float(np.nanmean(auc)), 4)}
    base_rate, _ = capture(clean_res)
    base_wrate, _ = capture(clean_res, blitz_start)
    rows.append({
        "label": "sybil/election_capture",
        "adversaries": list(adv_ids),
        "recycled_slots": recycled.tolist(),
        "blitz_start_round": blitz_start,
        "honest_baseline_capture": round(base_rate, 4),
        "honest_baseline_capture_post_blitz": round(base_wrate, 4),
        **cells,
        "note": "before the blitz no coalition slot is even a member; "
                "the post-blitz rates are the attack's operating window",
    })

    # ---- clean cost: the tenure gate on an honest churning fleet ----
    defonly, defres, _ = run_cell(
        cfg, data, n_real, elastic=elastic,
        redteam=RedteamSpec(min_tenure=6), label="sybil-defonly", **carry)
    deferred = sum(
        1 for a, b in zip(clean_res, defres)
        if (a.aggregator is None) != (b.aggregator is None)
        or (a.aggregator is not None and a.aggregator != b.aggregator))
    clean_delta = float(abs(np.nanmean(clean) - np.nanmean(defonly)))
    rows.append({
        "label": "sybil/tenure_gate_clean_cost",
        "clean_auc": round(float(np.nanmean(clean)), 4),
        "defense_only_auc": round(float(np.nanmean(defonly)), 4),
        "clean_auc_delta": round(clean_delta, 6),
        "elections_changed": deferred,
        "note": "the gate defers recycled tenants' candidacy and votes "
                "even when honest; its residual cost is the elections it "
                "re-routes, bounded by the join rate",
    })
    return rows, {
        "undefended_capture": cells["undefended"]["capture_rate_post_blitz"],
        "defended_capture": cells["min_tenure_6"]["capture_rate_post_blitz"],
        "honest_baseline": base_wrate,
        "clean_auc_delta": clean_delta,
    }


# --------------------------------- verification recovery-waiver abuse ----

def waiver_abuse_cell(device="cuda", states=None):
    """An adversary controlling broadcasts ships a sequence of large-delta
    models, each passing the recovery waiver on its own: undefended the
    cumulative accepted Frobenius influence grows linearly, and
    recovery_budget caps it. `states` (4 clients of the 16/27/7 hybrid)
    replaces the port's own init."""
    from fedmse_tpu_torch.federation.state import init_client_states
    from fedmse_tpu_torch.federation.verification import make_verify_fn
    from fedmse_tpu_torch.models import make_model

    n, probes = 4, 6
    model = make_model("hybrid", DIM, device=device)
    if states is None:
        states = init_client_states(model, n, torch.Generator().manual_seed(0),
                                    device=device)
    states0 = dataclasses.replace(
        states, hist_seen=torch.ones((n,), dtype=torch.bool, device=device))
    common = dict(verification_threshold=1e-6, performance_threshold=10.0,
                  hardened=True, recovery_threshold=-1.0,
                  recovery_delta_cap=1e9)
    ver_x = torch.zeros((n, 6, DIM), device=device)
    ver_m = torch.ones((n, 6), device=device)
    aggs = [states0.params[0] + 0.5 * (r + 1) for r in range(probes)]

    def run(budget):
        verify = make_verify_fn(model, recovery_budget=budget, **common)
        states, accepted = states0, 0
        for agg in aggs:
            out = verify(states, agg, ver_x, ver_m,
                         torch.zeros((n,), device=device),
                         torch.ones((n,), device=device))
            accepted += int(out.accepted.sum())
            states = out.states
        return accepted, float(states.waived.max())

    acc_off, waived_off = run(None)
    budget = waived_off / probes * 1.5          # ~1.5 probes' worth
    acc_on, waived_on = run(budget)
    return {
        "label": "verification/recovery_waiver_abuse",
        "probes": probes,
        "undefended": {"accepted": acc_off,
                       "cumulative_waived_frobenius": round(waived_off, 4)},
        "recovery_budget": round(budget, 4),
        "defended": {"accepted": acc_on,
                     "cumulative_waived_frobenius": round(waived_on, 4)},
    }, {
        "undefended_waived": waived_off,
        "defended_waived": waived_on,
        "budget": budget,
    }


def quick_cell(device="cuda"):
    """The reduced red-team guard: the defenses-off bitwise pin, the
    mimicry capture (plain refit against hysteresis 0.5) at the blend the
    cluster bar reads (`window_blend`: 0.8 where the fit puts it in the
    defended window), and the reservoir margin-floor admission bound."""
    from fedmse_tpu_torch.cluster import ClusterSpec
    from fedmse_tpu_torch.flywheel.buffer import FlywheelBuffer

    pin = defenses_off_pin(device)["states_bit_identical"]

    cfg = base_cfg()
    data, n_real = build_typed_grid(cfg, device=device)
    spec = ClusterSpec(k=2)
    _, _, eng = run_cell(cfg, data, n_real, spec=spec, label="quick-clean")
    _, _, captures = mimicry_captures(eng.cluster_fit, spec.k, device)
    window = defended_blends(captures)
    at = window_blend(window)
    undef, defended = captures[at]

    # margin floor: of four near-threshold verdicted-normal rows, only
    # the ones below thr * (1 - margin) may enter the refit reservoir
    thr = np.array([1.0], np.float32)
    buf = FlywheelBuffer(1, DIM, capacity=64, margin_frac=0.5,
                         thresholds_fn=lambda: thr)
    sc = np.array([0.2, 0.9, 0.4, 0.51], np.float32)
    admitted = buf.admit(np.zeros((4, DIM), np.float32),
                         np.zeros(4, np.int64),
                         verdicts=np.zeros(4, bool), scores=sc)

    ok = bool(pin and undef >= 0.5 and defended <= 0.5 * undef
              and admitted == 2)
    return {"defenses_off_bitwise": bool(pin),
            "mimicry_blend_0.8": {"undefended_capture": captures[0.8][0],
                                  "hysteresis_0.5_capture":
                                      captures[0.8][1]},
            "mimicry_at_window": {"blend": at, "undefended_capture": undef,
                                  "hysteresis_0.5_capture": defended},
            "defended_blends": window,
            "margin_floor_admitted": {"scores": sc.tolist(),
                                      "threshold": 1.0, "margin_frac": 0.5,
                                      "admitted": int(admitted)},
            "acceptance_met": ok}


def factor(a, b, floor=1e-9):
    return round(a / max(b, floor), 2)


def acceptance_block(pin, cl, fw, sy, wv, st, cg):
    """The sweep's `acceptance` from each cell family's summary dict."""
    acceptance = {
        "bar": "each adversary's undefended success quantified; the "
               "paired defense cuts it by the stated factor; clean AUC "
               "deltas <= 2e-3; defenses-off bitwise-identical to "
               "no-redteam",
        "defenses_off_bitwise": pin["states_bit_identical"],
        "cluster": {
            "undefended_capture": cl["undefended_capture"],
            "defended_capture": cl["defended_capture"],
            "defense_factor": factor(cl["undefended_capture"],
                                     cl["defended_capture"]),
            "insider_auc_drop": round(cl["insider_auc_drop"], 4),
            "clean_auc_delta": round(cl["clean_auc_delta"], 6),
            "met": bool(cl["undefended_capture"] >= 0.5
                        and cl["defended_capture"]
                        <= 0.5 * cl["undefended_capture"]
                        and cl["clean_auc_delta"] <= CLEAN_AUC_EPS),
        },
        "flywheel": {
            "undefended_position": fw["undefended_position"],
            "defended_position": fw["defended_position"],
            "defense_factor": factor(fw["undefended_position"],
                                     fw["defended_position"]),
            "threshold_inflation": {
                "undefended": fw["undefended_inflation"],
                "defended": fw["defended_inflation"]},
            "flooder_share": {
                "uncapped": fw["flooder_share_uncapped"],
                "capped": fw["flooder_share_capped"]},
            "clean_auc_delta": round(fw["clean_auc_delta"], 6),
            # the success axis is the self-poisoning itself, how far the
            # envelope walked (inflation - 1)
            "met": bool(fw["undefended_inflation"] >= 1.5
                        and abs(fw["defended_inflation"] - 1.0)
                        <= 0.2 * (fw["undefended_inflation"] - 1.0)
                        and fw["defended_position"]
                        < fw["undefended_position"]
                        and fw["flooder_share_capped"]
                        < fw["flooder_share_uncapped"]
                        and fw["clean_auc_delta"] <= CLEAN_AUC_EPS),
        },
        "sybil": {
            "undefended_capture": sy["undefended_capture"],
            "defended_capture": sy["defended_capture"],
            "honest_baseline": sy["honest_baseline"],
            "defense_factor": factor(sy["undefended_capture"],
                                     sy["defended_capture"]),
            "clean_auc_delta": round(sy["clean_auc_delta"], 6),
            "met": bool(sy["undefended_capture"] > sy["honest_baseline"]
                        and sy["defended_capture"]
                        <= 0.5 * sy["undefended_capture"]
                        and sy["clean_auc_delta"] <= CLEAN_AUC_EPS),
        },
        "waiver": {
            "undefended_waived": round(wv["undefended_waived"], 4),
            "defended_waived": round(wv["defended_waived"], 4),
            "budget": round(wv["budget"], 4),
            "met": bool(wv["defended_waived"]
                        <= 0.5 * wv["undefended_waived"]),
        },
        "shed_storm": {
            "undefended_honest_shed_frac":
                round(st["undefended_honest_shed_frac"], 4),
            "defended_honest_shed_frac":
                round(st["defended_honest_shed_frac"], 4),
            "defense_factor": factor(st["undefended_honest_shed_frac"],
                                     st["defended_honest_shed_frac"]),
            "clean_cost_shed_frac": round(st["clean_cost_shed_frac"], 6),
            "met": bool(st["undefended_honest_shed_frac"] >= 0.5
                        and st["defended_honest_shed_frac"]
                        <= 0.1 * st["undefended_honest_shed_frac"]
                        and st["clean_cost_shed_frac"] <= 1e-6
                        and st["clean_rows_isolated"] == 0),
        },
        "cost_gaming": {
            "undefended_shed_rows": round(cg["undefended_shed_rows"], 1),
            "defended_shed_rows": round(cg["defended_shed_rows"], 1),
            "shed_defense_factor": factor(cg["undefended_shed_rows"],
                                          cg["defended_shed_rows"]),
            "scale_flaps": {"undefended": cg["undefended_scale_flaps"],
                            "defended": cg["defended_scale_flaps"]},
            "flap_defense_factor": factor(cg["undefended_scale_flaps"],
                                          cg["defended_scale_flaps"]),
            "clean_extra_usd": cg["clean_extra_usd"],
            "met": bool(cg["defended_shed_rows"]
                        <= 0.5 * cg["undefended_shed_rows"]
                        and cg["defended_scale_flaps"]
                        <= 0.5 * cg["undefended_scale_flaps"]
                        and cg["clean_overload_ticks_defended"] == 0),
        },
    }
    if "window_blend" in cl:
        acceptance["cluster"]["blend"] = cl["window_blend"]
        acceptance["cluster"]["defended_blends"] = cl["defended_blends"]
    acceptance["met"] = bool(
        acceptance["defenses_off_bitwise"]
        and acceptance["cluster"]["met"] and acceptance["flywheel"]["met"]
        and acceptance["sybil"]["met"] and acceptance["waiver"]["met"]
        and acceptance["shed_storm"]["met"]
        and acceptance["cost_gaming"]["met"])
    return acceptance


def main(argv=None):
    args = sweep.parser(__doc__, "REDTEAM_torch.json").parse_args(argv)
    device, prov = sweep.start(args)
    from fedmse_tpu_torch.redteam import cost_gaming_cell, shed_storm_cell

    t0 = time.perf_counter()
    rows = []

    def emit(row, t_row):
        row = {**row, "wall_s": time.perf_counter() - t_row}
        rows.append(row)
        print(json.dumps(row), flush=True)
        return row

    t = time.perf_counter()
    pin = emit(defenses_off_pin(device), t)
    t = time.perf_counter()
    cl_rows, cl = cluster_cells(device)
    for r in cl_rows:
        emit(r, t)
    t = time.perf_counter()
    fw_rows, fw = flywheel_cells()
    for r in fw_rows:
        emit(r, t)
    t = time.perf_counter()
    sy_rows, sy = sybil_cells(device)
    for r in sy_rows:
        emit(r, t)
    t = time.perf_counter()
    wv_row, wv = waiver_abuse_cell(device)
    emit(wv_row, t)
    t = time.perf_counter()
    st_rows, st = shed_storm_cell()
    for r in st_rows:
        emit({"cell": "shed_storm", **r}, t)
    t = time.perf_counter()
    cg_rows, cg = cost_gaming_cell()
    for r in cg_rows:
        emit({"cell": "cost_gaming", **r}, t)

    acceptance = acceptance_block(pin, cl, fw, sy, wv, st, cg)
    out = {
        "metric": "attack success rate vs measured defense across the "
                  "cluster / flywheel / elastic decision surfaces and the "
                  "ingest plane",
        "rows": rows,
        "acceptance": acceptance,
        "total_seconds": time.perf_counter() - t0,
        "wall_note": "a family's rows share one wall_s: the family's",
        **prov,
    }
    sweep.write(args.out, out)
    print(json.dumps({"wrote": args.out,
                      "acceptance_met": acceptance["met"]}))


if __name__ == "__main__":
    main()

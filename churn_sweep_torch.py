"""Elastic-federation churn sweep on the PyTorch port: dynamic membership
x chaos x attack on the 500-client non-IID grid, the 10k-client
capture-once pin, and `--podscale` at 100k gateways on the host-sharded
tier (the port of churn_sweep.py, on fedmse_tpu_torch/federation/
elastic.py).

Slots retire (a tenant leaves), recycle (a new tenant, generation + 1,
params inherited from the incumbent-mean global model), and the round
never rebuilds because membership rides the fused round as [T, N]
per-round inputs.

Protocol:

  * **grid**: 500-client Dirichlet(0.5) non-IID shards
    (synthetic_dirichlet_clients), hybrid + mse_avg, 16 fused rounds, 20%
    participation. Rows: static baseline, null ElasticSpec (bit-equal to
    static), steady churn at 10% and 30% a round;
  * **burst**: a leave burst (leave_p 0.3 over rounds [4, 6), ~51%
    departed), rejoin wave from round 6: rounds_to_recover and the
    late-joiner-vs-incumbent final-AUC gap, per slot against the static
    baseline (cohort means within 2e-3; the per-slot max within
    PER_SLOT_MAX_GAP_CEILING);
  * **composition**: churn x chaos (30% dropout, crash 0.1) x attack
    (scale-50 from round 1);
  * **10k capture-once pin**: a 10k-client fused schedule with 30% a round
    membership churn on one card. After a warm-up chunk (which captures
    the round's CUDA graph bodies) further churning chunks replay the
    same bodies: each body is captured once (`replays == calls - 1`),
    and the null spec is bit-equal to the static round.

`--podscale` runs the churn semantics at 100k gateways on the tiered
engine with `host_sharded=True` (one card: world 1, so the tier's one
block is the fleet), full participation, the vote tie-break on as in the
JAX driver (keyed rows above the tier's size rule, federation/tiered.py):
static, null elastic (bit-equal), steady churn, and the leave burst with
both joiner bars, with an `acceptance` block.

Writes CHURN_torch.json / CHURN_PODSCALE_torch.json (--out) and prints
one line per row. On the card: `python3 churn_sweep_torch.py --out
CHURN_torch_h100.json` and `python3 churn_sweep_torch.py --podscale --out
CHURN_PODSCALE_torch_h100.json`; on the CPU add `--device cpu --clients
40 --pin-clients 200` (`--podscale --device cpu --clients 2000`).
"""

import json
import os
import sys
import time

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

import numpy as np  # noqa: E402

import sweep_data_torch as sweep  # noqa: E402

ROUNDS = 16
BURST = (4, 6)          # leave burst window [start, stop)
GRID_CLIENTS = 500
ALPHA = 0.5
PIN_CLIENTS = 10_000    # the capture-once pin's fleet
PIN_COHORT = 200        # its cohort (2% of 10k)

# Ceiling on the per-slot max joiner deficit against the static baseline;
# the cohort-mean bars stay at 2e-3.
PER_SLOT_MAX_GAP_CEILING = 1e-2


def build_grid(cfg, n_clients, alpha=ALPHA, label_shift=0.0, *,
               device="cuda"):
    """The non-IID churn grid on `device`: Dirichlet(alpha) feature skew
    (and an optional label shift) over synthetic traffic modes."""
    from fedmse_tpu_torch.data import (build_dev_dataset, stack_clients,
                                       synthetic_dirichlet_clients)
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs

    clients = synthetic_dirichlet_clients(
        n_clients=n_clients, dim=cfg.dim_features, rows_per_client=160,
        abnormal_per_client=64, modes=3, alpha=alpha,
        label_shift=label_shift, seed=7)
    rngs = ExperimentRngs(run=0, data_seed=cfg.data_seed)
    dev_x = build_dev_dataset(clients, rngs.data_rng)
    data = stack_clients(clients, dev_x, cfg.batch_size, device=device)
    return data, len(clients)


def run_cell(cfg, data, n_real, elastic, chaos=None, attack=None,
             rounds=ROUNDS, burst=None, label=None, *, states=None,
             chaos_masks=None, elastic_masks=None):
    """One federation on `data`'s device: (row, final per-client metrics
    with slots retired at the horizon NaN, final generations). `states`
    replaces the engine's own init; `chaos_masks` ([T, N] ChaosMasks
    fields) and `elastic_masks` (a MembershipMasks) replace the specs'
    draws, as another engine's `_chaos_masks(0, T)` and
    `_elastic_masks(0, T)` give them."""
    from fedmse_tpu_torch.chaos import membership_metrics, resilience_metrics
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.federation.attack import make_poison_fn
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs

    t_cell = time.perf_counter()
    poison = None if attack is None else make_poison_fn(attack)
    model = make_model("hybrid", cfg.dim_features,
                       shrink_lambda=cfg.shrink_lambda,
                       device=data.train_xb.device)
    engine = RoundEngine(model, cfg, data, n_real=n_real,
                         rngs=ExperimentRngs(run=0, data_seed=cfg.data_seed),
                         model_type="hybrid", update_type="mse_avg",
                         fused=True, poison_fn=poison, chaos=chaos,
                         elastic=elastic, elastic_masks=elastic_masks,
                         states=states)
    if chaos_masks is not None:
        sweep.feed_chaos(engine, chaos_masks)
    results, sec = sweep.timed(engine.run_rounds, 0, rounds)
    final_metrics = engine.evaluate()
    if results[-1].members is not None:
        # a slot retired at the horizon holds its departed tenant's frozen
        # params: NaN it (the driver's final-roster rule), so a stale
        # leaver cannot pose as an incumbent in joiner_incumbent_gap
        member = np.zeros(n_real, bool)
        member[results[-1].members] = True
        final_metrics = np.where(member, final_metrics, np.nan)
    burst_kw = ({} if burst is None
                else {"burst_start": burst[0], "burst_stop": burst[1],
                      "recover_eps": 2e-3})
    row = {
        "label": label or "grid",
        "elastic": None if elastic is None else {
            "leave_p": elastic.leave_p, "join_p": elastic.join_p,
            "preempt_p": elastic.preempt_p,
            "signature": elastic.signature()},
        "chaos": None if chaos is None else {
            "dropout_p": chaos.dropout_p, "crash_p": chaos.crash_p},
        "attack": (None if attack is None else
                   f"{attack.kind}-{attack.strength:g}"
                   f"-s{attack.start_round}"),
        "sec_per_round": sec / rounds,
        **resilience_metrics(results, **burst_kw),
        "membership": membership_metrics(results),
        "wall_s": time.perf_counter() - t_cell,
    }
    return row, final_metrics, results[-1].generations


def joiner_bars(gap, ceiling):
    """(cohort bars met, per-slot max within `ceiling`): the joiner-cohort
    mean within 2e-3 of the incumbents' and the mean per-slot deficit
    against the static baseline within 2e-3; the worst slot's deficit
    within the ceiling."""
    cohort = bool(
        gap.get("mean_gap") is not None and abs(gap["mean_gap"]) <= 2e-3
        and gap.get("per_slot_gap_mean_vs_baseline") is not None
        and gap["per_slot_gap_mean_vs_baseline"] <= 2e-3)
    per_slot = bool(gap.get("per_slot_gap_vs_baseline") is not None
                    and gap["per_slot_gap_vs_baseline"] <= ceiling)
    return cohort, per_slot


def burst_row(cfg, data, n_real, base_final, rounds=ROUNDS, **carry):
    """The leave burst + rejoin wave with both joiner bars against the
    static baseline's final metrics; `carry` goes to run_cell."""
    from fedmse_tpu_torch.chaos import joiner_incumbent_gap
    from fedmse_tpu_torch.federation.elastic import ElasticSpec
    b0, b1 = BURST
    spec = ElasticSpec(leave_p=0.3, join_p=0.6, leave_window=(b0, b1),
                       join_window=(b1, None))
    row, final, gen = run_cell(cfg, data, n_real, spec, rounds=rounds,
                               burst=(b0, b1), label="leave-burst-50pct",
                               **carry)
    gap = joiner_incumbent_gap(final, gen, baseline_metrics=base_final)
    row["joiner_gap"] = gap
    row["joiners_within_2e3_of_incumbents"], \
        row["per_slot_max_gap_within_ceiling"] = joiner_bars(
            gap, PER_SLOT_MAX_GAP_CEILING)
    row["per_slot_max_gap_ceiling"] = PER_SLOT_MAX_GAP_CEILING
    return row


def _bodies(f):
    """Each body of a FusedRound: (replays, graphs, capture seconds)."""
    return {b.name: {"replays": b.replays, "graphs": len(b.graphs),
                     "capture_seconds": b.capture_seconds}
            for b in (f.enter, f.epoch, f.leave)}


def capture_once_pin(cfg, device, n_clients=PIN_CLIENTS, cohort=PIN_COHORT):
    """`n_clients` thin shards, `cohort` selected a round, 30% a round
    membership churn, 1 epoch, chunks of 2 rounds: after the warm-up
    chunk, two churning chunks must replay the round the warm-up built
    and captured (the same FusedRound; on the card each of `enter` and
    `leave` replayed calls - 1 times, every body's graphs and capture
    seconds unchanged), and 2 rounds under a null ElasticSpec must equal
    the static rounds bit for bit."""
    from fedmse_tpu_torch.data import stack_clients
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.federation.elastic import ElasticSpec
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs

    clients, dev_x = sweep.light_clients(n_clients, cfg.dim_features)
    data = stack_clients(clients, dev_x, cfg.batch_size, device=device)
    ccfg = cfg.replace(network_size=n_clients,
                       num_participants=cohort / n_clients, num_rounds=8,
                       epochs=1, fused_schedule_chunk=2)
    model = make_model("hybrid", ccfg.dim_features,
                       shrink_lambda=ccfg.shrink_lambda, device=device)

    def engine(elastic, c=ccfg):
        return RoundEngine(model, c, data, n_real=n_clients,
                           rngs=ExperimentRngs(run=0,
                                               data_seed=c.data_seed),
                           model_type="hybrid", update_type="mse_avg",
                           fused=True, elastic=elastic)

    eng = engine(ElasticSpec(leave_p=0.3, join_p=0.3))
    _, warm = sweep.timed(eng.run_schedule_chunk, 0, 2)  # builds, captures
    f = eng.fused_round()
    after_warmup = _bodies(f)
    results = []
    for start in (2, 4):                                 # churning chunks
        chunk, sec = sweep.timed(eng.run_schedule_chunk, start, 2)
        results += chunk[0]
    after_churn = _bodies(f)
    rebuilt = eng.fused_round() is not f
    calls = 6
    on_card = device.type == "cuda"
    captured_once = None if not on_card else bool(
        not rebuilt
        and all(after_churn[b]["replays"] == calls - 1
                for b in ("enter", "leave"))
        and all(after_churn[b][k] == after_warmup[b][k]
                for b in after_churn for k in ("graphs",
                                               "capture_seconds")))

    def two_rounds(elastic):
        e = engine(elastic, ccfg.replace(num_rounds=2))
        e.run_schedule_chunk(0, 2)
        return e.states.clone()

    bit = sweep.states_equal(two_rounds(None), two_rounds(ElasticSpec()))
    return {
        "n_clients": n_clients, "cohort": eng.cohort_size(), "world": 1,
        "churn": "leave_p=0.3 join_p=0.3 (30%/round)",
        "members_last_round": len(results[-1].members),
        "fused_round_rebuilt": rebuilt,
        "bodies_after_warmup": after_warmup,
        "bodies_after_churn_chunks": after_churn,
        "captured_once": captured_once,
        "warmup_chunk_sec": warm,
        "warm_sec_per_round_last_chunk": sec / 2,
        "null_churn_bitwise_identical": bool(bit),
    }


def podscale_main(args, device, prov):
    """`--podscale`: the churn semantics at 100k gateways on the tiered
    engine with host_sharded=True, full participation (every member
    trains every round, so joiners and the baseline's same slots both
    converge and the per-slot comparison reads churn recovery). Rows:
    static, null elastic (bit-equal), steady churn, and the leave burst
    with both joiner bars, scoped to cohort-covered slots."""
    from fedmse_tpu_torch.chaos import (joiner_incumbent_gap,
                                        membership_metrics,
                                        resilience_metrics)
    from fedmse_tpu_torch.config import CompatConfig, ExperimentConfig
    from fedmse_tpu_torch.federation import TieredRoundEngine
    from fedmse_tpu_torch.federation.elastic import ElasticSpec
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.parallel.mesh import client_mesh
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs

    t_start = time.perf_counter()
    n = args.clients or 100_000
    rounds, burst = 10, (3, 5)
    cohort = n
    dim, hid, lat = 8, 6, 3
    cfg = ExperimentConfig(
        dim_features=dim, hidden_neus=hid, latent_dim=lat, network_size=n,
        epochs=5, batch_size=16, num_rounds=rounds,
        num_participants=1.0, state_layout="tiered", host_sharded=True,
        compat=CompatConfig(shared_last_client_val=False))
    mesh = client_mesh(device)
    data = sweep.bulk_host_federation(n, dim, cfg.batch_size)
    model = make_model("hybrid", dim, hid, lat, cfg.shrink_lambda,
                       device=device)

    def run(elastic, label, burst_kw=None):
        t_cell = time.perf_counter()
        eng = TieredRoundEngine(
            model, cfg, data, n_real=n,
            rngs=ExperimentRngs(run=0, data_seed=cfg.data_seed),
            model_type="hybrid", update_type="mse_avg", mesh=mesh,
            elastic=elastic, host_sharded=True, device=device)
        assert eng.host_sharded and eng.cohort == cohort, (eng.cohort,
                                                           cohort)
        results = []
        _, sec = sweep.timed(eng.run_rounds, 0, rounds,
                             lambda r, s: results.append(r) and False)
        final = np.asarray(eng.evaluate_final_streamed())
        if final.ndim == 2:
            final = final[:, 0]
        gen = results[-1].generations
        if results[-1].members is not None:
            member = np.zeros(n, bool)
            member[results[-1].members] = True
            final = np.where(member, final, np.nan)
        cov = np.zeros(n, bool)  # slots a cohort trained, current tenure
        g_fin = (np.asarray(results[-1].generations)
                 if results[-1].generations is not None else None)
        for r in results:
            sel = np.asarray(list(r.selected), dtype=int)
            if g_fin is not None and r.generations is not None:
                # a visit counts only if it trained the slot's final
                # occupant: a visit before a recycle trained the leaver
                sel = sel[np.asarray(r.generations)[sel] == g_fin[sel]]
            cov[sel] = True
        row = {"label": label, "n_gateways": n, "cohort": cohort,
               "world": mesh.world_size,
               "sec_per_round": sec / rounds,
               **resilience_metrics(results, **(burst_kw or {})),
               "membership": membership_metrics(results),
               "wall_s": time.perf_counter() - t_cell}
        return row, final, gen, cov, eng

    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    base_row, base_final, _, base_cov, base_eng = run(
        None, "static-baseline-100k")
    emit(base_row)
    null_row, null_final, _, _, null_eng = run(ElasticSpec(),
                                               "null-elastic-100k")
    null_row["bit_identical_to_static"] = bool(
        np.array_equal(base_final, null_final, equal_nan=True)
        and sweep.states_equal(base_eng.store.host, null_eng.store.host))
    emit(null_row)
    del base_eng, null_eng

    row, _, _, _, _ = run(ElasticSpec(leave_p=0.1, join_p=0.3,
                                      start_round=1),
                          "steady-churn-0.1-100k")
    emit(row)

    b0, b1 = burst
    row, burst_final, burst_gen, burst_cov, _ = run(
        ElasticSpec(leave_p=0.3, join_p=0.6, leave_window=(b0, b1),
                    join_window=(b1, None)),
        "leave-burst-50pct-100k",
        burst_kw={"burst_start": b0, "burst_stop": b1,
                  "recover_eps": 2e-3})
    # both readings scoped to cohort-covered slots (covered in both runs
    # for the per-slot baseline reading): at full participation that is
    # every slot a cohort trained in its final tenure
    gap = joiner_incumbent_gap(
        np.where(burst_cov, burst_final, np.nan), burst_gen,
        baseline_metrics=np.where(base_cov, base_final, np.nan))
    row["joiner_gap"] = gap
    row["joiner_gap_scope"] = {
        "covered_elastic": int(burst_cov.sum()),
        "covered_baseline": int(base_cov.sum()),
        "covered_both": int((burst_cov & base_cov).sum()),
    }
    # per-slot AUC on the bulk federation's 8 x 8 test rows is quantized at
    # 1/64, so the fleet-scale worst-slot bar is stated at the cell's
    # resolution: at most 8 pair inversions (0.125)
    y0 = data.test_y[0]
    t_pairs = int((y0 > 0).sum()) * int((y0 == 0).sum())
    pod_ceiling = max(PER_SLOT_MAX_GAP_CEILING, float(8.0 / t_pairs))
    row["joiners_within_2e3_of_incumbents"], \
        row["per_slot_max_gap_within_ceiling"] = joiner_bars(gap,
                                                             pod_ceiling)
    row["per_slot_max_gap_ceiling"] = pod_ceiling
    row["per_slot_max_gap_ceiling_note"] = (
        "max(1e-2, 8 pair inversions at the cell's 8x8-row AUC "
        "resolution)")
    emit(row)

    acceptance = {
        "bar": f"{n}-gateway churn on the host-sharded tier: null-elastic "
               f"bitwise to static, joiner cohort bars within 2e-3, "
               f"per-slot max within the resolution-aware ceiling",
        "null_bitwise": null_row["bit_identical_to_static"],
        "joiner_bars_met": row["joiners_within_2e3_of_incumbents"],
        "per_slot_ceiling_met": row["per_slot_max_gap_within_ceiling"],
    }
    acceptance["met"] = bool(all(acceptance[k] for k in
                                 ("null_bitwise", "joiner_bars_met",
                                  "per_slot_ceiling_met")))
    out = {
        "protocol": f"{n}-gateway bulk-synthetic fleet, tiered engine "
                    f"(state_layout=tiered host_sharded=True, world "
                    f"{mesh.world_size}: one block, the fleet; cohort "
                    f"{cohort}), hybrid+mse_avg {dim}/{hid}/{lat}, "
                    f"{rounds} rounds of 5 epochs, "
                    f"{sweep.tie_break_phrase(cfg, cohort)}; "
                    f"burst window [{b0}, "
                    f"{b1}) at leave_p=0.3, rejoin from {b1}; the bars pin "
                    f"that the elastic semantics hold on the tier at fleet "
                    f"scale",
        "rows": rows, "acceptance": acceptance,
        "total_seconds": time.perf_counter() - t_start,
        **prov,
    }
    sweep.write(args.out, out)
    print(json.dumps({"wrote": args.out,
                      "acceptance_met": acceptance["met"]}))


def main(argv=None):
    p = sweep.parser(__doc__, "CHURN_torch.json")
    p.add_argument("--clients", type=int, default=None,
                   help=f"the grid's clients (default {GRID_CLIENTS}); "
                        f"with --podscale the fleet's (default 100,000)")
    p.add_argument("--pin-clients", type=int, default=PIN_CLIENTS,
                   help="the capture-once pin's fleet")
    p.add_argument("--podscale", action="store_true",
                   help="the 100k-gateway tiered run instead of the grid")
    args = p.parse_args(argv)
    if args.podscale and args.out == "CHURN_torch.json":
        args.out = "CHURN_PODSCALE_torch.json"
    device, prov = sweep.start(args)
    if args.podscale:
        return podscale_main(args, device, prov)
    from fedmse_tpu_torch.chaos import ChaosSpec
    from fedmse_tpu_torch.config import ExperimentConfig
    from fedmse_tpu_torch.federation.attack import AttackSpec
    from fedmse_tpu_torch.federation.elastic import ElasticSpec

    t_start = time.perf_counter()
    n_grid = args.clients or GRID_CLIENTS
    cfg = ExperimentConfig(network_size=n_grid, num_participants=0.2,
                           num_rounds=ROUNDS, epochs=1)
    data, n_real = build_grid(cfg, n_grid, device=device)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    # ---- static baseline + the null-spec bitwise pin ----
    base_row, base_final, _ = run_cell(cfg, data, n_real, None,
                                       label="static-baseline")
    emit(base_row)
    null_row, null_final, _ = run_cell(cfg, data, n_real, ElasticSpec(),
                                       label="null-elastic")
    # equal_nan: a client whose thin non-IID shard defeats the metric is
    # NaN in both runs, in the same slot
    null_row["bit_identical_to_static"] = bool(
        np.array_equal(base_final, null_final, equal_nan=True)
        and base_row["auc_curve"] == null_row["auc_curve"])
    emit(null_row)

    # ---- steady churn: 10% and 30% a round ----
    for leave_p, join_p in ((0.1, 0.3), (0.3, 0.5)):
        row, _, _ = run_cell(
            cfg, data, n_real,
            ElasticSpec(leave_p=leave_p, join_p=join_p, start_round=1),
            label=f"steady-churn-{leave_p:g}")
        emit(row)

    # ---- the 50% leave burst + rejoin wave (the acceptance row) ----
    emit(burst_row(cfg, data, n_real, base_final))

    # ---- composition: churn x chaos x attack ----
    row, _, _ = run_cell(
        cfg, data, n_real,
        ElasticSpec(leave_p=0.2, join_p=0.4, start_round=1),
        chaos=ChaosSpec(dropout_p=0.3, crash_p=0.1),
        attack=AttackSpec(kind="scale", strength=50.0, start_round=1),
        label="churn+chaos+attack")
    emit(row)

    # ---- 10k clients, 30% a round churn, each body captured once ----
    t0 = time.perf_counter()
    pin = capture_once_pin(ExperimentConfig(), device, args.pin_clients)
    emit({"label": f"{args.pin_clients // 1000}k-capture-once", **pin,
          "wall_s": time.perf_counter() - t0})

    b0, b1 = BURST
    out = {
        "protocol": f"{n_grid}-client Dirichlet({ALPHA}) non-IID synthetic "
                    f"grid, hybrid+mse_avg, {ROUNDS} fused rounds, 20% "
                    f"participation; leave burst rounds [{b0}, {b1}) at "
                    f"leave_p=0.3 (~51% departed), rejoin from {b1}; joiner "
                    f"bars: joiner-cohort mean AUC within 2e-3 of the "
                    f"incumbent cohort AND mean per-slot deficit vs the "
                    f"static baseline within 2e-3, the per-slot max within "
                    f"{PER_SLOT_MAX_GAP_CEILING:g}; the pin row: "
                    f"{args.pin_clients} clients on one card (world 1), "
                    f"each CUDA graph body captured once across churning "
                    f"chunks and null churn bit-equal to static; "
                    f"sec_per_round of the first rows includes their "
                    f"capture",
        "rows": rows,
        "total_seconds": time.perf_counter() - t_start,
        **prov,
    }
    sweep.write(args.out, out)
    print(json.dumps({"wrote": args.out, "n_rows": len(rows)}))


if __name__ == "__main__":
    main()

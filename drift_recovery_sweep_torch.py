"""Drift-recovery sweep for the port's flywheel control loop
(fedmse_tpu_torch/flywheel/; the port of drift_recovery_sweep.py).

A fleet's normal traffic walks (a firmware update, a replaced sensor, a
seasonal load change) while the attack traffic replays pre-deployment
behaviour just outside the calibrated envelope: once the regime has
walked far enough, a detector that never adapts scores the replayed
attacks closer to its stale manifold than the fresh normals, and its AUC
collapses. The flywheel must notice the walk from the served scores
alone, fine-tune the federation on the fresh normals its own verdicts
admitted to the reservoirs, and hot-swap the result back without
dropping a ticket.

Each grid cell (total shift delta, score_kind):

  1. trains a small federation on synthetic normals (the calibrated
     regime) and builds the continuous serving front with the flywheel;
  2. streams the shift in stages (delta / stages a stage) and then two
     hold stages at the final regime; the controller polls between
     bursts and fine-tunes and swaps whenever the drift verdict
     sustains. The front flushes on size only (a latency budget of 1e9
     ms), so no host clock decides a poll, a swap or a fine-tune;
  3. after every stage measures the detection AUC on a held-out labelled
     set of that stage's regime for the live (adapting) front and a
     frozen engine;
  4. is accepted when the final adapted AUC is within eps (2e-2) of the
     pre-shift AUC with at most 5 fine-tune rounds a swap, no ticket
     dropped or scored twice, and the frozen engine degraded.

Writes FLYWHEEL_torch.json (--out). On the card: `python3
drift_recovery_sweep_torch.py --out FLYWHEEL_torch_h100.json`; on the CPU
add `--device cpu`; `--quick` runs the single (1.5, mse) cell.
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

N_CLIENTS = 6
DIM = 16
RANK = 3              # the normal manifold's latent rank
NOISE = 0.2           # off-manifold noise std of normal traffic
ANOMALY_BEHIND = 1.25  # attacks replay traffic this far behind the origin
ROWS_PER_STAGE = 288  # per gateway per stage
EVAL_ROWS = 384
EPS = 2e-2


class Regime:
    """The drifting traffic generator (the JAX sweep's, draw for draw):
    normals live on a shared RANK-dim manifold plus NOISE, and the whole
    regime translates along a unit direction `u` as it drifts, `on_frac`
    of its energy on the manifold (visible in latent space) and the rest
    off it (visible to reconstruction scores). Attacks mimic the manifold
    but sit fixed at -`behind` along `u`: pre-shift an ordinary anomaly
    one envelope-width out; once the regime has walked past +`behind`, a
    frozen detector scores them closer to its stale manifold than the
    fresh normals, while an adapting one keeps them outside its moving
    coverage."""

    def __init__(self, seed: int, on_frac: float = 0.5,
                 behind: float = ANOMALY_BEHIND):
        rng = np.random.default_rng(seed)
        self.w = rng.normal(size=(RANK, DIM))
        self.w /= np.linalg.norm(self.w, axis=1, keepdims=True)
        q, _ = np.linalg.qr(self.w.T)          # manifold basis [DIM, RANK]
        u = rng.normal(size=DIM)
        u -= q @ (q.T @ u)                     # off-manifold component
        u /= np.linalg.norm(u)
        self.behind = behind
        self.u = np.sqrt(1.0 - on_frac) * u + np.sqrt(on_frac) * self.w[0]

    def normals(self, rng, n: int, shift: float = 0.0) -> np.ndarray:
        z = rng.normal(size=(n, RANK))
        x = z @ self.w + NOISE * rng.normal(size=(n, DIM))
        return (x + shift * self.u).astype(np.float32)

    def anomalies(self, rng, n: int, shift: float = 0.0) -> np.ndarray:
        del shift  # the replayed attacks do not drift with the regime
        return self.normals(rng, n, -self.behind)


def build_federation(cfg, model_type, regime: Regime, seed=0, *,
                     device="cuda", states=None):
    """Train the calibrated-regime federation on the regime's normals:
    (model, data on `device`, the trained stacked params). `states`
    replaces the engine's own init."""
    from fedmse_tpu_torch.data import build_dev_dataset, stack_clients
    from fedmse_tpu_torch.data.loader import ClientData
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs

    rngs = ExperimentRngs(run=0)
    rng = np.random.default_rng(1000 + seed)
    clients = []
    for i in range(N_CLIENTS):
        clients.append(ClientData(
            name=f"flywheel-{i + 1}",
            train_x=regime.normals(rng, 240),
            valid_x=regime.normals(rng, 80),
            test_x=np.concatenate([regime.normals(rng, 60),
                                   regime.anomalies(rng, 60)]),
            test_y=np.concatenate([np.zeros(60), np.ones(60)]
                                  ).astype(np.float32),
            dev_raw=regime.normals(rng, 120),
            scaler=None,
        ))
    data = stack_clients(clients, build_dev_dataset(clients, rngs.data_rng),
                         cfg.batch_size, device=device)
    model = make_model(model_type, DIM, cfg.hidden_neus, cfg.latent_dim,
                       cfg.shrink_lambda, device=device)
    engine = RoundEngine(model, cfg, data, n_real=N_CLIENTS, rngs=rngs,
                         model_type=model_type, update_type="mse_avg",
                         fused=True, states=states)
    engine.run_rounds(0, cfg.num_rounds)
    return model, data, engine.model_params()


def eval_auc(score_fn, regime: Regime, shift: float, seed: int) -> float:
    """Detection AUC on the current regime's labelled set. The noise draws
    are fixed by `seed` and translated with the regime, so the pre-shift
    and post-recovery evaluations see the same sample geometry."""
    from fedmse_tpu_torch.flywheel import host_auc

    rng = np.random.default_rng(seed)
    rows = np.concatenate([regime.normals(rng, EVAL_ROWS, shift),
                           regime.anomalies(rng, EVAL_ROWS, shift)])
    labels = np.concatenate([np.zeros(EVAL_ROWS), np.ones(EVAL_ROWS)])
    gws = np.tile(np.arange(N_CLIENTS, dtype=np.int32),
                  -(-len(rows) // N_CLIENTS))[:len(rows)]
    return host_auc(labels, score_fn(rows, gws))


def run_cell(delta: float, score_kind: str, stages: int, seed: int = 0,
             on_frac: float = 0.5, behind: float = ANOMALY_BEHIND,
             z: float = 0.5, *, device="cuda", states=None, compat=None):
    """One grid cell: walk the regime by `delta` sigma over `stages`.
    `on_frac` / `behind` / `z` adapt the cell to its score kind (a latent
    scorer needs an on-manifold walk, a farther replay and a lower z).
    `states` replaces the federation's init; `compat` (a CompatConfig)
    replaces the config's default quirks."""
    from fedmse_tpu_torch.config import ExperimentConfig
    from fedmse_tpu_torch.flywheel import (FlywheelBuffer,
                                           FlywheelController,
                                           stream_with_polling,
                                           ticket_integrity)
    from fedmse_tpu_torch.serving import (ContinuousBatcher, DriftMonitor,
                                          ServingEngine, fit_calibration)

    model_type = "autoencoder" if score_kind in ("mse", "knn") else "hybrid"
    cfg = ExperimentConfig(
        network_size=N_CLIENTS, dim_features=DIM, epochs=5, num_rounds=3,
        score_kind=score_kind, knn_bank_size=128,
        flywheel_buffer_size=384, flywheel_rounds=5, flywheel_quorum=2,
        flywheel_cooldown=3, flywheel_min_rows=160,
        flywheel_z=z, flywheel_percentile=99.0,
        **({} if compat is None else {"compat": compat}))
    regime = Regime(seed, on_frac=on_frac, behind=behind)
    model, data, params = build_federation(cfg, model_type, regime,
                                           seed=seed, device=device,
                                           states=states)

    def serving():
        return ServingEngine.from_federation(
            model, model_type, params, train_x=data.train_xb,
            train_m=data.train_mb, score_kind=score_kind,
            knn_bank_size=cfg.knn_bank_size, max_bucket=256, device=device)

    engine = serving()
    frozen = serving()  # the never-adapting baseline
    calib = fit_calibration(engine, data.valid_x.cpu().numpy(),
                            data.valid_m.cpu().numpy(),
                            percentile=cfg.flywheel_percentile)
    monitor = DriftMonitor(calib, z_threshold=cfg.flywheel_z, min_batches=2,
                           cooldown_updates=cfg.flywheel_cooldown)
    buffer = FlywheelBuffer(N_CLIENTS, DIM,
                            capacity=cfg.flywheel_buffer_size, seed=seed)
    # max_batch 64: each burst chunk harvests as its own batch, so the
    # monitor sees ~18 updates a stage (its debounce and post-swap cooldown
    # count updates)
    batcher = ContinuousBatcher(engine, max_batch=64,
                                latency_budget_ms=1e9, calibration=calib,
                                drift=monitor, intake=buffer.tap())
    controller = FlywheelController(
        batcher, monitor, buffer, model, model_type, "mse_avg", cfg,
        dev_x=data.dev_x.cpu().numpy(), rounds=cfg.flywheel_rounds,
        quorum=cfg.flywheel_quorum, cooldown_polls=4,
        min_rows=cfg.flywheel_min_rows)

    rng = np.random.default_rng(100 + seed)
    eval_seed = 200 + seed
    auc_pre = eval_auc(engine.score, regime, 0.0, eval_seed)

    # the calibrated regime fills the reservoirs first
    all_blocks = []
    warm = regime.normals(rng, ROWS_PER_STAGE * N_CLIENTS)
    gws = np.tile(np.arange(N_CLIENTS, dtype=np.int32), ROWS_PER_STAGE)
    blocks, _ = stream_with_polling(batcher, controller, warm, gws)
    all_blocks.extend(blocks)

    stage_rows = []
    t0 = time.perf_counter()
    t_first_flag = t_recovered = None
    # the ramp walks the regime; the trailing `hold` stages keep serving
    # the final regime, so recovery is read once the target stopped moving
    hold = 2
    for stage in range(1, stages + hold + 1):
        shift = delta * min(stage, stages) / stages
        fresh = regime.normals(rng, ROWS_PER_STAGE * N_CLIENTS, shift)
        blocks, events = stream_with_polling(batcher, controller, fresh, gws)
        all_blocks.extend(blocks)
        if t_first_flag is None and monitor.report()["drifted_gateways"]:
            t_first_flag = time.perf_counter() - t0
        auc_live = eval_auc(engine.score, regime, shift, eval_seed)
        auc_frozen = eval_auc(frozen.score, regime, shift, eval_seed)
        if (t_recovered is None and stage >= stages
                and auc_live >= auc_pre - EPS):
            t_recovered = time.perf_counter() - t0
        stage_rows.append({
            "stage": stage,
            "hold": stage > stages,
            "shift_sigma": round(shift, 3),
            "auc_live": round(auc_live, 4),
            "auc_frozen": round(auc_frozen, 4),
            "swaps_so_far": len(controller.events),
            "new_swaps_this_stage": len(events),
            "buffer_fill": round(buffer.occupancy()["fill_fraction"], 3),
        })

    integrity = ticket_integrity(all_blocks)
    final = stage_rows[-1]
    stats = batcher.stats()
    # one-sided: ending above the pre-shift AUC is recovery too
    recovered = final["auc_live"] >= auc_pre - EPS
    return {
        "delta_sigma": delta,
        "stages": stages,
        "hold_stages": hold,
        "score_kind": engine.score_kind,
        "model_type": model_type,
        "anomaly_behind_sigma": behind,
        "walk_on_manifold_frac": on_frac,
        "drift_z_threshold": z,
        "auc_pre_shift": round(auc_pre, 4),
        "auc_final_adapted": final["auc_live"],
        "auc_final_frozen": final["auc_frozen"],
        "recovered_within_eps": bool(recovered),
        "eps": EPS,
        "finetune_rounds_per_swap": cfg.flywheel_rounds,
        "swap_count": len(controller.events),
        "seconds_to_first_drift_flag": t_first_flag,
        "seconds_to_recovered": t_recovered,
        "buffer_occupancy": buffer.occupancy(),
        "zero_downtime": bool(integrity["zero_dropped"]
                              and stats["rows_served"]
                              == stats["rows_submitted"]),
        "tickets": integrity,
        "monitor": {k: v for k, v in monitor.report().items()
                    if k != "gateways"},
        "stage_rows": stage_rows,
        "swap_kinds": [e["kinds"] for e in controller.events],
    }


def grid(quick: bool):
    """(delta, score_kind, stages, cell kwargs): the kNN cell walks fully
    on the manifold with a farther replay and a lower z, since a latent
    scorer cannot see off-manifold drift (Regime)."""
    if quick:
        return [(1.5, "mse", 3, {})]
    return [(1.0, "mse", 2, {}), (1.5, "mse", 3, {}), (2.5, "mse", 5, {}),
            (2.8, "knn", 2, {"on_frac": 1.0, "behind": 2.5, "z": 0.35}),
            (1.5, "centroid", 3, {})]


def acceptance_block(rows):
    return {
        "all_recovered": all(r["recovered_within_eps"] for r in rows),
        "all_zero_downtime": all(r["zero_downtime"] for r in rows),
        "max_finetune_rounds_per_swap": max(
            r["finetune_rounds_per_swap"] for r in rows),
        "frozen_baseline_degraded": any(
            r["auc_final_frozen"] < r["auc_pre_shift"] - 0.1 for r in rows),
    }


def main(argv=None):
    p = sweep.parser(__doc__, "FLYWHEEL_torch.json")
    p.add_argument("--quick", action="store_true",
                   help="the single (1.5, mse) cell")
    args = p.parse_args(argv)
    device, prov = sweep.start(args)
    t_start = time.perf_counter()
    rows = []
    for delta, kind, stages, kw in grid(args.quick):
        t0 = time.perf_counter()
        row = run_cell(delta, kind, stages, device=device, **kw)
        row["wall_seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps({k: row[k] for k in
                          ("delta_sigma", "score_kind", "auc_pre_shift",
                           "auc_final_adapted", "auc_final_frozen",
                           "swap_count", "recovered_within_eps",
                           "zero_downtime")}), flush=True)
    out = {
        "protocol": {
            "clients": N_CLIENTS, "dim": DIM,
            "rows_per_stage_per_gateway": ROWS_PER_STAGE,
            "eps": EPS,
            "description": "regime walks delta sigma in stages; anomalies "
                           "replay pre-deployment traffic anomaly_behind "
                           "sigma outside the origin envelope (per cell); "
                           "the flywheel must keep AUC within eps of "
                           "pre-shift (one-sided) with zero dropped tickets "
                           "while the frozen baseline degrades",
        },
        "acceptance": acceptance_block(rows),
        "cells": rows,
        "total_seconds": time.perf_counter() - t_start,
        **prov,
    }
    sweep.write(args.out, out)
    print(json.dumps({"wrote": args.out, "acceptance": out["acceptance"]}))
    return out


if __name__ == "__main__":
    main()

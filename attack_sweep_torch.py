"""Defense operating-point sweep on the PyTorch port: accept/reject rates
and rejected-counter trajectories against attack kind x strength,
strengths below the verification thresholds included (the port of
attack_sweep.py, on fedmse_tpu_torch).

The verifier (fedmse_tpu_torch/federation/verification.py) accepts a
broadcast iff the sum of per-tensor Frobenius update norms is <= 3.0 and
the broadcast's loss on the verification data does not exceed the
client's history best by > 0.002; a client whose consecutive rejections
reach 3 is flagged "possible attack". This sweep measures where that
operating point sits: which (kind, strength) cells are blocked, which
sail through, and what each costs in final AUC.

Protocol: the quick-run config (10 clients, hybrid + mse_avg), 8 fused
rounds, round 0 clean (it builds the verification history), rounds 1-7
attacked every round by a malicious elected aggregator. One federation
per cell, plus a no-attack baseline. Two modes: "reference" (the
reference-faithful accept rule) and "hardened" (hardened_verification).
Each mode also runs three paper-scale rows (20 rounds / 100 epochs): the
baseline, the zero attack from round 1 and the zero attack from round 10.

Writes ATTACK_torch.json (--out) and prints one line per cell. On the
card: `python3 attack_sweep_torch.py --out ATTACK_torch_h100.json`; on
the CPU (the kernels' plain versions): add `--device cpu --clients 4`.
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

ROUNDS = 8
START = 1  # first attacked round; round 0 builds the verification history

# kind -> strengths, spanning both sides of the 3.0 / 0.002 thresholds
GRID = {
    "scale": [1.001, 1.01, 1.05, 1.2, 2.0, 10.0],
    "noise": [1e-4, 1e-3, 1e-2, 0.1, 1.0],
    "sign_flip": [0.01, 1.0],
    "zero": [1.0],
}


def run_cell(cfg, data, n_real, kind, strength, rounds=ROUNDS, start=START,
             *, states=None):
    """One federation of `rounds` fused rounds on `data`'s device, the
    attack (None: no attack) from round `start`. `states` replaces the
    engine's own init (e.g. the JAX package's, client_states_from_numpy)."""
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.federation.attack import AttackSpec, make_poison_fn
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs

    t0 = time.perf_counter()
    poison = (None if kind is None else make_poison_fn(
        AttackSpec(kind=kind, strength=strength, every_k=1,
                   start_round=start)))
    model = make_model("hybrid", cfg.dim_features,
                       shrink_lambda=cfg.shrink_lambda,
                       device=data.train_xb.device)
    engine = RoundEngine(model, cfg, data, n_real=n_real,
                         rngs=ExperimentRngs(run=0, data_seed=cfg.data_seed),
                         model_type="hybrid", update_type="mse_avg",
                         fused=True, poison_fn=poison, states=states)
    results = engine.run_rounds(0, rounds)

    accept_events = reject_events = 0
    max_rejected = 0
    mean_rejected_curve = []
    # a client's first verified broadcast has no history to hold it to:
    # accepts are split into first contacts and the rest
    seen = {r["client_id"] for res in results[:start]
            for r in res.verification_results}
    later_accepts = 0
    for res in results[start:]:
        rows = res.verification_results
        if not rows:  # no aggregator elected: nothing broadcast this round
            mean_rejected_curve.append(None)
            continue
        later_accepts += sum(1 for r in rows if r["rejected_updates"] == 0
                             and r["client_id"] in seen)
        seen.update(r["client_id"] for r in rows)
        # rejected_updates resets to 0 on accept, increments on reject, so
        # 0 means this round's broadcast was accepted by that client
        acc = sum(1 for r in rows if r["rejected_updates"] == 0)
        accept_events += acc
        reject_events += len(rows) - acc
        max_rejected = max(max_rejected,
                           max(r["rejected_updates"] for r in rows))
        mean_rejected_curve.append(round(
            float(np.mean([r["rejected_updates"] for r in rows])), 3))
    total = accept_events + reject_events
    auc_curve = [round(float(np.nanmean(r.client_metrics)), 5)
                 for r in results]
    return {
        "kind": kind or "none", "strength": strength,
        "attacked_rounds": rounds - start if kind else 0,
        "accept_rate": round(accept_events / total, 4) if total else None,
        "mean_rejected_curve": mean_rejected_curve,
        "max_rejected_counter": max_rejected,
        "possible_attack_flagged": bool(max_rejected >= 3),
        "accepts_after_first_contact": later_accepts,
        "final_auc": auc_curve[-1],
        "auc_curve": auc_curve,
        "wall_s": time.perf_counter() - t0,
    }


def main(argv=None):
    p = sweep.parser(__doc__, "ATTACK_torch.json")
    p.add_argument("--clients", type=int, default=10)
    p.add_argument("--shards", default=None,
                   help="Client-k shard tree (default: synthetic clients)")
    args = p.parse_args(argv)
    device, prov = sweep.start(args)
    from fedmse_tpu_torch.config import ExperimentConfig, paper_scale

    t_start = time.perf_counter()
    base_cfg = ExperimentConfig()
    data, n_real, _ = sweep.build_data(base_cfg, args.clients, args.shards,
                                       device=device)

    modes = {}
    for mode, hardened in (("reference", False), ("hardened", True)):
        cfg = base_cfg.replace(hardened_verification=hardened)
        cells = [run_cell(cfg, data, n_real, None, 0.0)]  # no-attack baseline
        print(json.dumps({"mode": mode, **cells[0]}), flush=True)
        for kind, strengths in GRID.items():
            for s in strengths:
                cells.append(run_cell(cfg, data, n_real, kind, s))
                print(json.dumps({"mode": mode, **cells[-1]}), flush=True)
        # paper scale (20 rounds / 100 epochs): quotas and verification
        # history have time to matter; the late start (rounds 0-9 clean)
        # separates the hardened gate's power from the cold-start window
        pcfg = paper_scale(cfg)
        paper_rows = [run_cell(pcfg, data, n_real, None, 0.0,
                               rounds=pcfg.num_rounds),
                      run_cell(pcfg, data, n_real, "zero", 1.0,
                               rounds=pcfg.num_rounds),
                      run_cell(pcfg, data, n_real, "zero", 1.0,
                               rounds=pcfg.num_rounds, start=10)]
        for row in paper_rows:
            print(json.dumps({"mode": mode, "paper_scale": True, **row}),
                  flush=True)
        modes[mode] = {"baseline": cells[0], "cells": cells[1:],
                       "paper_scale_baseline": paper_rows[0],
                       "paper_scale_zero": paper_rows[1],
                       "paper_scale_zero_late_start10": paper_rows[2]}

    out = {
        "protocol": f"quick-run {sweep.data_source(args.shards, n_real)}, "
                    f"hybrid+mse_avg, {ROUNDS} fused rounds, rounds "
                    f"{START}-{ROUNDS - 1} attacked every round; "
                    f"paper-scale rows: 20 rounds/100 epochs, zero attack "
                    f"from round 1 and from round 10; thresholds: "
                    f"Frobenius-sum 3.0, perf-drop 0.002. Modes: "
                    f"'reference' = reference-faithful accept rule, "
                    f"'hardened' = hardened_verification=True",
        **modes,
        "total_seconds": time.perf_counter() - t_start,
        **prov,
    }
    sweep.write(args.out, out)
    print(json.dumps({"wrote": args.out,
                      "n_cells_per_mode": len(modes["reference"]["cells"])}))


if __name__ == "__main__":
    main()

"""Resilience operating-point sweep on the PyTorch port: AUC and
resilience metrics against client churn x aggregator-crash rate (the
port of chaos_sweep.py, on fedmse_tpu_torch/chaos/).

attack_sweep_torch.py measures peers that misbehave; this sweep measures
peers that go missing. For each (dropout_p, crash_p) cell one quick-run
federation runs with the faults built into the fused round, and
chaos/metrics.py turns the round stream into effective participation,
re-election and crash-outage counts, the quota-exhaustion horizon,
per-client parameter-divergence spread and final AUC.

Protocol: the quick-run config (10 clients, hybrid + mse_avg), 8 fused
rounds, chaos from round 0. Grid: dropout in {0, 0.1, 0.3, 0.5} x
aggregator crash in {0, 0.1}; the (0, 0) cell is the clean baseline.
Two more row families:

  * composition (--attack, default scale-50): the malicious aggregator
    alone, then with dropout 0.3 and crash 0.1 beside it;
  * burst recovery: a transient zero attack and a transient full-churn
    window over rounds [1, 4), each reporting rounds_to_recover: how many
    rounds after the burst the mean AUC takes to regain its pre-burst
    best.

Writes CHAOS_torch.json (--out) and prints one line per row. On the card:
`python3 chaos_sweep_torch.py --out CHAOS_torch_h100.json`; on the CPU:
add `--device cpu --clients 4`.
"""

import json
import os
import sys
import time

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

import sweep_data_torch as sweep  # noqa: E402

ROUNDS = 8
DROPOUTS = (0.0, 0.1, 0.3, 0.5)
CRASHES = (0.0, 0.1)
BURST = (1, 4)  # transient-fault window [start, stop) for the recovery rows


def run_cell(cfg, data, n_real, chaos_spec, attack_spec=None, rounds=ROUNDS,
             burst=None, label=None, *, states=None, chaos_masks=None,
             elastic_masks=None):
    """One federation on `data`'s device with the chaos spec (None: no
    faults) and the attack built into its fused round. `states` replaces
    the engine's own init; `chaos_masks` ([T, N] ChaosMasks fields, T >=
    rounds) replace the spec's draws, as another engine's
    `_chaos_masks(0, T)` gives them. This driver runs no elastic
    membership, so `elastic_masks` must be None."""
    from fedmse_tpu_torch.chaos import resilience_metrics
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.federation.attack import make_poison_fn
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs

    if elastic_masks is not None:
        raise ValueError("the chaos sweep runs without elastic membership")
    t0 = time.perf_counter()
    poison = None if attack_spec is None else make_poison_fn(attack_spec)
    model = make_model("hybrid", cfg.dim_features,
                       shrink_lambda=cfg.shrink_lambda,
                       device=data.train_xb.device)
    engine = RoundEngine(model, cfg, data, n_real=n_real,
                         rngs=ExperimentRngs(run=0, data_seed=cfg.data_seed),
                         model_type="hybrid", update_type="mse_avg",
                         fused=True, poison_fn=poison, chaos=chaos_spec,
                         states=states)
    if chaos_masks is not None:
        if chaos_spec is None:
            raise ValueError("chaos_masks needs a ChaosSpec to build the "
                             "fault hooks in")
        sweep.feed_chaos(engine, chaos_masks)
    results = engine.run_rounds(0, rounds)
    burst_kw = ({} if burst is None
                else {"burst_start": burst[0], "burst_stop": burst[1]})
    return {
        "label": label or "grid",
        "dropout_p": 0.0 if chaos_spec is None else chaos_spec.dropout_p,
        "crash_p": 0.0 if chaos_spec is None else chaos_spec.crash_p,
        "broadcast_loss_p": (0.0 if chaos_spec is None
                             else chaos_spec.broadcast_loss_p),
        "attack": (None if attack_spec is None else
                   f"{attack_spec.kind}-{attack_spec.strength:g}"
                   f"-s{attack_spec.start_round}"
                   + ("" if attack_spec.stop_round is None
                      else f"e{attack_spec.stop_round}")),
        **resilience_metrics(results, **burst_kw),
        # the last round's per-client metrics, unrounded (NaN where a
        # client's metric is undefined)
        "final_client_metrics": results[-1].client_metrics.tolist(),
        "wall_s": time.perf_counter() - t0,
    }


def main(argv=None):
    p = sweep.parser(__doc__, "CHAOS_torch.json")
    p.add_argument("--clients", type=int, default=10)
    p.add_argument("--shards", default=None,
                   help="Client-k shard tree (default: synthetic clients)")
    p.add_argument("--attack", default="scale",
                   help="the composition rows' attack kind")
    p.add_argument("--attack-strength", type=float, default=50.0)
    args = p.parse_args(argv)
    device, prov = sweep.start(args)
    from fedmse_tpu_torch.chaos import ChaosSpec
    from fedmse_tpu_torch.config import ExperimentConfig
    from fedmse_tpu_torch.federation.attack import AttackSpec

    t_start = time.perf_counter()
    cfg = ExperimentConfig()
    data, n_real, _ = sweep.build_data(cfg, args.clients, args.shards,
                                       device=device)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    # ---- the dropout x crash grid (no attack) ----
    for crash_p in CRASHES:
        for dropout_p in DROPOUTS:
            spec = None if (dropout_p == 0 and crash_p == 0) else \
                ChaosSpec(dropout_p=dropout_p, crash_p=crash_p)
            emit(run_cell(cfg, data, n_real, spec,
                          label="baseline" if spec is None else "grid"))

    # ---- composition: a malicious aggregator, then with churn beside it
    # (round 0 clean to build the verification history) ----
    attack = AttackSpec(kind=args.attack, strength=args.attack_strength,
                        start_round=1)
    emit(run_cell(cfg, data, n_real, None, attack_spec=attack,
                  label="attack-only"))
    emit(run_cell(cfg, data, n_real,
                  ChaosSpec(dropout_p=0.3, crash_p=0.1),
                  attack_spec=attack, label="attack+churn"))

    # ---- burst recovery: transient faults, then the comeback ----
    b0, b1 = BURST
    emit(run_cell(cfg, data, n_real, None,
                  attack_spec=AttackSpec(kind="zero", start_round=b0,
                                         stop_round=b1),
                  rounds=2 * ROUNDS, burst=BURST, label="attack-burst"))
    emit(run_cell(cfg, data, n_real,
                  ChaosSpec(dropout_p=0.8, crash_p=0.5, start_round=b0,
                            stop_round=b1),
                  rounds=2 * ROUNDS, burst=BURST, label="churn-burst"))

    out = {
        "protocol": f"quick-run {sweep.data_source(args.shards, n_real)}, "
                    f"hybrid+mse_avg, {ROUNDS} fused rounds (bursts: "
                    f"{2 * ROUNDS}); grid dropout {list(DROPOUTS)} x crash "
                    f"{list(CRASHES)}, chaos from round 0; composition rows "
                    f"add a {args.attack}-{args.attack_strength:g} malicious "
                    f"aggregator from round 1; burst rows inject rounds "
                    f"[{b0}, {b1}) then stop and report rounds_to_recover "
                    f"(fedmse_tpu_torch/chaos/metrics.py)",
        "rows": rows,
        "total_seconds": time.perf_counter() - t_start,
        **prov,
    }
    sweep.write(args.out, out)
    print(json.dumps({"wrote": args.out, "n_rows": len(rows)}))


if __name__ == "__main__":
    main()

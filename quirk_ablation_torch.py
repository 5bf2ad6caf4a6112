"""Quirk ablation on the PyTorch port: what each reproduced accident of the
reference costs (the port of quirk_ablation.py).

The reference's committed behaviour includes six accidental but
load-bearing quirks, each reproduced by default behind a `CompatConfig`
switch. This driver runs the committed quick-run protocol (hybrid SAE-CEN
+ mse_avg, 10 clients, 3 runs) with each switch flipped to its fixed
variant on its own, against the all-quirks baseline:

  shared_last_client_val         -> each client verifies on its own split
  inverted_global_early_stop     -> higher-is-better global early stop
  global_early_stop_state_shared -> fresh early-stop state per run
  no_best_restore                -> restore the best local weights
  restandardize_vote_data        -> vote on the standardized rows as they are
  vote_tie_break                 -> deterministic MSE scores (no jitter)

The baseline keeps quirk 10b: ONE GlobalEarlyStop is shared across a
variant's runs (as the reference's run_experiment shares it across a
sweep), so a low `best` carried out of run 0 can cut runs 1 and 2 short;
only `global_early_stop_state_shared=False` resets it per run.

`--paper-scale` runs the paper protocol (100 epochs, 20 rounds, lr 1e-5,
lambda 10), which has no global early stop, so only `no_best_restore` is
ablated. `--shards DIR` runs on DIR's Client-1 .. Client-10 shards;
without it on the synthetic federation of the same width (the artifact's
`protocol` says which).

Writes ABLATION_torch.json (ABLATION_PAPER_torch.json with --paper-scale;
--out overrides) and prints one line per variant. On the card: `python3
quirk_ablation_torch.py --out ABLATION_torch_h100.json`; on the CPU add
`--device cpu`.
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

import sweep_data_torch as sweep  # noqa: E402

NUM_RUNS = 3
FIELDS = ("shared_last_client_val", "inverted_global_early_stop",
          "global_early_stop_state_shared", "no_best_restore",
          "restandardize_vote_data", "vote_tie_break")


def run_variant(name, cfg, data, n_real, use_early_stop=True, *,
                states=None):
    """NUM_RUNS federations of hybrid + mse_avg under `cfg`: the summary row
    (mean and std of the final-round mean client AUC, rounds run).
    `states` (one ClientStates per run) replaces each run's own init."""
    from fedmse_tpu_torch.main import GlobalEarlyStop, run_combination

    # quirk 10b: one early-stop state across the runs unless the variant
    # fixes it
    es = GlobalEarlyStop(inverted=cfg.compat.inverted_global_early_stop,
                         patience=cfg.global_patience)
    finals, rounds_run = [], []
    t0 = time.perf_counter()
    for run in range(NUM_RUNS):
        if not cfg.compat.global_early_stop_state_shared:
            es.reset()
        out = run_combination(cfg, data, n_real, "hybrid", "mse_avg", run,
                              early_stop=es if use_early_stop else None,
                              states=None if states is None
                              else states[run])
        finals.append(float(np.nanmean(out["final_metrics"])))
        rounds_run.append(out["rounds_run"])
    row = {"variant": name,
           "final_auc_mean": round(float(np.mean(finals)), 5),
           "final_auc_std": round(float(np.std(finals)), 5),
           "auc_runs": [round(f, 5) for f in finals],
           "rounds_run": rounds_run,
           "wall_s": time.perf_counter() - t0}
    print(json.dumps(row), flush=True)
    return row


def variants(cfg, fields=FIELDS):
    """(name, config) of the baseline and of each field fixed alone."""
    out = [("baseline (all reference quirks)", cfg)]
    for field in fields:
        out.append((f"fixed: {field}=False", cfg.replace(
            compat=dataclasses.replace(cfg.compat, **{field: False}))))
    return out


def ablate(cfg, data, n_real, fields=FIELDS, use_early_stop=True, *,
           states=None):
    """The baseline and every variant's row, each with its delta against
    the baseline's final AUC."""
    rows = [run_variant(name, c, data, n_real, use_early_stop,
                        states=states)
            for name, c in variants(cfg, fields)]
    base = rows[0]["final_auc_mean"]
    for row in rows[1:]:
        row["delta_vs_baseline"] = round(row["final_auc_mean"] - base, 5)
    return rows


def main(argv=None):
    from fedmse_tpu_torch.config import ExperimentConfig, paper_scale

    p = sweep.parser(__doc__, None)
    p.add_argument("--paper-scale", action="store_true",
                   help="the paper protocol; ablates no_best_restore only")
    p.add_argument("--shards", default=None,
                   help="a tree of Client-1 .. Client-10 shards (default: "
                        "the synthetic federation)")
    args = p.parse_args(argv)
    if args.out is None:
        args.out = ("ABLATION_PAPER_torch.json" if args.paper_scale
                    else "ABLATION_torch.json")
    device, prov = sweep.start(args)
    t_start = time.perf_counter()
    cfg = ExperimentConfig()  # the committed quick run, every quirk on
    source = sweep.data_source(args.shards, 10)
    protocol = (f"{source}, hybrid SAE-CEN + mse_avg, committed quick-run "
                "defaults (5 epochs, 3 rounds, lr 1e-3, batch 12, 50% "
                f"participation), {NUM_RUNS} runs/variant, global early "
                "stop active")
    fields, use_es = FIELDS, True
    if args.paper_scale:
        # the paper protocol has no global early stop, so the early-stop
        # quirks cannot bind: only quirk 11 (best-weight restore) remains
        cfg = paper_scale(cfg)
        protocol = (f"{source}, hybrid SAE-CEN + mse_avg, paper-scale (100 "
                    "epochs, 20 rounds, lr 1e-5, lambda 10), "
                    f"{NUM_RUNS} runs/variant, no global early stop")
        fields, use_es = ("no_best_restore",), False
    data, n_real, _ = sweep.build_data(cfg, 10, args.shards, device=device)
    rows = ablate(cfg, data, n_real, fields, use_es)
    out = {"protocol": protocol,
           "metric": "final-round mean client AUC",
           "variants": rows,
           "total_seconds": time.perf_counter() - t_start,
           **prov}
    sweep.write(args.out, out)
    print(json.dumps({"wrote": args.out, "n_variants": len(rows)}))
    return out


if __name__ == "__main__":
    main()

"""The paper protocol on the PyTorch port over any Client-k shard tree (the
port of paper_check.py): hybrid + mse_avg, 100 epochs, 20 rounds, lr
1e-5, lambda 10, no global early stop (the reference README's protocol),
reporting the best-round and final-round mean client AUC of each run.

`--quick` keeps the committed quick-run protocol instead (5 epochs, 3
rounds, lr 1e-3, lambda 5). `--data-seed` re-draws the train / valid /
dev / test partition. Run r draws its init from the run-r streams
(ExperimentRngs(run=r)), as the JAX driver's engine does after
`reset_federation`.

Usage: `python3 paper_check_torch.py <shard_dir> [runs=3] [--quick]
[--data-seed N] [--out PAPER_CHECK_torch.json]`; on the CPU add `--device
cpu`. Prints one line per run and the summary as its last line, and
writes the summary to --out.
"""

import glob
import json
import os
import sys

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

import numpy as np  # noqa: E402

import sweep_data_torch as sweep  # noqa: E402


def measure(shard_dir: str, runs: int = 3, quick: bool = False,
            data_seed: int = None, *, device="cuda", states=None,
            base=None, prov=None) -> dict:
    """`runs` federations of the protocol on the Client-* shards under
    `shard_dir`, one engine reset per run. `states` (one ClientStates per
    run) replaces each run's own init; `base` is the config the protocol
    is applied to (default ExperimentConfig()); `data_seed` overrides the
    partition draw."""
    from fedmse_tpu_torch.config import ExperimentConfig, paper_scale
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs

    n_clients = len(glob.glob(os.path.join(shard_dir, "Client-*")))
    if not n_clients:
        raise FileNotFoundError(f"no Client-* dirs under {shard_dir}")
    cfg = (ExperimentConfig() if base is None else base).replace(
        network_size=n_clients)
    if data_seed is not None:
        cfg = cfg.replace(data_seed=data_seed)
    if not quick:
        cfg = paper_scale(cfg)
    data, n_real, rngs = sweep.build_data(cfg, n_clients, shards=shard_dir,
                                          device=device)
    model = make_model("hybrid", cfg.dim_features,
                       shrink_lambda=cfg.shrink_lambda,
                       device=data.train_xb.device)
    engine = RoundEngine(model, cfg, data, n_real=n_real, rngs=rngs,
                         model_type="hybrid", update_type="mse_avg",
                         fused=True)
    per_run = []
    for run in range(runs):
        engine.rngs = ExperimentRngs(run=run, data_seed=cfg.data_seed)
        engine.reset_federation()
        if states is not None:
            engine.states = states[run].clone()
        results, sec = sweep.timed(engine.run_rounds, 0, cfg.num_rounds)
        means = [float(np.nanmean(r.client_metrics)) for r in results]
        per_run.append({"rounds_run": len(means),
                        "best_round_mean": round(max(means), 5),
                        "final_mean": round(means[-1], 5),
                        "round_means": [round(m, 5) for m in means],
                        "seconds": sec})
        print(json.dumps(per_run[-1]), flush=True)
    best = [r["best_round_mean"] for r in per_run]
    return {
        "shard_dir": os.path.abspath(shard_dir),
        "n_clients": n_clients,
        "data_seed": cfg.data_seed,
        "runs": per_run,
        "best_round_mean_avg": round(float(np.mean(best)), 5),
        "best_round_mean_std": round(float(np.std(best)), 5),
        "final_mean_avg": round(
            float(np.mean([r["final_mean"] for r in per_run])), 5),
        "protocol": ("fedmse_tpu_torch fused rounds, hybrid+mse_avg, "
                     + ("5 epochs, 3 rounds, lr 1e-3, lambda 5"
                        if quick else
                        "100 epochs, 20 rounds, lr 1e-5, lambda 10")
                     + ", no global early stop"),
        **(prov or {}),
    }


def main(argv=None):
    p = sweep.parser(__doc__, "PAPER_CHECK_torch.json")
    p.add_argument("shard_dir", help="a tree of Client-1 .. Client-n shards")
    p.add_argument("runs", nargs="?", type=int, default=3)
    p.add_argument("--quick", action="store_true",
                   help="the quick-run protocol (5 epochs, 3 rounds)")
    p.add_argument("--data-seed", type=int, default=None)
    args = p.parse_args(argv)
    if args.data_seed is not None and args.data_seed < 0:
        p.error("--data-seed must be >= 0")
    device, prov = sweep.start(args)
    out = measure(args.shard_dir, args.runs, quick=args.quick,
                  data_seed=args.data_seed, device=device, prov=prov)
    sweep.write(args.out, out)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

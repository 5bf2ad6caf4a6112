"""The readings the limits of a cell are set from, at the cell's own size:

* `sound`: the program, as a run drives it through its set-up rounds,
  against the reference (the lower readings);
* `control`: the reference itself put in the program's place, computed in
  the nearest precision below the configuration's f32 (TF32 matrix
  products), against the reference in f32;
* the program with a fault planted under its timed path, against the
  reference: `unchanged` (the local training's Adam step returns the
  state it was given), `half_batch` (the train step sees half of each
  batch and takes its mean over that half), `election` (the election's
  answer altered where it is made: whenever an aggregator is found, the
  cohort's last-selected client wins in its place, or the one selected
  before it where that was the winner), `score` (the evaluation's anomaly
  scores altered where they are made: each row's reconstruction MSE or
  kNN distance 1% higher, which leaves every AUC as it was). A cell on one
  card has no exchange between cards to leave out.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] \
        [--kinds sound,control,unchanged,half_batch,election,score]

prints one JSON line per (kind, seed) with every number of the
comparison. The benchmark's own runs never run this.
"""

import time

import argparse
import contextlib
import json
import logging
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import Cell, load_json  # noqa: E402
from benchmark.reference.compare import compare  # noqa: E402

KINDS = ("sound", "control", "unchanged", "half_batch", "election", "score")


@contextlib.contextmanager
def planted(kind: str):
    """The program with fault `kind` planted (nothing for sound runs)."""
    import torch
    from fedmse_tpu_torch.evaluation import evaluator
    from fedmse_tpu_torch.federation import fused, local_training
    saved = {}

    def swap(module, name, fn):
        saved[(module, name)] = getattr(module, name)
        setattr(module, name, fn)

    if kind == "unchanged":
        swap(local_training, "adam_step_", lambda *a, **k: None)
    elif kind == "half_batch":
        real = local_training.fused_train_grads

        def half(p, x, m, **kw):
            keep = m.clone()
            keep[:, m.shape[1] // 2:] = 0.0
            return real(p, x, keep, **kw)
        swap(local_training, "fused_train_grads", half)
    elif kind == "election":
        real_elect = fused.elect_on_device

        def altered(base, draws, sel, *a, **kw):
            agg, scores = real_elect(base, draws, sel, *a, **kw)
            other = torch.where(sel[-1] == agg, sel[-2], sel[-1])
            return torch.where(agg >= 0, other, agg), scores
        swap(fused, "elect_on_device", altered)
    elif kind == "score":
        real_stats = evaluator.fused_forward_stats
        real_kth = evaluator.routed_kth_distance

        def stats(*a, **kw):
            latent, mse, *rest = real_stats(*a, **kw)
            return (latent, mse * 1.01, *rest)
        swap(evaluator, "fused_forward_stats", stats)
        swap(evaluator, "routed_kth_distance",
             lambda *a, **kw: real_kth(*a, **kw) * 1.01)
    try:
        yield
    finally:
        for (module, name), fn in saved.items():
            setattr(module, name, fn)


def readings(cell: Cell, kind: str, seed: int, device) -> dict:
    """The comparison's numbers of one (kind, seed)."""
    import torch
    drv = cell.driver
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    if kind == "control":
        fed = drv.inputs(cell.config, cell.traffic, seed, device)
        prog = drv.reference_record(fed, tf32=True)
    else:
        with planted(kind):
            fed = drv.setup(cell.config, cell.traffic, seed, device)
        prog = fed.setup_record
        drv.free_program(fed)
    ref = drv.reference_record(fed, judged=prog)
    return {"kind": kind, "seed": seed, "seconds": time.perf_counter() - t0,
            **compare(prog, ref, cell.dims)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--kinds", default=",".join(KINDS))
    args = ap.parse_args(argv)
    logging.getLogger("fedmse_tpu_torch").setLevel(logging.CRITICAL)
    import torch
    if not torch.cuda.is_available():
        print("the readings are taken on the card", file=sys.stderr)
        return 2
    cell = Cell(load_json(ROOT / "BENCHMARK.json"), args.workload)
    for kind in args.kinds.split(","):
        for seed in args.seeds:
            print(json.dumps(readings(cell, kind, seed,
                                      torch.device("cuda", 0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

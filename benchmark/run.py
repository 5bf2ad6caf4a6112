"""Run one cell of the benchmark once, on the card this process sees.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (`correct`, `attempted`, `failed`, `metrics`, `device`, with
--trace 1 `breakdown`, then every number of the comparison and, last, each
compared number beside its limit); the last lines of standard error are
those numbers and limits. --trace 0 reports the cell's end-to-end
metrics, --trace 1 its per-layer metrics. Without CUDA, with fewer cards
than the cell asks for, or without the program beside the benchmark, it
exits with another code than 0 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import (Cell, forbidden_modules, load_json,  # noqa
                               run_cell)


def _clean(v):
    if isinstance(v, float) and not math.isfinite(v):
        return None
    if isinstance(v, dict):
        return {k: _clean(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_clean(x) for x in v]
    return v


def report(result: dict):
    """(the lines for standard error, the last line of standard output):
    each compared number beside its limit, last in both."""
    checks = result.pop("checks")
    lines = [f"{c['name']}: {c['value']!r} limit {c['limit']!r} "
             f"{'ok' if c['ok'] else 'FAILED'}" for c in checks]
    if not checks:
        lines.append("no limits: nothing compared")
    result["limits"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    return lines, json.dumps(_clean(result))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's per-round log lines are not the benchmark's output
    logging.getLogger("fedmse_tpu_torch").setLevel(logging.CRITICAL)
    spec = load_json(ROOT / "BENCHMARK.json")
    cell = Cell(spec, args.workload)
    import torch
    chips = cell.entry["chips"]
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < chips:
        print(f"this cell needs {chips} CUDA card(s); {seen} visible",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"modules of the JAX package or of JAX were loaded: {loaded}",
              file=sys.stderr)
        return 3
    card = result.get("card") or {}
    for when in ("open", "close"):
        if card.get(when):
            print(f"card at the window's {when}: {card[when]}",
                  file=sys.stderr)
    lines, last = report(result)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(last, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

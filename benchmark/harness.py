"""One run of one cell: the harness that `run.py` drives.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own, found by the name that
`BENCHMARK.json` gives:

* `configs/<config>.json`: the configuration as it is run;
* `traffic/<traffic>.json`: the traffic mix's parameters, and the driver
  (`drivers/<driver>.py`) that generates it and drives the window;
* `cells/<cell>.json`: the limits of the numbers the cell compares;
* `metrics/<metric>.py`: a per-layer metric's reader, `read(ctx)`, which
  returns the metric's value or None when it finds nothing to read.

A run: the driver's set-up (inputs from the seed, the program, its warm-up
and its first rounds), the card's state read, the window, the card's
state read again, the per-layer readers (traced runs), the program
freed, the plain reference over the first rounds and over the scores
the program kept, the comparison against the cell's limits, and the
check that no JAX module was loaded.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
# the whole top-level names that no process of the benchmark may load
FORBIDDEN = ("jax", "jaxlib", "flax", "fedmse_tpu")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# what nvidia-smi reads of the card at the window's opening and close
CARD_FIELDS = ("clocks.sm", "clocks.max.sm", "clocks.mem", "power.draw",
               "power.limit", "temperature.gpu", "pstate",
               "clocks_event_reasons.active")


def card_state() -> Optional[Dict[str, str]]:
    """The first card's clocks, power, temperature and clock-event reasons
    as nvidia-smi reads them (the reasons left out where this nvidia-smi
    does not know the field), or None where it cannot be read."""
    for fields in (CARD_FIELDS, CARD_FIELDS[:-1]):
        try:
            done = subprocess.run(
                ["nvidia-smi", "--query-gpu=" + ",".join(fields),
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=10)
        except (OSError, subprocess.SubprocessError):
            return None
        if done.returncode == 0 and done.stdout.strip():
            row = done.stdout.strip().splitlines()[0].split(", ")
            return dict(zip(fields, row))
    return None


class Cell:
    """A cell's files, by the names BENCHMARK.json gives."""

    def __init__(self, spec: Dict, name: str, root: Path = BENCH):
        work = {w["name"]: w for w in spec["workloads"]}
        if name not in work:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                             f"{sorted(work)}")
        self.spec, self.name, self.entry = spec, name, work[name]
        configs = {c["name"]: c for c in spec["configs"]}
        self.config = load_json(root.parent / configs[self.entry["config"]]
                                ["file"])
        self.dims = (self.config["dim_features"], self.config["hidden_neus"],
                     self.config["latent_dim"])
        self.traffic = load_json(root / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.limits = load_json(root / "cells" / f"{name}.json")["limits"]
        self.driver = importlib.import_module(
            f"benchmark.drivers.{self.traffic['driver']}")

    def _applies(self, metric: Dict, reported: Optional[set] = None) -> bool:
        if "workloads" in metric:
            return self.name in metric["workloads"]
        return reported is None or metric.get("moves") in reported

    def end_to_end(self) -> List[Dict]:
        return [m for m in self.spec["end_to_end"] if self._applies(m)]

    def per_layer(self) -> List[Dict]:
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in self.spec["per_layer"]
                if self._applies(m, reported)]


class Context:
    """What a per-layer reader reads: the cell, its shapes, the window's
    counts and clocks, the traced span (or None), and the device."""

    def __init__(self, cell: Cell, window: Dict, trace: Optional[Dict],
                 device):
        self.cell, self.window, self.trace = cell, window, trace
        self.config, self.traffic = cell.config, cell.traffic
        self.dims = cell.dims
        self.precision = cell.config["precision"]
        self.device = device
        self.on_card = device.type == "cuda"
        self.shapes = cell.driver.shapes_of(cell.traffic, cell.config)
        self.flops_per_round = cell.driver.flops_per_round(cell.config,
                                                           cell.traffic)


def _finite(v: float) -> Optional[float]:
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> Dict:
    """One run: the last line's object, with every number of the
    comparison under "numbers" and, under "checks", each compared one
    beside its limit ({name, value, limit, ok})."""
    import torch
    from benchmark.reference.compare import compare, judge
    from benchmark.trace import RoundTracer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    drv = cell.driver
    cuda = device.type == "cuda"
    fed = drv.setup(cell.config, cell.traffic, seed, device)
    card = {"open": card_state() if cuda else None}
    out = drv.window(fed, seconds)
    card["close"] = card_state() if cuda else None
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda
                   else "cpu", "count": 1 if cuda else 0,
                   "memory_peak_bytes": int(peak)}
    metrics: Dict[str, Dict] = {}
    breakdown = None
    if not trace:
        values = dict(drv.end_to_end(out), setup_s=out["t_open"] - t_start)
        for m in cell.end_to_end():
            v = _finite(values.get(m["name"]))
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        tracer = RoundTracer()
        drv.traced_chunk(fed, tracer)
        reduced = tracer.reduce() if cuda else None
        ctx = Context(cell, out, reduced, device)
        for m in cell.per_layer():
            reader = load_file(BENCH / "metrics" / f"{m['name']}.py",
                               "bench_metric_" + m["name"].replace(".", "_"))
            v = _finite(reader.read(ctx))
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if reduced is not None:
            device_info.update(busy_s=reduced["busy_s"],
                               window_s=reduced["window_s"])
            breakdown = {"device_ops": reduced["device_ops"],
                         "idle_gaps": reduced["idle_gaps"]}
    drv.free_program(fed)
    reference = drv.reference_record(fed, judged=fed.setup_record)
    numbers = compare(fed.setup_record, reference, cell.dims)
    checks = judge(numbers, cell.limits)
    result = {"correct": bool(checks) and all(c["ok"] for c in checks),
              "attempted": out["rounds"], "failed": out["failed"],
              "metrics": metrics, "device": device_info,
              # the window's work: its rounds, the epochs they ran and
              # the seconds of each chunk; the card's state around it
              "work": {"rounds": out["rounds"], "epochs": out["epochs"],
                       "chunk_s": out["chunk_s"]},
              "card": card}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result.update(numbers=numbers, checks=checks)
    return result

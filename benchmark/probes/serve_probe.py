"""A probe of the serving path, not a cell: does the card do real work
when 500 gateways score through `ContinuousBatcher` (max_batch 1024, the
2 ms `serve_latency_budget_ms`) over `ServingEngine.from_federation` with
gather routing and the kNN score?

A closed loop: each gateway keeps 2 bursts of 64 test rows in flight and
sends its next burst when a burst's verdicts are harvested (an inline
detector holding flows for their verdict). After a warm-up it traces a
steady span with torch.profiler (benchmark/trace.py's reduction) and then
counts rows and every row's latency, submission to harvest, untraced.

    python3 benchmark/probes/serve_probe.py --seed <n> --seconds <s>

prints one JSON line: rows/s, the latency percentiles, the batcher's
mean bucket and host-blocked share, the device's idle share over the
traced span, and the span's device operations and idle gaps.
"""

import argparse
import collections
import json
import logging
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import BENCH, load_json  # noqa: E402
from benchmark.trace import SPAN, profiler_events, reduce_events  # noqa

BURST, IN_FLIGHT = 64, 2


def closed_loop(batcher, rows, seconds, on_tick=None):
    """Run the loop for `seconds`; returns (rows served, latencies)."""
    n, t_rows = rows.shape[0], rows.shape[1]
    cursor = [0] * n
    flight = collections.deque()

    def send(g):
        at = cursor[g]
        cursor[g] = (at + BURST) % (t_rows - BURST)
        flight.append((g, batcher.submit_many(rows[g, at:at + BURST], g)))

    for g in range(n):
        for _ in range(IN_FLIGHT):
            send(g)
    served, lat = 0, []
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        if on_tick is not None:
            on_tick()
        batcher.poll()
        for _ in range(len(flight)):
            g, block = flight.popleft()
            if block.done:
                served += len(block)
                lat.append(block.latencies_s)
                send(g)
            else:
                flight.append((g, block))
    batcher.drain()
    return served, lat


def main(argv=None) -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    logging.getLogger("fedmse_tpu_torch").setLevel(logging.CRITICAL)
    from benchmark.drivers import federated_rounds as drv
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.models.flat import ParamLayout
    from fedmse_tpu_torch.serving.continuous import ContinuousBatcher
    from fedmse_tpu_torch.serving.engine import ServingEngine
    dev = torch.device("cuda", 0)
    config = load_json(BENCH / "configs" / "fedmse-hybrid-knn.json")
    traffic = load_json(BENCH / "traffic" / "fleet-500gw.json")
    fed = drv.inputs(config, traffic, args.seed, dev)
    dims = (config["dim_features"], config["hidden_neus"],
            config["latent_dim"])
    model = make_model("hybrid", *dims, config["shrink_lambda"], device=dev)
    engine = ServingEngine.from_federation(
        model, "hybrid", ParamLayout(*dims).tree(fed.params0),
        train_x=fed.data["train_xb"], train_m=fed.data["train_mb"],
        score_kind="knn", knn_bank_size=config["knn_bank_size"],
        knn_k=config["knn_k"], knn_topk=config["knn_topk"],
        max_bucket=1024, routing="gather", device=dev)
    rows = fed.data["test_x"].cpu().numpy()
    batcher = ContinuousBatcher(engine, max_batch=1024,
                                latency_budget_ms=2.0)
    closed_loop(batcher, rows, 3.0)  # warm-up: every bucket size met
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    mark = record_function(SPAN)
    mark.__enter__()
    closed_loop(batcher, rows, 1.0)
    mark.__exit__(None, None, None)
    torch.cuda.synchronize()
    prof.stop()
    span = reduce_events(profiler_events(prof))
    batcher = ContinuousBatcher(engine, max_batch=1024,
                                latency_budget_ms=2.0)
    t0 = time.perf_counter()
    served, lat = closed_loop(batcher, rows, args.seconds)
    wall = time.perf_counter() - t0
    lat_ms = np.concatenate(lat) * 1e3
    st = batcher.stats()
    print(json.dumps({
        "device": torch.cuda.get_device_name(dev),
        "rows_per_s": served / wall, "rows": served,
        "latency_p50_ms": float(np.percentile(lat_ms, 50)),
        "latency_p95_ms": float(np.percentile(lat_ms, 95)),
        "latency_p99_ms": float(np.percentile(lat_ms, 99)),
        "mean_batch": st["mean_batch"],
        "bucket_fill": st["mean_batch"] / st["max_batch"],
        "host_blocked_fraction": st["host_blocked_fraction"],
        "device_idle_share": None if span is None
        else 100.0 * (1 - span["busy_s"] / span["window_s"]),
        "span": span}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

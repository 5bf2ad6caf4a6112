"""End-to-end network-plane pass: checkpoint -> replicas -> TCP -> verdicts
(port of fedmse_tpu/net/smoke.py).

Wired to `python -m fedmse_tpu_torch.main ... --serve-net`: after the
sweep trains and checkpoints a federation, this rebuilds `cfg.net_replicas`
serving engines from the first combination's ClientModel tree, puts the
roster-aware router + tiered admission in front of them (each replica on
a CUDA stream of its own), binds the asyncio NetFront on `cfg.net_port`
(0 = ephemeral) and streams the test traffic back through a real
localhost TCP connection in NIC-poll bursts: the full train ->
checkpoint -> calibrate -> replicate -> socket -> verdict path in one
run. A mid-stream hot swap (the calibration broadcast to every replica)
and the per-status accounting ride in the report. The stream runs under
gc.freeze(), as the --serve pass does (serving/smoke.py), and the
collector is unfrozen in `finally`."""

from __future__ import annotations

import gc
import logging
from typing import Dict, Sequence

import numpy as np

logger = logging.getLogger(__name__)


def run_net_smoke(cfg, data, n_real: int, writer,
                  device_names: Sequence[str], model_type: str,
                  update_type: str, run: int = 0, max_rows: int = 2048,
                  burst: int = 64) -> Dict:
    """One network-plane pass over a just-checkpointed combination, on the
    device the federation's tensors live on."""
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.net.admission import AdmissionController
    from fedmse_tpu_torch.net.client import NetClient
    from fedmse_tpu_torch.net.router import Router, make_local_replicas
    from fedmse_tpu_torch.net.server import FrontHandle, NetFront
    from fedmse_tpu_torch.serving.calibration import fit_calibration
    from fedmse_tpu_torch.serving.engine import ServingEngine
    from fedmse_tpu_torch.serving.smoke import _host, interleave_test_rows

    device = data.train_xb.device
    model = make_model(model_type, cfg.dim_features, cfg.hidden_neus,
                       cfg.latent_dim, cfg.shrink_lambda,
                       precision=cfg.precision, device=device)

    def factory(i: int) -> ServingEngine:
        return ServingEngine.from_checkpoint(
            writer, model, model_type, update_type, device_names[:n_real],
            run=run, train_x=data.train_xb[:n_real],
            train_m=data.train_mb[:n_real],
            max_bucket=cfg.serve_max_batch, precision=cfg.precision,
            score_kind=cfg.score_kind, knn_bank_size=cfg.knn_bank_size,
            knn_k=cfg.knn_k, knn_topk=cfg.knn_topk, device=device)

    engines = [factory(i) for i in range(max(1, cfg.net_replicas))]
    calib = fit_calibration(engines[0], _host(data.valid_x[:n_real]),
                            _host(data.valid_m[:n_real]))
    replicas = make_local_replicas(
        lambda i: engines[i], len(engines), max_batch=cfg.serve_max_batch,
        latency_budget_ms=cfg.serve_latency_budget_ms, calibration=calib)
    router = Router(replicas, admission=AdmissionController(
        tiers=cfg.net_tiers, headroom=cfg.net_shed_headroom))

    rows, gws, _ = interleave_test_rows(
        _host(data.test_x[:n_real]), _host(data.test_m[:n_real]),
        _host(data.test_y[:n_real]), max_rows)
    if len(rows):
        router.calibrate_capacity(rows, gws)

    handle = FrontHandle(NetFront(router, port=cfg.net_port))
    client = None
    swapped = False
    gc.freeze()
    try:
        client = NetClient("127.0.0.1", handle.port)
        swap_at = len(rows) // 2
        for start in range(0, len(rows), burst):
            stop = min(start + burst, len(rows))
            client.submit(rows[start:stop], gws[start:stop])
            client.poll()
            if not swapped and start >= swap_at:
                # mid-stream threshold hot swap, broadcast to every
                # replica over the SAME socket the traffic rides
                client.swap({"calibration": calib})
                swapped = True
        client.wait_all()
        stats = client.stats()
    finally:
        gc.unfreeze()
        if client is not None:
            client.close()
        handle.stop()

    lat = client.latencies_s()
    counts = client.status_counts()
    report = {
        "model_type": model_type,
        "update_type": update_type,
        "run": run,
        "device": str(device),
        "score_kind": engines[0].score_kind,
        "gateways": n_real,
        "replicas": len(replicas),
        "port": handle.port,
        "rows_streamed": int(client.rows_submitted),
        "burst": burst,
        "statuses": counts,
        "zero_dropped": bool(
            sum(counts.values()) == client.rows_submitted
            and not client.outstanding),
        "swap_broadcast": swapped,
        "capacity_rows_per_sec": router.admission.capacity_rows_per_sec,
        "request_p50_ms": (float(np.percentile(lat, 50)) * 1e3
                           if len(lat) else None),
        "request_p99_ms": (float(np.percentile(lat, 99)) * 1e3
                           if len(lat) else None),
        "router": {k: v for k, v in stats["router"].items()
                   if k != "per_replica"},
    }
    logger.info(
        "net pass [%s/%s]: %d rows over TCP through %d replica(s), "
        "statuses %s, p99 %.2f ms",
        model_type, update_type, report["rows_streamed"],
        report["replicas"], counts, report["request_p99_ms"] or -1.0)
    return report

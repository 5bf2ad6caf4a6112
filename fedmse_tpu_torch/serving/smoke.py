"""End-to-end serving pass: checkpoint -> banks -> calibrate -> serve -> drift
(port of fedmse_tpu/serving/smoke.py).

Wired to `python -m fedmse_tpu_torch.main ... --serve`: after the sweep
trains and checkpoints a federation, this loads the first combination's
ClientModel tree back from disk (the serving process owns no training
state), builds and persists the kNN banks where the score needs them, fits
per-gateway thresholds on the validation normals, streams test traffic
through the micro-batched or the continuous front, and reports throughput,
latency, verdict and drift numbers.
"""

from __future__ import annotations

import gc
import logging
import os
from typing import Dict, Sequence

import numpy as np
import torch

from fedmse_tpu_torch.knn.bank import bank_path, save_bank
from fedmse_tpu_torch.models import make_model
from fedmse_tpu_torch.serving.batcher import MicroBatcher
from fedmse_tpu_torch.serving.calibration import fit_calibration
from fedmse_tpu_torch.serving.continuous import ContinuousBatcher
from fedmse_tpu_torch.serving.drift import DriftMonitor
from fedmse_tpu_torch.serving.engine import ServingEngine

logger = logging.getLogger(__name__)


def _host(t) -> np.ndarray:
    """A stacked data tensor (any dtype, any device) as float32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).cpu().numpy()
    return np.asarray(t, np.float32)


def interleave_order(test_m: np.ndarray, max_rows: int):
    """The arrival order of the gateways' valid test rows: row 0 of every
    gateway, then row 1, ... Returns (gateway [R], row [R]) index arrays
    into the stacked [N, T] test tensors."""
    r, g = np.nonzero(np.asarray(test_m).T > 0)  # by row, then by gateway
    return g[:max_rows], r[:max_rows]


def interleave_test_rows(test_x: np.ndarray, test_m: np.ndarray,
                         test_y: np.ndarray, max_rows: int):
    """Round-robin the gateways' valid test rows into one arrival stream
    (interleave_order). Returns (rows [R, D], gateway_ids [R],
    labels [R])."""
    g, r = interleave_order(test_m, max_rows)
    return (np.asarray(test_x, np.float32)[g, r], g.astype(np.int32),
            np.asarray(test_y, np.float32)[g, r])


def run_serve_smoke(cfg, data, n_real: int, writer,
                    device_names: Sequence[str], model_type: str,
                    update_type: str, run: int = 0, max_rows: int = 2048,
                    max_batch: int = 256, max_wait_ms: float = 2.0,
                    percentile: float = 95.0, warmup: bool = False,
                    continuous: bool = False) -> Dict:
    """One serving pass over a just-checkpointed combination, on the device
    the federation's tensors live on.

    `warmup=True` (`--serve-warmup`) scores one bucket of every rung before
    the stream starts; its wall seconds land in the report. `continuous=True`
    (`--serve-continuous`) streams through the continuous-batching front
    (`max_wait_ms` as its latency budget) instead of the micro-batcher.
    With score_kind 'knn' the banks are written beside the calibration
    JSON (knn.bank_path). The stream runs under gc.freeze(): the garbage
    collector's full collections skip everything setup left alive, and the
    pass ends with the collector unfrozen (gc.unfreeze returns every frozen
    object, those of any earlier freeze too), also when the stream
    raises."""
    device = data.train_xb.device
    model = make_model(model_type, cfg.dim_features, cfg.hidden_neus,
                       cfg.latent_dim, cfg.shrink_lambda,
                       precision=cfg.precision, device=device)
    engine = ServingEngine.from_checkpoint(
        writer, model, model_type, update_type, device_names[:n_real],
        run=run, train_x=data.train_xb[:n_real],
        train_m=data.train_mb[:n_real], max_bucket=max_batch,
        precision=cfg.precision, score_kind=cfg.score_kind,
        knn_bank_size=cfg.knn_bank_size, knn_k=cfg.knn_k,
        knn_topk=cfg.knn_topk, device=device)
    bank_file = None
    if engine.score_kind == "knn":
        bank_file = save_bank(
            bank_path(writer, run, model_type, update_type), engine.banks)
    calib = fit_calibration(engine, _host(data.valid_x[:n_real]),
                            _host(data.valid_m[:n_real]),
                            percentile=percentile)
    os.makedirs(writer.serving_dir(run), exist_ok=True)
    calib_path = calib.save(os.path.join(
        writer.serving_dir(run),
        f"{model_type}_{update_type}_calibration.json"))

    if continuous:
        batcher = ContinuousBatcher(engine, max_batch=max_batch,
                                    latency_budget_ms=max_wait_ms,
                                    calibration=calib)
    else:
        batcher = MicroBatcher(engine, max_batch=max_batch,
                               max_wait_ms=max_wait_ms, calibration=calib)
    warmup_sec = engine.warmup() if warmup else None
    # bucket_dispatches describes the served stream, not calibration/warmup
    engine.dispatches.clear()

    rows, gws, labels = interleave_test_rows(
        _host(data.test_x[:n_real]), _host(data.test_m[:n_real]),
        _host(data.test_y[:n_real]), max_rows)
    # Setup is done: every object alive now (the checkpoint, the engine, its
    # banks and calibration) moves to the collector's permanent generation,
    # so a full collection due inside the stream no longer walks them (one
    # took ~100 ms after training on an H100 and set the pass's p99).
    gc.freeze()
    try:
        tickets = [batcher.submit(rows[i], int(gws[i]))
                   for i in range(len(rows))]
        batcher.drain()
    finally:
        gc.unfreeze()

    verdicts = np.asarray([t.verdict for t in tickets], bool)
    # where the tail sits in the stream: the slowest row of each eighth, in
    # arrival order (a cold start shows in the first eighth)
    lat_ms = np.asarray([t.latency_s for t in tickets], np.float64) * 1e3
    by_eighth = [float(part.max()) for part in np.array_split(lat_ms, 8)
                 if len(part)]
    anomaly = labels > 0
    # the drift baseline is the normals-only calibration, so it sees the
    # stream's normal-labeled rows; the served scores are reused
    drift = DriftMonitor(calib)
    if len(rows):
        scores = np.asarray([t.score for t in tickets])
        drift.update(scores[~anomaly], gws[~anomaly])
    agree = float(np.mean(verdicts == anomaly)) if len(rows) else None
    report = {
        "model_type": model_type,
        "update_type": update_type,
        "run": run,
        "gateways": n_real,
        "rows": int(len(rows)),
        "score_kind": engine.score_kind,
        "knn_bank_path": bank_file,
        "calibration_path": calib_path,
        "calibration_percentile": percentile,
        "verdict_anomaly_rate": (float(np.mean(verdicts))
                                 if len(rows) else None),
        "label_anomaly_rate": (float(np.mean(anomaly))
                               if len(rows) else None),
        "verdict_label_agreement": agree,
        "front": "continuous" if continuous else "sync",
        "batcher": batcher.stats(),
        "latency_max_ms_by_eighth": by_eighth,
        "bucket_dispatches": {str(k): int(v)
                              for k, v in sorted(engine.dispatches.items())},
        "drift": drift.report(),
        "warmup": warmup,
        "warmup_sec_per_bucket": (
            None if warmup_sec is None
            else {str(k): v for k, v in warmup_sec.items()}),
        "device": str(device),
    }
    logger.info(
        "serve smoke [%s/%s, %s]: %d rows, %s rows/s, p95 %s ms, "
        "verdict/label agreement %s, drifted gateways %s", model_type,
        update_type, engine.score_kind, report["rows"],
        report["batcher"]["rows_per_sec_wall"],
        report["batcher"]["latency_p95_ms"], agree,
        report["drift"]["drifted_gateways"])
    return report

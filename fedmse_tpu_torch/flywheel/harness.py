"""End-to-end flywheel pass: checkpoint -> serve -> drift -> fine-tune -> hot
swap, in one call (port of fedmse_tpu/flywheel/harness.py; the CLI's
`python -m fedmse_tpu_torch.main ... --flywheel`).

After the sweep trains and checkpoints a federation, the pass rebuilds the
serving front from disk, attaches the flywheel (the reservoir tap and the
controller), streams the test traffic, then RAMPS a covariate shift into
the normal stream: a gateway's traffic walks away from the calibration in
steps small enough that much of it still verdicts normal (and so feeds the
reservoirs) while the drift monitor gathers the evidence. When the verdict
sustains, the controller fine-tunes on the buffered normals and installs
the atomic swap mid-stream. The report carries the swap events, ticket
integrity across them (zero dropped or duplicated), and the detection AUC
before the shift, stale under it, and after the loop adapted.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np

from fedmse_tpu_torch.flywheel.buffer import FlywheelBuffer
from fedmse_tpu_torch.flywheel.controller import FlywheelController
from fedmse_tpu_torch.models import make_model
from fedmse_tpu_torch.ops.metrics import roc_auc
from fedmse_tpu_torch.serving.calibration import fit_calibration
from fedmse_tpu_torch.serving.continuous import ContinuousBatcher
from fedmse_tpu_torch.serving.drift import DriftMonitor
from fedmse_tpu_torch.serving.engine import ServingEngine
from fedmse_tpu_torch.serving.smoke import _host, interleave_test_rows

logger = logging.getLogger(__name__)


def host_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Exact ROC AUC as a host float (ops/metrics.roc_auc: tie-averaged
    Mann-Whitney, NaN when a class is absent): the pass's recovery
    metric."""
    import torch

    return float(roc_auc(torch.as_tensor(np.asarray(labels, np.float32)),
                         torch.as_tensor(np.asarray(scores, np.float32))))


def stream_with_polling(batcher, controller, rows: np.ndarray,
                        gws: np.ndarray, chunk: int = 64,
                        settle: bool = True, on_chunk=None):
    """Feed a stream through the continuous front in burst chunks, ticking
    the controller between chunks (the deployment loop: NIC poll ->
    submit_many -> control tick). Returns (ticket blocks, swap events
    fired during this stream).

    `settle` waits for the in-flight batch to harvest before each tick, so
    the monitor and the controller always see a fully absorbed state and
    the trigger sequence does not depend on device timing.
    `on_chunk(k, controller)`, if given, runs after chunk k's tick (an
    observer, e.g. of the served params)."""
    blocks, events = [], []
    for k, start in enumerate(range(0, len(rows), chunk)):
        stop = min(start + chunk, len(rows))
        blocks.append(batcher.submit_many(rows[start:stop], gws[start:stop]))
        batcher.poll()
        if settle:
            while batcher._inflight is not None:
                batcher.poll()
        if controller is not None:
            event = controller.poll()
            if event is not None:
                events.append(event)
        if on_chunk is not None:
            on_chunk(k, controller)
    batcher.drain()
    if controller is not None:
        event = controller.poll()
        if event is not None:
            events.append(event)
        if getattr(controller, "finetune_pending", False):
            # a background fine-tune outlived the stream: land its swap
            # before handing back, so trajectories stay comparable
            event = controller.wait()
            if event is not None:
                events.append(event)
    return blocks, events


def ticket_integrity(blocks) -> Dict:
    """Zero-downtime accounting: every submitted ticket resolved exactly
    once (block lengths == resolved scores, all done)."""
    submitted = sum(len(b) for b in blocks)
    done = sum(len(b) for b in blocks if b.done and b.scores is not None)
    return {"rows_submitted": int(submitted),
            "rows_resolved": int(done),
            "zero_dropped": bool(submitted == done)}


def run_flywheel_smoke(cfg, data, n_real: int, writer, device_names,
                       model_type: str, update_type: str, run: int = 0,
                       max_rows: int = 2048,
                       shift_sigma: Optional[float] = None,
                       shift_stages: int = 4, seed: int = 7,
                       on_chunk=None) -> Dict:
    """One closed-loop pass over a just-checkpointed combination (module
    docstring). `shift_sigma` is the TOTAL covariate shift in feature-std
    units (default cfg.flywheel_shift), ramped over `shift_stages` equal
    steps, on the device the federation's tensors live on. `on_chunk(stage,
    k, controller)` observes each streamed chunk after its control tick
    (stage 0 the calibrated regime, 1.. the ramp)."""
    dev = data.train_xb.device
    if shift_sigma is None:
        shift_sigma = cfg.flywheel_shift
    model = make_model(model_type, cfg.dim_features, cfg.hidden_neus,
                       cfg.latent_dim, cfg.shrink_lambda,
                       precision=cfg.precision, device=dev)
    engine = ServingEngine.from_checkpoint(
        writer, model, model_type, update_type, device_names[:n_real],
        run=run, train_x=data.train_xb[:n_real],
        train_m=data.train_mb[:n_real], max_bucket=cfg.serve_max_batch,
        precision=cfg.precision, score_kind=cfg.score_kind,
        knn_bank_size=cfg.knn_bank_size, knn_k=cfg.knn_k,
        knn_topk=cfg.knn_topk, device=dev)
    calib = fit_calibration(engine, _host(data.valid_x[:n_real]),
                            _host(data.valid_m[:n_real]),
                            percentile=cfg.flywheel_percentile)
    monitor = DriftMonitor(calib, z_threshold=cfg.flywheel_z,
                           min_batches=2,
                           cooldown_updates=cfg.flywheel_cooldown)
    buffer = FlywheelBuffer(n_real, cfg.dim_features,
                            capacity=cfg.flywheel_buffer_size, seed=seed,
                            decay=cfg.flywheel_decay or None)
    batcher = ContinuousBatcher(
        engine, max_batch=cfg.serve_max_batch,
        latency_budget_ms=cfg.serve_latency_budget_ms,
        calibration=calib, drift=monitor, intake=buffer.tap())
    controller = FlywheelController(
        batcher, monitor, buffer, model, model_type, update_type, cfg,
        dev_x=_host(data.dev_x), rounds=cfg.flywheel_rounds,
        quorum=cfg.flywheel_quorum, min_rows=cfg.flywheel_min_rows,
        background=cfg.flywheel_async,
        # with decay the reservoir tracks the walking regime by
        # down-weighting, not by emptying
        clear_on_swap=not cfg.flywheel_decay)

    rows, gws, labels = interleave_test_rows(
        _host(data.test_x[:n_real]), _host(data.test_m[:n_real]),
        _host(data.test_y[:n_real]), max_rows)
    normal = labels <= 0
    rng = np.random.default_rng(seed)
    u = rng.normal(size=cfg.dim_features)
    u /= np.linalg.norm(u)
    u32 = u.astype(np.float32)

    def eval_auc(shift: float) -> float:
        return host_auc(labels, engine.score(rows + np.float32(shift) * u32,
                                             gws))

    def observer(stage):
        if on_chunk is None:
            return None
        return lambda k, ctl: on_chunk(stage, k, ctl)

    # phase A: the calibrated regime; normal traffic fills the reservoirs
    blocks_a, events_a = stream_with_polling(
        batcher, controller, rows[normal], gws[normal],
        on_chunk=observer(0))
    auc_pre = eval_auc(0.0)

    # phase B: the WHOLE regime (normal and attack traffic alike) moves by
    # shift_sigma feature-stds, in stages; the loop must notice, fine-tune
    # on the buffered normals, and swap
    auc_stale = eval_auc(shift_sigma)  # the never-adapting detector's view
    all_blocks, all_events = list(blocks_a), list(events_a)
    for stage in range(1, shift_stages + 1):
        step = shift_sigma * stage / shift_stages
        shifted = rows[normal] + np.float32(step) * u32
        blocks, events = stream_with_polling(
            batcher, controller, shifted, gws[normal],
            on_chunk=observer(stage))
        all_blocks.extend(blocks)
        all_events.extend(events)

    auc_post = eval_auc(shift_sigma)  # the same eval after the loop adapted
    integrity = ticket_integrity(all_blocks)
    report = {
        "model_type": model_type,
        "update_type": update_type,
        "run": run,
        "gateways": n_real,
        "score_kind": engine.score_kind,
        "shift_sigma": shift_sigma,
        "shift_stages": shift_stages,
        "auc_pre_shift": auc_pre,
        "auc_post_shift_stale": auc_stale,
        "auc_post_shift_adapted": auc_post,
        "swap_events": len(all_events),
        "events": all_events,
        "engine_swap_count": engine.swap_count,
        "buffer": buffer.occupancy(),
        "drift": {k: v for k, v in monitor.report().items()
                  if k != "gateways"},
        "tickets": integrity,
        "batcher": batcher.stats(),
    }
    logger.info(
        "flywheel smoke [%s/%s]: AUC pre %.3f -> stale %.3f -> adapted "
        "%.3f after %d swap(s); tickets %d/%d resolved",
        model_type, update_type, auc_pre, auc_stale, auc_post,
        len(all_events), integrity["rows_resolved"],
        integrity["rows_submitted"])
    return report

"""Per-client anomaly-detection evaluation over the stacked client axis
(port of fedmse_tpu/evaluation/evaluator.py::make_evaluate_all).

  * score 'mse' (the autoencoder's): per-row reconstruction MSE of the test
    rows under the client's own model;
  * score 'centroid' (the hybrid's): encode the client's train rows, fit
    the centroid classifier on their masked latents, score the test latents
    by centroid density.

The forward always goes through `ops.fused_ae.fused_forward_stats`, ONE
launch over all clients' rows ([N, T] test rows, plus the [N, S] train
rows for the centroid fit, each row routed to its client's model). Scores
get the reference's nan_to_num guard; the metric is the per-client AUC,
(f1, precision, recall) or the raw scores. metric='time' is the
reference's inference-latency mode: each client's scoring, one launch per
call, timed on the host clock after a warm-up (the device synchronized at
the end of each client's repetitions).
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from fedmse_tpu_torch.models.centroid import fit_centroid
from fedmse_tpu_torch.ops.fused_ae import fused_forward_stats
from fedmse_tpu_torch.ops.metrics import classification_metrics, roc_auc
from fedmse_tpu_torch.ops.precision import cast_params

METRICS = ("AUC", "classification", "scores", "time")


def resolve_score_kind(model_type: str, score_kind: str) -> str:
    """'auto' keeps the reference pairing (autoencoder -> 'mse', hybrid ->
    'centroid'); 'mse' / 'centroid' / 'knn' force that score."""
    if score_kind not in ("auto", "mse", "centroid", "knn"):
        raise ValueError(f"unknown score_kind {score_kind!r}; expected "
                         "'auto' | 'mse' | 'centroid' | 'knn'")
    if score_kind == "auto":
        return "mse" if model_type == "autoencoder" else "centroid"
    return score_kind


def knn_not_ported() -> NotImplementedError:
    return NotImplementedError(
        "score_kind='knn' waits for the port of fedmse_tpu/knn/ and its "
        "_dist_kernel (ROADMAP.md queue 1, the knn slice; queue 2, item 3)")


def client_index(n: int, rows_each: int, device) -> torch.Tensor:
    """The model index of n clients' rows laid out client-major."""
    return torch.arange(n, dtype=torch.int32,
                        device=device).repeat_interleave(rows_each)


def make_evaluate_all(model, model_type: str, metric: str = "AUC",
                      score_kind: str = "auto",
                      latency_reps: int = 5) -> Callable:
    """fn(stacked_params, test_x [N, T, D], test_m [N, T], test_y [N, T],
    train_xb [N, NB, B, D], train_mb [N, NB, B]) -> per-client AUC [N],
    (f1, precision, recall) [N, 3] for 'classification', the
    nan_to_num'd scores [N, T] for 'scores' (the serving engine's oracle),
    or the steady-state seconds of one client's scoring [N] (float64, on
    the CPU) for 'time'. Runs where the tensors are: on the card through
    the fused kernel."""
    kind = resolve_score_kind(model_type, score_kind)
    if kind == "knn":
        raise knn_not_ported()
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; expected one of "
                         f"{METRICS}")
    cdt = model.compute_dtype

    def anomaly_scores(params, test_x, train_xb, train_mb):
        n, t, d = test_x.shape
        dev = test_x.device
        rows = test_x.reshape(n * t, d).to(cdt)
        idx = client_index(n, t, dev)
        if kind == "mse":
            _, mse, _ = fused_forward_stats(params, rows, idx,
                                            compute_dtype=cdt)
            return mse.view(n, t)
        train_rows = train_xb.reshape(n, -1, d)
        s = train_rows.shape[1]
        latent, _, _ = fused_forward_stats(
            params, torch.cat([rows, train_rows.reshape(n * s, d).to(cdt)]),
            torch.cat([idx, client_index(n, s, dev)]), compute_dtype=cdt)
        cen = fit_centroid(latent[n * t:].view(n, s, -1),
                           train_mb.reshape(n, s))
        return cen.get_density(latent[:n * t].view(n, t, -1))

    def sync(t):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)

    @torch.no_grad()
    def latency_all(stacked_params, test_x, test_m, test_y, train_xb,
                    train_mb):
        params = cast_params(stacked_params, cdt)

        def one(i):
            take = lambda t: t[i:i + 1]  # noqa: E731
            return anomaly_scores(
                {c: {k: {leaf: take(v) for leaf, v in layer.items()}
                     for k, layer in coder.items()}
                 for c, coder in params.items()},
                take(test_x), take(train_xb), take(train_mb))

        sync(one(0))  # warm-up, out of the clock
        lat = torch.zeros(test_x.shape[0], dtype=torch.float64)
        for i in range(test_x.shape[0]):
            t0 = time.perf_counter()
            for _ in range(latency_reps):
                out = one(i)
            sync(out)
            lat[i] = (time.perf_counter() - t0) / latency_reps
        return lat

    @torch.no_grad()
    def evaluate_all(stacked_params, test_x, test_m, test_y, train_xb,
                     train_mb):
        params = cast_params(stacked_params, cdt)
        scores = torch.nan_to_num(anomaly_scores(params, test_x, train_xb,
                                                 train_mb))
        if metric == "scores":
            return scores
        if metric == "AUC":
            return roc_auc(test_y, scores, test_m)
        return torch.stack(classification_metrics(test_y, scores, test_m),
                           dim=-1)

    return latency_all if metric == "time" else evaluate_all

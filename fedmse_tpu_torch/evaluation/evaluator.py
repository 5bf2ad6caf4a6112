"""Per-client anomaly-detection evaluation over the stacked client axis
(port of fedmse_tpu/evaluation/evaluator.py::make_evaluate_all).

  * score 'mse' (the autoencoder's): per-row reconstruction MSE of the test
    rows under the client's own model;
  * score 'centroid' (the hybrid's): encode the client's train rows, fit
    the centroid classifier on their masked latents, score the test latents
    by centroid density;
  * score 'knn' (either model): encode the train rows, downsample each
    client's masked latents into a bank of knn_bank_size (knn/bank.py, the
    same per-gateway draws as knn.build_banks), score each test latent by
    its distance to the knn_k-th nearest bank latent.

The forward always goes through `ops.fused_ae.fused_forward_stats`, ONE
launch over all clients' rows ([N, T] test rows, plus the [N, S] train
rows for the centroid fit or the banks, each row routed to its client's
model). The kNN score is ONE launch of knn.knn_score over all N x T test
rows, each against its own client's bank. Scores
get the reference's nan_to_num guard; the metric is the per-client AUC,
(f1, precision, recall) or the raw scores. metric='time' is the
reference's inference-latency mode: each client's scoring, one launch per
call, timed on the host clock after a warm-up (the device synchronized at
the end of each client's repetitions).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from fedmse_tpu_torch.knn.bank import (ReferenceBank, bank_priorities,
                                       downsample_stacked)
from fedmse_tpu_torch.knn.score import routed_kth_distance
from fedmse_tpu_torch.models.centroid import fit_centroid
from fedmse_tpu_torch.ops.fused_ae import client_index, fused_forward_stats
from fedmse_tpu_torch.ops.metrics import classification_metrics, roc_auc
from fedmse_tpu_torch.ops.precision import cast_params

METRICS = ("AUC", "classification", "scores", "time")


def resolve_score_kind(model_type: str, score_kind: str) -> str:
    """'auto' keeps the reference pairing (autoencoder -> 'mse', hybrid ->
    'centroid'; kitnet -> 'mse', its output autoencoder's per-row
    statistic, the only score it has); 'mse' / 'centroid' / 'knn' force
    that score."""
    if score_kind not in ("auto", "mse", "centroid", "knn"):
        raise ValueError(f"unknown score_kind {score_kind!r}; expected "
                         "'auto' | 'mse' | 'centroid' | 'knn'")
    if model_type == "kitnet" and score_kind not in ("auto", "mse"):
        raise ValueError(f"model_type 'kitnet' scores by its output "
                         f"autoencoder ('auto' or 'mse'), not "
                         f"{score_kind!r}")
    if score_kind == "auto":
        return "mse" if model_type in ("autoencoder", "kitnet") \
            else "centroid"
    return score_kind


def make_evaluate_all(model, model_type: str, metric: str = "AUC",
                      score_kind: str = "auto", latency_reps: int = 5,
                      knn_bank_size: int = 1024, knn_k: int = 8,
                      knn_topk: str = "exact",
                      knn_seed: int = 0) -> Callable:
    """fn(stacked_params, test_x [N, T, D], test_m [N, T], test_y [N, T],
    train_xb [N, NB, B, D], train_mb [N, NB, B], priorities=None, first=0) ->
    per-client AUC [N], (f1, precision, recall) [N, 3] for
    'classification', the nan_to_num'd scores [N, T] for 'scores' (the
    serving engine's oracle), or the steady-state seconds of one client's
    scoring [N] (float64, on the CPU) for 'time'. Runs where the tensors
    are: on the card through the fused kernel (and, for 'knn', the kNN
    score kernel). The knn_* arguments configure score_kind 'knn';
    client i's bank draw is seeded from (knn_seed, i), as knn.build_banks
    seeds it. The draw is made on the CPU; a caller that evaluates again
    and again (the fused round, whose CUDA graph cannot copy from the
    host) draws it once with the returned function's
    `bank_priorities(N, NB * B, device)` and passes it as `priorities`.
    `first` is the absolute id of client 0 of these tensors (a rank's
    block of a client mesh): without `priorities`, client i's bank is
    drawn as client first + i's."""
    kind = resolve_score_kind(model_type, score_kind)
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; expected one of "
                         f"{METRICS}")
    cdt = model.compute_dtype

    def anomaly_scores(params, test_x, train_xb, train_mb, first=0,
                       priorities=None):
        # first: the absolute index of client 0 of these tensors (the
        # 'time' metric scores one client at a time)
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
        train_latent = latent[n * t:].view(n, s, -1)
        train_m = train_mb.reshape(n, s)
        if kind == "knn":
            if priorities is None:
                priorities = bank_priorities(knn_seed, n, s, first=first,
                                             device=dev)
            bank = ReferenceBank(*downsample_stacked(
                train_latent, train_m > 0, priorities, knn_bank_size))
            return routed_kth_distance(latent[:n * t], idx, bank, knn_k,
                                       topk=knn_topk).view(n, t)
        cen = fit_centroid(train_latent, train_m)
        return cen.get_density(latent[:n * t].view(n, t, -1))

    def sync(t):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)

    @torch.no_grad()
    def latency_all(stacked_params, test_x, test_m, test_y, train_xb,
                    train_mb, priorities=None, first=0):
        params = cast_params(stacked_params, cdt)

        def one(i):
            take = lambda t: t[i:i + 1]  # noqa: E731
            return anomaly_scores(
                {c: {k: {leaf: take(v) for leaf, v in layer.items()}
                     for k, layer in coder.items()}
                 for c, coder in params.items()},
                take(test_x), take(train_xb), take(train_mb),
                first=first + i,
                priorities=None if priorities is None else take(priorities))

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
                     train_mb, priorities=None, first=0):
        params = cast_params(stacked_params, cdt)
        scores = torch.nan_to_num(anomaly_scores(params, test_x, train_xb,
                                                 train_mb, first=first,
                                                 priorities=priorities))
        if metric == "scores":
            return scores
        if metric == "AUC":
            return roc_auc(test_y, scores, test_m)
        return torch.stack(classification_metrics(test_y, scores, test_m),
                           dim=-1)

    def priorities(n: int, rows: int, device, ids=None
                   ) -> Optional[torch.Tensor]:
        """The kNN bank priorities of n clients' `rows` train rows that an
        evaluation draws by default, on `device`; None unless the score is
        'knn'. `ids` (n absolute client ids; a negative id draws client
        0's) gives those clients' draws instead of clients 0 .. n - 1's:
        a tiered cohort's."""
        if kind != "knn":
            return None
        if ids is None:
            return bank_priorities(knn_seed, n, rows, device=device)
        return torch.cat([bank_priorities(knn_seed, 1, rows,
                                          first=max(int(i), 0))
                          for i in ids]).to(device)

    fn = latency_all if metric == "time" else evaluate_all
    fn.bank_priorities = priorities
    return fn

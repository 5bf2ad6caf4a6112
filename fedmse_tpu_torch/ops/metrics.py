"""Masked evaluation metrics (port of fedmse_tpu/ops/metrics.py), batched
over any leading axes.

`roc_auc` is the exact trapezoidal ROC AUC through the tie-corrected
Mann-Whitney statistic (what sklearn's roc_curve + auc computes); padded
rows (mask 0) are excluded exactly, and a set with only one class gives
NaN. `classification_metrics` gives (f1, precision, recall) of the hard
labels `score > threshold` (sklearn's zero division -> 0).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def roc_auc(labels: torch.Tensor, scores: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact ROC AUC with tie handling over the last axis: [..., T] -> [...]."""
    if mask is None:
        mask = torch.ones_like(scores)
    valid = mask > 0
    s = torch.where(valid, scores, torch.full_like(scores, float("inf")))
    sorted_s = torch.sort(s, dim=-1).values.contiguous()
    s = s.contiguous()
    lo = torch.searchsorted(sorted_s, s, side="left")
    hi = torch.searchsorted(sorted_s, s, side="right")
    # 1-based average rank among valid rows: pads sit at +inf, never below a
    # valid score
    rdt = torch.float64 if s.dtype == torch.float64 else torch.float32
    rank = lo.to(rdt) + (hi - lo + 1).to(rdt) * 0.5
    pos = (labels > 0.5) & valid
    n_pos = pos.sum(dim=-1).to(rdt)
    n_neg = valid.sum(dim=-1).to(rdt) - n_pos
    mean_rank_pos = torch.where(pos, rank, torch.zeros_like(rank)).sum(dim=-1) \
        / torch.clamp(n_pos, min=1.0)
    auc = (mean_rank_pos - (n_pos + 1.0) * 0.5) / torch.clamp(n_neg, min=1.0)
    return torch.where(n_pos * n_neg > 0, auc, torch.full_like(auc, float("nan")))


def classification_metrics(labels: torch.Tensor, scores: torch.Tensor,
                           mask: Optional[torch.Tensor] = None,
                           threshold: float = 0.5
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(f1, precision, recall) at `score > threshold` over the last axis."""
    if mask is None:
        mask = torch.ones_like(scores)
    valid = mask > 0
    pred = (scores > threshold) & valid
    actual = (labels > 0.5) & valid
    f32 = torch.float32
    tp = (pred & actual).sum(dim=-1).to(f32)
    fp = (pred & ~actual).sum(dim=-1).to(f32)
    fn = (~pred & actual).sum(dim=-1).to(f32)
    zero = torch.zeros_like(tp)
    precision = torch.where(tp + fp > 0, tp / torch.clamp(tp + fp, min=1.0), zero)
    recall = torch.where(tp + fn > 0, tp / torch.clamp(tp + fn, min=1.0), zero)
    f1 = torch.where(precision + recall > 0,
                     2 * precision * recall
                     / torch.clamp(precision + recall, min=1e-38), zero)
    return f1, precision, recall

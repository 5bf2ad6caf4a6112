"""Centroid one-class classifier over the shrink-AE latent space (port of
fedmse_tpu/models/centroid.py).

Standardize the training latents (so the centroid becomes the origin); the
anomaly score is the distance to the origin; the decision threshold is the
100*threshold percentile of the training distances (default 0.5: the
median). Masked and batched: `fit_centroid` takes padded latents
[..., S, L] with a row mask [..., S] and fits one classifier per leading
index, so all N clients of a stacked federation fit in one call.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from fedmse_tpu_torch.ops.distance import norm_to_origin
from fedmse_tpu_torch.ops.stats import masked_mean_std, masked_percentile


@dataclasses.dataclass
class CentroidClassifier:
    """Fitted state: scaler statistics and the absolute threshold, each
    with the same leading axes ([L] for one classifier, [N, L] stacked)."""

    mean: torch.Tensor           # [..., L]
    scale: torch.Tensor          # [..., L]
    abs_threshold: torch.Tensor  # [...]

    def get_density(self, x: torch.Tensor, scale: bool = True) -> torch.Tensor:
        """Distance to the origin of the standardized latents, f32. x has
        the classifier's leading axes, optionally plus a row axis before the
        last ([..., T, L] against [..., L])."""
        if scale:
            mean, sc = self.mean, self.scale
            if x.dim() > mean.dim():
                mean, sc = mean.unsqueeze(-2), sc.unsqueeze(-2)
            x = (x.to(torch.float32) - mean) / sc
        return norm_to_origin(x)

    def take(self, idx: torch.Tensor) -> "CentroidClassifier":
        """The classifiers at gateway indices `idx` of a stacked one."""
        return CentroidClassifier(self.mean[idx], self.scale[idx],
                                  self.abs_threshold[idx])

    def to(self, device) -> "CentroidClassifier":
        return CentroidClassifier(
            *(t.to(device=device, dtype=torch.float32)
              for t in (self.mean, self.scale, self.abs_threshold)))


def fit_centroid(train_latent: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 threshold: float = 0.5) -> CentroidClassifier:
    """Fit on (padded) training latents [..., S, L]: sklearn StandardScaler
    semantics (biased std, zero-variance columns scale 1.0)."""
    mean, scale = masked_mean_std(train_latent, mask, ddof=0)
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    scaled = (train_latent.to(torch.float32) - mean.unsqueeze(-2)) \
        / scale.unsqueeze(-2)
    dists = norm_to_origin(scaled)
    abs_threshold = masked_percentile(dists, 100.0 * threshold, mask)
    return CentroidClassifier(mean=mean, scale=scale,
                              abs_threshold=abs_threshold)

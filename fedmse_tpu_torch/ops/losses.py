"""Loss math with row masking (port of fedmse_tpu/ops/losses.py).

  * `per_sample_mse` — per-row mean squared error, the AE anomaly score.
  * `masked_mean`    — mean over rows where mask == 1, with the
                       reference's 1e-38 safe division (`safe_div`): an
                       all-zero mask (M = 0) gives NaN.
  * `mse_loss`       — torch MSELoss('mean') over valid rows.
  * `shrink_loss`    — MSE + lambda * mean_rows ||latent||_2 with the safe
                       norm (a zero latent gets norm 0 and a finite
                       gradient, not NaN).

Every reduction accumulates in f32 whatever the operand dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

ACCUM = torch.float32
# The reference floors the denominator at 1e-38, which is subnormal in f32;
# XLA flushes it to zero, so the floor is in effect 0 and M = 0 divides
# 0 by 0. torch keeps subnormals, so the flushed floor is written out here.
_DEN_FLOOR = 0.0


def safe_div(num, den: torch.Tensor) -> torch.Tensor:
    """num / max(den, floor) with the reference's flushed floor: a zero
    denominator gives x / 0."""
    return num / torch.clamp(den, min=_DEN_FLOOR)


def masked_mean(values: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean of `values` rows where mask == 1; accumulates and returns f32."""
    if mask is None:
        return values.to(ACCUM).mean()
    return safe_div((values.to(ACCUM) * mask).sum(dtype=ACCUM),
                     mask.sum(dtype=ACCUM))


def per_sample_mse(x: torch.Tensor, recon: torch.Tensor) -> torch.Tensor:
    """Per-row mean squared error: [rows, D] -> [rows], f32."""
    return torch.square(x.to(ACCUM) - recon.to(ACCUM)).mean(dim=-1)


def mse_loss(x: torch.Tensor, recon: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSELoss('mean') over valid rows: sum (x - recon)^2 / (rows * D)."""
    return masked_mean(per_sample_mse(x, recon), mask)


def shrink_loss(x: torch.Tensor, recon: torch.Tensor, latent: torch.Tensor,
                shrink_lambda: float,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSE + lambda * mean_rows ||latent||_2, with the safe norm."""
    sq = torch.square(latent.to(ACCUM)).sum(dim=-1)
    pos = sq > 0
    norms = torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))) * pos
    return mse_loss(x, recon, mask) + shrink_lambda * masked_mean(norms, mask)


def prox_term(params, global_params) -> torch.Tensor:
    """sum over all parameters of (p - p_global)^2, accumulated in f32.
    A flat [..., P] buffer (models/flat.py) gives one term per leading
    index (one per client of an [S, P] cohort); a param tree (nested dicts
    of tensors) gives one scalar, the sum over its leaves."""
    if isinstance(params, dict):
        return sum(prox_term(params[k], global_params[k]).sum()
                   for k in sorted(params))
    d = params.to(ACCUM) - global_params.to(ACCUM)
    return torch.square(d).sum(dim=-1)

"""Masked statistics (port of fedmse_tpu/ops/stats.py), batched: every
function reduces over the row axis and keeps any leading axes, so the
per-client statistics of a stacked [N, S, ...] federation are one call.
Sums accumulate in f32 and the results are f32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

ACCUM = torch.float32


def masked_mean_std(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                    ddof: int = 0, eps: float = 0.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Column mean/std over valid rows: x [..., S, F], mask [..., S] ->
    ([..., F], [..., F]). ddof=0 matches sklearn's StandardScaler, ddof=1
    torch's .std()."""
    x = x.to(ACCUM)
    if mask is None:
        n = torch.tensor(float(x.shape[-2]), dtype=ACCUM, device=x.device)
        mean = x.mean(dim=-2)
        var = torch.square(x - mean.unsqueeze(-2)).sum(dim=-2) \
            / torch.clamp(n - ddof, min=1.0)
    else:
        m = mask.to(ACCUM).unsqueeze(-1)
        n = m.sum(dim=-2)
        mean = (x * m).sum(dim=-2) / torch.clamp(n, min=1.0)
        var = (torch.square(x - mean.unsqueeze(-2)) * m).sum(dim=-2) \
            / torch.clamp(n - ddof, min=1.0)
    return mean, torch.sqrt(var) + eps


def masked_percentile(values: torch.Tensor, q: float,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """np.percentile (linear interpolation) over valid entries of the last
    axis: values [..., S] -> [...].

    Pads sort to +inf; the interpolation position is q/100 * (n - 1) with
    the valid count n, and the upper neighbour falls back to the lower one
    when it would be the first pad (hi == n, an integral position)."""
    values = values.to(ACCUM)
    if mask is None:
        mask = torch.ones_like(values)
    valid = mask > 0
    s = torch.sort(torch.where(valid, values,
                               torch.full_like(values, float("inf"))),
                   dim=-1).values
    n = valid.sum(dim=-1, keepdim=True)
    last = values.shape[-1] - 1
    pos = (q / 100.0) * (n.to(ACCUM) - 1.0)
    lo = torch.clamp(torch.floor(pos).long(), 0, last)
    hi = torch.clamp(lo + 1, 0, last)
    frac = pos - lo.to(ACCUM)
    v_lo = torch.gather(s, -1, lo)
    v_hi = torch.where(hi < n, torch.gather(s, -1, hi), v_lo)
    return (v_lo + frac * (v_hi - v_lo)).squeeze(-1)

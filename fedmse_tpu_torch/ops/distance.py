"""Row-norm and pairwise distance math with f32 accumulation (port of
fedmse_tpu/ops/distance.py).

  * `sq_norms` / `norm_to_origin` — row squared norms / L2 norms over the
    last axis; bf16 rows upcast before the square.
  * `row_norms_packed` — sqrt(sum(square)) with keepdims, the formula the
    fused forward uses for the latent norm.
  * `pairwise_sq_dists` — ||q||^2 - 2 q.b^T + ||b||^2 clamped at 0 (float
    cancellation can drive it a few ulp negative);
  * `quadratic_form` — diff^T cov_inv diff, batched over leading axes (the
    Gaussian-KL term of the clustering metric, cluster/similarity.py).
"""

from __future__ import annotations

import torch

ACCUM = torch.float32


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Row squared L2 norms over the last axis, f32."""
    return torch.square(x.to(ACCUM)).sum(dim=-1)


def norm_to_origin(x: torch.Tensor) -> torch.Tensor:
    """Row L2 norms over the last axis (the centroid density score), f32."""
    return torch.sqrt(sq_norms(x))


def row_norms_packed(x: torch.Tensor) -> torch.Tensor:
    """Row L2 norms with keepdims: sqrt(sum(square(x)))."""
    return torch.sqrt(torch.square(x).sum(dim=-1, keepdim=True))


def pairwise_sq_dists(q: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs squared Euclidean distances [Q, L] x [B, L] -> [Q, B], f32."""
    cross = q.to(ACCUM) @ b.to(ACCUM).T
    d = sq_norms(q)[:, None] - 2.0 * cross + sq_norms(b)[None, :]
    return torch.clamp(d, min=0.0)


def quadratic_form(diff: torch.Tensor, cov_inv: torch.Tensor) -> torch.Tensor:
    """diff^T cov_inv diff in f32 whatever the operand dtype: diff [..., L],
    cov_inv [..., L, L] (leading axes broadcast) -> [...]."""
    diff = diff.to(ACCUM)
    return torch.einsum("...i,...ij,...j->...", diff, cov_inv.to(ACCUM), diff)

"""MSE scoring and the aggregator election with its quota (port of
fedmse_tpu/federation/voting.py).

  * `make_mse_scores_fn`: every client's model scores ONE shared vote
    tensor (the first selected client's valid split). The reference
    re-standardizes it with its own masked mean/std (ddof=1, + 1e-8),
    forwards it in batches of 128, averages the real batches' masked MSE,
    and multiplies a +-0.01% tie-break. Here the forward is ONE fused
    launch over the N x V rows, each routed to its client's model; the
    per-batch means are torch ops on the [N, V] per-row MSE.
  * `elect_aggregator`: first-voter-wins on the host. A voter ranks the
    other cohort clients by score and votes for the first under the quota;
    each voter call draws fresh scores.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from fedmse_tpu_torch.evaluation.evaluator import client_index
from fedmse_tpu_torch.models.flat import ParamLayout
from fedmse_tpu_torch.ops.fused_ae import fused_forward_stats
from fedmse_tpu_torch.ops.losses import safe_div
from fedmse_tpu_torch.ops.stats import masked_mean_std

VOTE_BATCH = 128


def make_mse_scores_fn(model, restandardize: bool = True,
                       tie_break: bool = True) -> Callable:
    """fn(params [N, P], val_x [V, D], val_m [V], generator) -> scores [N]
    f32 on params' device. `generator` (a CPU torch.Generator) draws the
    tie-breaks; it is not used when tie_break is False."""
    layout = ParamLayout.of(model)
    cdt = model.compute_dtype

    @torch.no_grad()
    def scores_all(params: torch.Tensor, val_x: torch.Tensor,
                   val_m: torch.Tensor,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        n = params.shape[0]
        v, d = val_x.shape
        x = val_x.to(torch.float32)
        if restandardize:
            mean, std = masked_mean_std(x, val_m, ddof=1, eps=1e-8)
            x = (x - mean) / std
        _, mse, _ = fused_forward_stats(
            layout.tree(params, cdt), x.to(cdt).repeat(n, 1),
            client_index(n, v, params.device), compute_dtype=cdt)
        nb = -(-v // VOTE_BATCH)
        pad = nb * VOTE_BATCH - v
        mse = torch.nn.functional.pad(mse.view(n, v), (0, pad))
        mb = torch.nn.functional.pad(val_m, (0, pad)).view(nb, VOTE_BATCH)
        batch = safe_div((mse.view(n, nb, VOTE_BATCH) * mb).sum(dim=2),
                         mb.sum(dim=1))
        has = (mb > 0).any(dim=1)
        real = torch.clamp(has.sum(), min=1).to(torch.float32)
        scores = torch.where(has, batch, 0.0).sum(dim=1) / real
        if tie_break:
            u = torch.rand(n, generator=generator).to(params.device)
            scores = scores * (1.0 + (u - 0.5) * 0.0002)
        return scores

    return scores_all


def elect_aggregator(selected_indices: Sequence[int],
                     score_fn: Callable[[], np.ndarray],
                     aggregation_count: np.ndarray,
                     votes_received: np.ndarray, max_threshold: int = 3
                     ) -> Tuple[Optional[int], Optional[np.ndarray]]:
    """First-voter-wins over the selected cohort. `score_fn()` returns
    fresh [N] scores per voter call. Returns (aggregator or None, the
    winning voter's scores or None)."""
    for voter in selected_indices:
        scores = score_fn()
        candidates = [i for i in selected_indices if i != voter]
        candidates.sort(key=lambda i: scores[i])
        for cand in candidates:
            if aggregation_count[cand] < max_threshold:
                votes_received[cand] += 1
                return cand, scores
        # nobody under quota for this voter; the next voter tries (and
        # fails identically, as in the reference)
    return None, None

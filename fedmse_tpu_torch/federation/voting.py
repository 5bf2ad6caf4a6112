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
    other cohort clients by score (NaN worst) and votes for the first
    under the quota; each voter call draws fresh scores.
  * `elect_on_device`: the same election as device ops, for the fused
    round (federation/fused.py): one scoring launch, each voter's
    tie-break drawn ahead of the round.
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
            scores = tie_break_jitter(
                scores, torch.rand(n, generator=generator).to(params.device))
        return scores

    return scores_all


def tie_break_jitter(scores: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The reference's +-0.01% tie-break: scores * (1 + (u - 0.5) * 2e-4)
    for uniforms u (broadcast: [N] scores by [S, N] draws gives each
    voter's scores)."""
    return scores * (1.0 + (u - 0.5) * 0.0002)


def elect_on_device(base: torch.Tensor, draws: Optional[torch.Tensor],
                    sel: torch.Tensor, sel_mask: torch.Tensor,
                    agg_count: torch.Tensor, max_threshold: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """First-voter-wins over the S selected voters, on the device with no
    host read (port of fedmse_tpu/federation/fused.py `_elect_on_device`).

    base [N]: the vote scores without tie-break (`make_mse_scores_fn` is
    deterministic, so one launch serves every voter); draws [S, N]: voter
    i's tie-break uniforms, or None when the tie-break is off; sel [S]
    int64: the selection in selection order; agg_count [N] int32: the
    quota. Voter i ranks the selected clients but itself that are under
    the quota; NaN ranks worst, and equal scores go to the earliest
    selected. The first voter with a candidate wins. Returns (aggregator
    int64 0-d, -1 when no voter has a candidate; the winning voter's
    scores [N], zeros then)."""
    s, n = sel.shape[0], base.shape[0]
    ids = torch.arange(n, device=base.device)
    scores = (base.expand(s, n) if draws is None
              else tie_break_jitter(base, draws))
    sel_pos = torch.full((n,), s, dtype=torch.int64,
                         device=base.device).index_copy(
        0, sel, torch.arange(s, device=base.device))
    cand = ((sel_mask > 0) & (agg_count < max_threshold))[None, :] \
        & (ids[None, :] != sel[:, None])
    found = cand.any(dim=1)
    masked = torch.where(cand & ~torch.isnan(scores), scores,
                         torch.full_like(scores, float("inf")))
    tie = cand & (masked == masked.min(dim=1, keepdim=True).values)
    pick = torch.where(tie, sel_pos[None, :],
                       torch.full_like(tie, s + 1, dtype=torch.int64)
                       ).argmin(dim=1)
    first = found.to(torch.int32).argmax().view(1)  # a device index
    won = found.any()
    aggregator = torch.where(won, pick.index_select(0, first)[0], -1)
    return aggregator, torch.where(won, scores.index_select(0, first)[0],
                                   torch.zeros_like(base))


def elect_aggregator(selected_indices: Sequence[int],
                     score_fn: Callable[[], np.ndarray],
                     aggregation_count: np.ndarray,
                     votes_received: np.ndarray, max_threshold: int = 3
                     ) -> Tuple[Optional[int], Optional[np.ndarray]]:
    """First-voter-wins over the selected cohort. `score_fn()` returns
    fresh [N] scores per voter call. A NaN score ranks as +inf (worst) and
    equal ranks go to the earliest selected, as in `elect_on_device`.
    Returns (aggregator or None, the winning voter's scores or None)."""
    for voter in selected_indices:
        scores = score_fn()
        candidates = [i for i in selected_indices if i != voter]
        # a stable sort: candidates stay in selection order within a rank
        candidates.sort(key=lambda i: float("inf") if np.isnan(scores[i])
                        else float(scores[i]))
        for cand in candidates:
            if aggregation_count[cand] < max_threshold:
                votes_received[cand] += 1
                return cand, scores
        # nobody under quota for this voter; the next voter tries (and
        # fails identically, as in the reference)
    return None, None

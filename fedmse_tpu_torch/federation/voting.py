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
    tie-break drawn ahead of the round ([S, N]) or, from a `KeyedDraws`
    source, computed for the one voter the election reads (O(N));
    `elect_on_device_runs` runs R federations' elections at once (the
    batched round), O(R (S + N)) alike.
  * `keyed_tie_break`: the size rule. A fused round whose tie-break
    sheet, S voters x N clients x 4 B, exceeds TIE_BREAK_SHEET_BYTES
    holds no sheet: its elections read a KeyedDraws source. The dense
    and meshed rounds apply it at (S, the REAL clients), so padding and
    ranks do not move it; the batched round per run; the tier at
    (S, S).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from fedmse_tpu_torch.evaluation.evaluator import client_index
from fedmse_tpu_torch.models.flat import ParamLayout
from fedmse_tpu_torch.ops.fused_ae import fused_forward_stats
from fedmse_tpu_torch.ops.losses import safe_div
from fedmse_tpu_torch.ops.stats import masked_mean_std
from fedmse_tpu_torch.utils.seeding import keyed_uniform_row, pad_draws

VOTE_BATCH = 128

# the size rule of a fused round's tie-break sheet (module docstring):
# voters x width x 4 B within this keeps the generator's draws; above it
# the elections are keyed. 64 MiB is S = N = 4,096, above every run that
# drew its sheet before the rule
TIE_BREAK_SHEET_BYTES = 64 << 20


def keyed_tie_break(cfg, voters: int, width: int) -> bool:
    """Whether a fused round of `voters` selected clients over `width`
    real clients keys its tie-breaks: the tie-break is on and the [voters,
    width] f32 sheet exceeds TIE_BREAK_SHEET_BYTES."""
    return bool(cfg.compat.vote_tie_break) and \
        4 * voters * width > TIE_BREAK_SHEET_BYTES


class KeyedDraws(NamedTuple):
    """A keyed tie-break source (utils/seeding.keyed_uniform_row): voter
    v's uniforms are a hash of (key, round, v, the lanes' absolute ids),
    computed on the device for the voter an election reads. All three are
    device buffers a captured body reads: key int64 [K] (key_words of the
    stream key), or [R, K] for R runs' keys (the batched round), round
    int64 0-d (the absolute round), ids int64 [N] (-1: a pad lane,
    factor 1)."""

    key: torch.Tensor
    round: torch.Tensor
    ids: torch.Tensor

    def rows(self, voter_pos: torch.Tensor) -> torch.Tensor:
        """The uniforms of the voters at selection positions `voter_pos`
        ([k] int64; [R, k] with R keys, each run's own): [k, N] ([R, k,
        N])."""
        lead = self.key.shape[:-1]
        key = self.key.reshape(lead + (1, 1, self.key.shape[-1]))
        return keyed_uniform_row(key, self.round, voter_pos[..., None],
                                 self.ids)


TieBreak = Union[torch.Tensor, KeyedDraws, None]


def make_mse_scores_fn(model, restandardize: bool = True,
                       tie_break: bool = True) -> Callable:
    """fn(params [N, P], val_x [V, D], val_m [V], generator, fleet=None) ->
    scores [N] f32 on params' device. `generator` (a CPU torch.Generator)
    draws the tie-breaks; it is not used when tie_break is False. `fleet`
    (lo, n_real) makes the draw the REAL fleet's [n_real] uniforms, padded
    with 0.5 (a factor of 1) over the pad clients, and jitters `params`'
    rows as rows [lo, lo + N) of that: a padded axis, or one rank's block
    of a client mesh, draws what the unpadded dense engine draws. Per-run
    vote tensors val_x [R, V, D], val_m [R, V] (the batched round,
    tie_break off) score the N = R x n models run by run: model r n + i
    scores run r's rows, restandardized with run r's own statistics, in
    the same one launch. KitNET's models score with their running
    statistics `stats` [N, 2k] (its per-row statistic in place of the
    MSE)."""
    layout = ParamLayout.of(model)
    cdt = model.compute_dtype

    @torch.no_grad()
    def scores_all(params: torch.Tensor, val_x: torch.Tensor,
                   val_m: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   fleet: Optional[Tuple[int, int]] = None,
                   stats: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = params.shape[0]
        v, d = val_x.shape[-2:]
        per_run = val_x.dim() == 3
        x = val_x.to(torch.float32)
        if restandardize:
            mean, std = masked_mean_std(x, val_m, ddof=1, eps=1e-8)
            x = ((x - mean[:, None]) / std[:, None] if per_run
                 else (x - mean) / std)
        if per_run:  # model r * per + i scores run r's rows
            runs, per = x.shape[0], n // x.shape[0]
            rows = x.to(cdt)[:, None].expand(runs, per, v, d).reshape(-1, d)
        else:
            rows = x.to(cdt).repeat(n, 1)
        _, mse, _ = fused_forward_stats(
            layout.tree(params, cdt, stats=stats), rows,
            client_index(n, v, params.device), compute_dtype=cdt)
        nb = -(-v // VOTE_BATCH)
        pad = nb * VOTE_BATCH - v
        mse = torch.nn.functional.pad(mse.view(n, v), (0, pad))
        mb = torch.nn.functional.pad(val_m, (0, pad))
        if per_run:
            mb = mb.view(runs, 1, nb, VOTE_BATCH).expand(
                runs, per, nb, VOTE_BATCH).reshape(n, nb, VOTE_BATCH)
            batch = safe_div((mse.view(n, nb, VOTE_BATCH) * mb).sum(dim=2),
                             mb.sum(dim=2))
            has = (mb > 0).any(dim=2)
            real = torch.clamp(has.sum(dim=1), min=1).to(torch.float32)
        else:
            mb = mb.view(nb, VOTE_BATCH)
            batch = safe_div((mse.view(n, nb, VOTE_BATCH) * mb).sum(dim=2),
                             mb.sum(dim=1))
            has = (mb > 0).any(dim=1)
            real = torch.clamp(has.sum(), min=1).to(torch.float32)
        scores = torch.where(has, batch, 0.0).sum(dim=1) / real
        if tie_break:
            lo, n_real = (0, n) if fleet is None else fleet
            u = pad_draws(torch.rand(n_real, generator=generator),
                          lo + n)[lo:lo + n]
            scores = tie_break_jitter(scores, u.to(params.device))
        return scores

    return scores_all


def tie_break_jitter(scores: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The reference's +-0.01% tie-break: scores * (1 + (u - 0.5) * 2e-4)
    for uniforms u (broadcast: [N] scores by [S, N] draws gives each
    voter's scores)."""
    return scores * (1.0 + (u - 0.5) * 0.0002)


def elect_on_device(base: torch.Tensor, draws: TieBreak,
                    sel: torch.Tensor, sel_mask: torch.Tensor,
                    agg_count: torch.Tensor, max_threshold: int,
                    voters: Optional[torch.Tensor] = None,
                    cluster_in: Optional[torch.Tensor] = None,
                    vote_ok: Optional[torch.Tensor] = None,
                    adv: Optional[torch.Tensor] = None,
                    lie_votes: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """First-voter-wins over the S selected voters, on the device with no
    host read (port of fedmse_tpu/federation/fused.py `_elect_on_device`).

    base [N]: the vote scores without tie-break (`make_mse_scores_fn` is
    deterministic, so one launch serves every voter); draws [S, N]: voter
    i's tie-break uniforms, or a KeyedDraws that computes only the
    winning voter's row, or None when the tie-break is off; sel [S]
    int64: the selection in selection order; agg_count [N] int32: the
    quota. Voter i ranks the selected clients but itself that are under
    the quota; NaN ranks worst, and equal scores go to the earliest
    selected. The first voter with a candidate wins; `voters` [N] (the
    effective cohort under the fault hooks) also gates the voters: one
    outside it casts no vote and its turn passes. `cluster_in` [N] int64
    (clustered federation) scopes a voter's candidates to its own
    cluster; a voter whose cluster has no eligible candidate passes its
    turn. The red team's inputs (redteam/): `vote_ok` [N] (the min-tenure
    gate) makes an ineligible slot no candidate and passes an ineligible
    voter's turn; with `lie_votes`, a voter that is adversarial (`adv`
    [N] > 0) picks the earliest-selected adversarial candidate in its
    scope when there is one, and the honest pick otherwise. The gate
    comes before the collusion pick, so a gated sybil cannot be elected
    even by an accomplice. Without them the ops are the clean election's.
    Returns (aggregator int64 0-d, -1 when no voter has a candidate; the
    winning voter's scores [N], zeros then)."""
    s, n = sel.shape[0], base.shape[0]
    dev = base.device
    ids = torch.arange(n, device=dev)
    sel_pos = torch.full((n,), s, dtype=torch.int64, device=dev).index_copy(
        0, sel, torch.arange(s, device=dev))
    # eligible candidates [N]; voter i's are those other than itself (and
    # in its cluster). Only the first voter with a candidate picks, so
    # the [S, N] candidate sheet is never formed: a voter has a candidate
    # iff its scope holds more eligible ids than its own, and only the
    # winning voter's row of scores is ranked. O(S + N) memory.
    elig = (sel_mask > 0) & (agg_count < max_threshold)
    if vote_ok is not None:
        elig = elig & (vote_ok > 0)
    own = elig.index_select(0, sel).to(torch.int64)
    if cluster_in is None:
        found = elig.sum() > own
    else:
        # eligible ids per cluster by binary search over their sorted
        # cluster labels (non-eligible ids sort first, as -1)
        keys = torch.where(elig, cluster_in, -1).sort().values
        c = cluster_in.index_select(0, sel)
        found = (torch.searchsorted(keys, c, right=True)
                 - torch.searchsorted(keys, c)) > own
    if voters is not None:
        found = found & (voters.index_select(0, sel) > 0)
    if vote_ok is not None:
        found = found & (vote_ok.index_select(0, sel) > 0)
    first = found.to(torch.int32).argmax().view(1)  # a device index
    won = found.any()
    voter = sel.index_select(0, first)               # [1]
    if draws is None:
        scores = base
    else:
        u = (draws.rows(first) if isinstance(draws, KeyedDraws)
             else draws.index_select(0, first))
        scores = tie_break_jitter(base, u[0])
    cand = elig & (ids != voter)
    if cluster_in is not None:
        cand = cand & (cluster_in == cluster_in.index_select(0, voter))
    masked = torch.where(cand & ~torch.isnan(scores), scores,
                         torch.full_like(scores, float("inf")))
    tie = cand & (masked == masked.min())
    never = torch.full_like(sel_pos, s + 1)
    pick = torch.where(tie, sel_pos, never).argmin()
    if lie_votes and adv is not None:
        acc = cand & (adv > 0)
        acc_pick = torch.where(acc, sel_pos, never).argmin()
        lie = (adv.index_select(0, voter)[0] > 0) & acc.any()
        pick = torch.where(lie, acc_pick, pick)
    aggregator = torch.where(won, pick, -1)
    return aggregator, torch.where(won, scores, torch.zeros_like(base))


def elect_on_device_runs(base: torch.Tensor, draws: TieBreak,
                         sel: torch.Tensor, sel_mask: torch.Tensor,
                         agg_count: torch.Tensor, max_threshold: int,
                         voters: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`elect_on_device` of R independent federations at once (the batched
    round, federation/fused.py BatchedFusedRound): base [R, N], draws
    [R, S, N], a KeyedDraws of R keys, or None, sel [R, S] (each run's own
    client ids), sel_mask, agg_count and voters [R, N]. Run r's election
    is `elect_on_device` of its rows, op for op in exact arithmetic: only
    each run's first voter with a candidate is ranked, so nothing of
    R x S x N is formed (O(R (S + N))). Returns (aggregator [R] int64, -1
    where a run found none; scores [R, N])."""
    runs, s = sel.shape
    n = base.shape[1]
    dev = base.device
    ids = torch.arange(n, device=dev)
    sel_pos = torch.full((runs, n), s, dtype=torch.int64,
                         device=dev).scatter(
        1, sel, torch.arange(s, device=dev).expand(runs, s).contiguous())
    elig = (sel_mask > 0) & (agg_count < max_threshold)  # [R, N]
    # voter i has a candidate iff its run holds more eligible ids than its
    # own
    found = elig.sum(dim=1, keepdim=True) > elig.gather(1, sel).to(
        torch.int64)
    if voters is not None:
        found = found & (voters.gather(1, sel) > 0)
    first = found.to(torch.int32).argmax(dim=1, keepdim=True)  # [R, 1]
    won = found.any(dim=1)
    voter = sel.gather(1, first)                               # [R, 1]
    if draws is None:
        scores = base
    else:
        u = (draws.rows(first) if isinstance(draws, KeyedDraws)
             else draws.gather(1, first[:, :, None].expand(runs, 1, n)))
        scores = tie_break_jitter(base, u[:, 0])
    cand = elig & (ids[None, :] != voter)
    masked = torch.where(cand & ~torch.isnan(scores), scores,
                         torch.full_like(scores, float("inf")))
    tie = cand & (masked == masked.min(dim=1, keepdim=True).values)
    pick = torch.where(tie, sel_pos, torch.full_like(sel_pos, s + 1)
                       ).argmin(dim=1)
    aggregator = torch.where(won, pick, -1)
    return aggregator, torch.where(won[:, None], scores,
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

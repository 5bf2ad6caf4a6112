"""Verification of the broadcast, for every client at once (port of
fedmse_tpu/federation/verification.py; its docstring argues both rules).

Reference rule (hardened=False):
  * every client but the aggregator receives the broadcast;
  * the first broadcast a client ever receives is accepted and its
    performance recorded;
  * after that: delta = sum over leaves of ||hist - agg||_F, performance =
    1 / (1 + MSE(verification rows)); accept iff delta <= threshold and
    the performance did not drop more than performance_threshold;
  * the history takes every broadcast, accepted or not;
  * accepted: load the broadcast, it becomes prev_global, rejected = 0;
    rejected: rejected += 1.
Hardened rule (hardened=True): the delta and the performance bar are taken
against the client's OWN current model; the performance gate applies on
first contact too; the delta gate is waived on first contact, or when the
broadcast improves the client's own performance by recovery_threshold
(within recovery_delta_cap, and within the cumulative recovery_budget of
waived movement when one is set).
The aggregator loads the broadcast unconditionally and keeps its history.

Verification rows are either shared by every client ([V, D], the reference's
last-client valid split or the dev set) or per client ([N, V, D]). The
broadcast is either one model [P] (the single-global merge) or one per
client [N, P] (clustered federation: each client verifies its own
cluster's merge; the Frobenius deltas are taken row by row). All the
performances of one call are ONE fused forward launch: with per-client
broadcasts the N broadcasts, and under the hardened rule the N own models
too, are 2N models each row routed to its own.

A broadcast comes with the merge's running statistics (`agg_stats`,
KitNET's; width 0 for the autoencoders): its performance is measured
under them, a client that loads the broadcast takes them with the params
and one that rejects it keeps its own. The deltas read the params only.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from fedmse_tpu_torch.federation.state import (ClientStates,
                                               tree_select_clients)
from fedmse_tpu_torch.models.flat import ParamLayout
from fedmse_tpu_torch.ops.fused_ae import fused_forward_stats
from fedmse_tpu_torch.ops.losses import safe_div


class VerifyOutcome(NamedTuple):
    states: ClientStates
    accepted: torch.Tensor     # [N] bool (the aggregator reports True)
    perf_change: torch.Tensor  # [N] f32
    param_delta: torch.Tensor  # [N] f32


def frob_delta(layout: ParamLayout, prev: torch.Tensor,
               new: torch.Tensor) -> torch.Tensor:
    """sum over the eight leaves of ||prev - new||_F, per client, in f32:
    prev [N, P], new [P] or [N, P] -> [N]."""
    d = prev.to(torch.float32) - new.to(torch.float32)
    return sum(torch.sqrt(torch.square(d[:, sl]).sum(dim=1))
               for sl in layout.slices())


def make_verify_fn(model, verification_threshold: float = 3.0,
                   performance_threshold: float = 0.002,
                   hardened: bool = False,
                   recovery_threshold: float = 0.1,
                   recovery_delta_cap: Optional[float] = None,
                   recovery_budget: Optional[float] = None) -> Callable:
    """fn(states, agg [P] or [N, P], ver_x [V, D] or [N, V, D], ver_m [V]
    or [N, V], agg_onehot [N], client_mask [N], agg_stats=None) ->
    VerifyOutcome; agg_stats ([Q], or [N, Q] with [N, P] broadcasts) is
    the broadcast's running statistics (None: the model keeps none)."""
    if recovery_delta_cap is None:
        recovery_delta_cap = 10.0 * verification_threshold
    layout = ParamLayout.of(model)
    cdt = model.compute_dtype

    def perfs(models: torch.Tensor, model_of: torch.Tensor,
              x: torch.Tensor, m: torch.Tensor,
              stats: torch.Tensor) -> torch.Tensor:
        """1 / (1 + masked MSE) of each row set x[k] [V, D] (mask m[k])
        under model model_of[k] (with the models' running `stats`), in one
        launch."""
        k, v, d = x.shape
        _, mse, _ = fused_forward_stats(
            layout.tree(models, cdt, stats=stats),
            x.reshape(k * v, d).to(cdt),
            model_of.to(torch.int32)[:, None].repeat(1, v).view(-1),
            compute_dtype=cdt)
        loss = safe_div((mse.view(k, v) * m).sum(dim=1), m.sum(dim=1))
        return 1.0 / (1.0 + loss)

    @torch.no_grad()
    def verify(states: ClientStates, agg: torch.Tensor, ver_x: torch.Tensor,
               ver_m: torch.Tensor, agg_onehot: torch.Tensor,
               client_mask: torch.Tensor,
               agg_stats: Optional[torch.Tensor] = None) -> VerifyOutcome:
        n = states.params.shape[0]
        if agg_stats is None:
            agg_stats = agg.new_zeros(agg.shape[:-1] + (0,))
        dev = agg.device
        shared = ver_x.dim() == 2
        x = ver_x[None] if shared else ver_x
        m = ver_m[None] if shared else ver_m
        is_agg = agg_onehot > 0
        attempted = (client_mask > 0) & ~is_agg
        first = ~states.hist_seen
        if agg.dim() == 2:
            # model i < n: client i's broadcast; n + i: its own model
            ids = torch.arange(n, device=dev)
            xs, ms = x.expand(n, -1, -1), m.expand(n, -1)
            if hardened:
                p = perfs(torch.cat([agg, states.params]),
                          torch.cat([ids, ids + n]),
                          torch.cat([xs, xs]), torch.cat([ms, ms]),
                          torch.cat([agg_stats, states.stats]))
                new_perf, own_perf = p[:n], p[n:]
            else:
                new_perf = perfs(agg, ids, xs, ms, agg_stats)
        elif hardened:
            # agg is model n; each client's own model scores its own rows
            k = x.shape[0]
            models = torch.cat([states.params, agg[None]])
            p = perfs(models,
                      torch.cat([torch.full((k,), n, device=dev),
                                 torch.arange(n, device=dev)]),
                      torch.cat([x, x.expand(n, -1, -1)]),
                      torch.cat([m, m.expand(n, -1)]),
                      torch.cat([states.stats, agg_stats[None]]))
            new_perf = p[:k].expand(n)
            own_perf = p[k:]
        else:
            new_perf = perfs(agg[None], torch.zeros(x.shape[0], device=dev),
                             x, m, agg_stats[None]).expand(n)
        if hardened:
            delta = frob_delta(layout, states.params, agg)
            perf_change = new_perf - own_perf
            perf_ok = perf_change >= -performance_threshold
            recovers = ((perf_change >= recovery_threshold)
                        & (delta <= recovery_delta_cap))
            if recovery_budget is not None:
                recovers = recovers & (states.waived < recovery_budget)
            checks = perf_ok & (first | recovers
                                | (delta <= verification_threshold))
            accepted = attempted & checks
            waived = states.waived + torch.where(
                accepted & recovers & ~first
                & (delta > verification_threshold), delta, 0.0)
        else:
            delta = frob_delta(layout, states.hist_params, agg)
            perf_change = torch.where(first, 0.0, new_perf - states.hist_perf)
            checks = ((delta <= verification_threshold)
                      & (perf_change >= -performance_threshold))
            accepted = attempted & (first | checks)
            waived = states.waived

        load = accepted | is_agg
        rejected = torch.where(
            attempted, torch.where(accepted, 0, states.rejected + 1),
            states.rejected).to(torch.int32)
        out = states.replace(
            params=tree_select_clients(load, agg, states.params),
            prev_global=tree_select_clients(accepted, agg,
                                            states.prev_global),
            hist_params=tree_select_clients(attempted, agg,
                                            states.hist_params),
            hist_perf=torch.where(attempted, new_perf, states.hist_perf),
            hist_seen=states.hist_seen | attempted,
            rejected=rejected, waived=waived,
            stats=tree_select_clients(load, agg_stats, states.stats))
        return VerifyOutcome(out, accepted | is_agg,
                             torch.where(attempted, perf_change, 0.0),
                             torch.where(attempted, delta, 0.0))

    return verify

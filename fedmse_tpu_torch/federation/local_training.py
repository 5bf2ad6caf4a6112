"""Local training of the selected cohort (port of
fedmse_tpu/federation/local_training.py).

The reference's semantics, as the JAX package reproduces them:
  * unshuffled minibatches, one Adam step per batch on the model loss, plus
    mu * sum ||p - p_global||^2 under fedprox;
  * epoch train loss = sum of the real batches' losses / their count;
  * validation after each epoch on the same batching, the prox term
    included; valid loss = sum of real batches' losses / their count;
  * per-client early stop: `patience` epochs without a better valid loss
    stop that client; the first epoch always runs;
  * the FINAL weights enter aggregation (restore_best=False) or the best
    ones (restore_best=True); the Adam state persists across rounds.

The JAX package vmaps one client's epoch while_loop over the client axis.
Here it is a host loop over epochs and batches in which every batch step
is ONE fused train-kernel launch over the whole cohort (ops/fused_train.py)
followed by the stacked Adam update (optim.py) on [S, P]. A per-client
`active` flag plays the vmapped while_loop's frozen lanes: an early-stopped
client keeps its params, state and curve. Validation is one fused forward
launch per epoch over every cohort client's valid rows, and the loop ends
when no client is active: one device-to-host read per epoch, none per
batch.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from fedmse_tpu_torch.evaluation.evaluator import client_index
from fedmse_tpu_torch.federation.optim import AdamState, adam_step
from fedmse_tpu_torch.federation.state import tree_select_clients
from fedmse_tpu_torch.models.flat import ParamLayout
from fedmse_tpu_torch.ops.fused_ae import fused_forward_stats
from fedmse_tpu_torch.ops.fused_train import fused_train_grads
from fedmse_tpu_torch.ops.losses import prox_term, safe_div


class LocalTrainResult(NamedTuple):
    params: torch.Tensor       # final (or best) params [N, P]
    opt_state: AdamState
    best_params: torch.Tensor  # best-valid-loss params [N, P]
    min_valid: torch.Tensor    # [N] best valid loss (NaN: not selected)
    tracking: torch.Tensor     # [N, E, 3] (train loss, valid loss, active)


def make_local_train_all(model, epochs: int, patience: int, fedprox: bool,
                         mu: float, lr: float,
                         restore_best: bool = False) -> Callable:
    """fn(params [N, P], opt_state, prev_global [N, P], sel_mask [N],
    train_xb [N, NB, B, D], train_mb [N, NB, B], valid_xb, valid_mb,
    sel_idx=None) -> LocalTrainResult.

    sel_idx (int64 [S], no duplicates) trains the compact cohort: gather
    its rows, train S clients, scatter back. Without it every client trains
    and the unselected results are masked away (dense). Unselected clients
    keep their params and state; their min_valid and tracking are NaN."""
    layout = ParamLayout.of(model)
    lam = float(getattr(model, "shrink_lambda", 0.0))
    cdt = model.compute_dtype

    def valid_loss(p, prev_global, valid_xb, valid_mb, nvb):
        s, nvb_max, b, d = valid_xb.shape
        _, mse, zn = fused_forward_stats(
            layout.tree(p, cdt), valid_xb.reshape(-1, d),
            client_index(s, nvb_max * b, p.device), compute_dtype=cdt)
        m = valid_mb
        msum = m.sum(dim=2)
        loss = safe_div((mse.view(s, nvb_max, b) * m).sum(dim=2), msum)
        if lam:
            loss = loss + lam * safe_div(
                (zn.view(s, nvb_max, b) * m).sum(dim=2), msum)
        if fedprox:
            loss = loss + mu * prox_term(p, prev_global)[:, None]
        has = (m > 0).any(dim=2)
        return torch.where(has, loss, 0.0).sum(dim=1) / nvb

    def train_cohort(params, opt_state, prev_global, train_xb, train_mb,
                     valid_xb, valid_mb):
        s, nb_max = train_xb.shape[:2]
        dev = params.device
        has_b = (train_mb > 0).any(dim=2)                       # [S, NB]
        nb = torch.clamp(has_b.sum(dim=1), min=1).to(torch.float32)
        nvb = torch.clamp((valid_mb > 0).any(dim=2).sum(dim=1),
                          min=1).to(torch.float32)
        p, opt, best = params, opt_state, params
        min_v = torch.full((s,), float("inf"), device=dev)
        worse = torch.zeros(s, dtype=torch.int32, device=dev)
        tracking = torch.zeros((s, epochs, 3), device=dev)
        for epoch in range(epochs):
            # the first epoch always runs (the scan version's patience=0)
            active = (worse < patience) | (epoch == 0)
            if epoch > 0 and not bool(active.any()):
                break
            loss_sum = torch.zeros(s, device=dev)
            for b in range(nb_max):
                loss, grads = fused_train_grads(
                    p, train_xb[:, b], train_mb[:, b], layout=layout,
                    shrink_lambda=lam, compute_dtype=cdt)
                if fedprox:
                    loss = loss + mu * prox_term(p, prev_global)
                    grads = grads + mu * (2.0 * (p - prev_global))
                # a padded batch is skipped entirely, no Adam time step
                p, opt = adam_step(p, opt, grads, has_b[:, b] & active, lr)
                loss_sum = loss_sum + torch.where(has_b[:, b], loss, 0.0)
            train_loss = loss_sum / nb
            v_loss = valid_loss(p, prev_global, valid_xb, valid_mb, nvb)
            improved = (v_loss < min_v) & active
            min_v = torch.where(improved, v_loss, min_v)
            best = tree_select_clients(improved, p, best)
            worse = torch.where(active, torch.where(improved, 0, worse + 1),
                                worse).to(torch.int32)
            row = torch.stack([train_loss, v_loss, torch.ones_like(v_loss)],
                              dim=1)
            tracking[:, epoch] = torch.where(active[:, None], row,
                                             tracking[:, epoch])
        return LocalTrainResult(p, opt, best, min_v, tracking)

    def train_all(params, opt_state, prev_global, sel_mask, train_xb,
                  train_mb, valid_xb, valid_mb,
                  sel_idx: Optional[torch.Tensor] = None) -> LocalTrainResult:
        n = params.shape[0]
        if sel_idx is not None:
            take = lambda t: t.index_select(0, sel_idx)  # noqa: E731
            res = train_cohort(take(params), opt_state.take(sel_idx),
                               take(prev_global), take(train_xb),
                               take(train_mb), take(valid_xb),
                               take(valid_mb))
            final = res.best_params if restore_best else res.params
            nan = float("nan")
            return LocalTrainResult(
                params.index_copy(0, sel_idx, final),
                opt_state.put(sel_idx, res.opt_state),
                params.index_copy(0, sel_idx, res.best_params),
                torch.full((n,), nan, device=params.device).index_copy(
                    0, sel_idx, res.min_valid),
                torch.full((n,) + res.tracking.shape[1:], nan,
                           device=params.device).index_copy(
                    0, sel_idx, res.tracking))
        res = train_cohort(params, opt_state, prev_global, train_xb,
                           train_mb, valid_xb, valid_mb)
        sel = sel_mask > 0
        final = res.best_params if restore_best else res.params
        nanmask = torch.where(sel, 1.0, float("nan"))
        return LocalTrainResult(
            tree_select_clients(sel, final, params),
            res.opt_state.where(sel, opt_state),
            tree_select_clients(sel, res.best_params, params),
            res.min_valid * nanmask,
            res.tracking * nanmask[:, None, None])

    return train_all

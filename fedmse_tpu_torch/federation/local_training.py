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
Here `LocalTrainer` keeps one cohort's training in static buffers
(`Cohort`) and runs it in three steps that update them in place:

  * `begin` gathers the cohort's rows (its clients' params, Adam state,
    anchors and data, at `Cohort.idx`) and resets the early-stop state;
  * `epoch` runs one epoch: every batch step is ONE fused train-kernel
    launch over the whole cohort (ops/fused_train.py) followed by ONE
    update launch (optim.adam_step_ -> ops/adam_update.py: the FedProx
    term, the stacked in-place Adam update on [S, P] and the loss sum),
    then one fused forward launch validates every cohort client. A
    per-client `active` flag plays the vmapped while_loop's frozen lanes:
    an early-stopped client keeps its params, state and curve. The epoch
    index lives on the device, and the epoch writes `go[e]`: whether any
    client is still active for epoch e + 1. Nothing in it reads the host,
    so a CUDA graph captures it (federation/fused.py);
  * `finish` scatters the results back into new [N, ...] tensors.

Once every client is inactive an epoch changes nothing (Adam is masked
by `has_b & active`, `improved` is false, `tracking` keeps its rows), so
running one more epoch than needed is exact. The per-round call
(`LocalTrainer.__call__`, the per-phase path) reads `go[e - 1]` before
epoch e and stops: one device-to-host read per epoch, none per batch.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from fedmse_tpu_torch.evaluation.evaluator import client_index
from fedmse_tpu_torch.federation.optim import AdamState, adam_step_
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


@dataclasses.dataclass
class Cohort:
    """One cohort's local training state, C clients, updated in place."""

    idx: torch.Tensor       # [C] int64: the cohort's rows of the federation
    p: torch.Tensor         # [C, P] params being trained
    opt: AdamState          # [C] their Adam state
    prev: torch.Tensor      # [C, P] fedprox anchors
    best: torch.Tensor      # [C, P] best-valid-loss params
    train_xb: torch.Tensor  # [C, NB, B, D]
    train_mb: torch.Tensor  # [C, NB, B]
    valid_xb: torch.Tensor
    valid_mb: torch.Tensor
    has_b: torch.Tensor     # [C, NB] bool: real batches
    nb: torch.Tensor        # [C] f32: real train batches (>= 1)
    nvb: torch.Tensor       # [C] f32: real valid batches (>= 1)
    min_v: torch.Tensor     # [C] best valid loss so far
    worse: torch.Tensor     # [C] int32 epochs without improvement
    tracking: torch.Tensor  # [C, E, 3]
    epoch: torch.Tensor     # int64 0-d: the next epoch's index
    go: torch.Tensor        # [E] bool: go[e] = some client active in e + 1


class LocalTrainer:
    """Local training of a cohort (see the module docstring). Called as
    fn(params [N, P], opt_state, prev_global [N, P], sel_mask [N],
    train_xb [N, NB, B, D], train_mb [N, NB, B], valid_xb, valid_mb,
    sel_idx=None) -> LocalTrainResult, it is the per-phase path's round.

    sel_idx (int64 [S], no duplicates) trains the compact cohort: gather
    its rows, train S clients, scatter back. Without it every client trains
    and the unselected results are masked away (dense). Unselected clients
    keep their params and state; their min_valid and tracking are NaN."""

    def __init__(self, model, epochs: int, patience: int, fedprox: bool,
                 mu: float, lr: float, restore_best: bool = False):
        self.layout = ParamLayout.of(model)
        self.lam = float(getattr(model, "shrink_lambda", 0.0))
        self.cdt = model.compute_dtype
        self.epochs, self.patience = epochs, patience
        self.fedprox, self.mu, self.lr = fedprox, mu, lr
        self.restore_best = restore_best
        # the train kernel's CTAs per client (None: its own pick for the
        # cohort; the batched round fixes one run's, ops/fused_train.py)
        self.ctas: Optional[int] = None

    def cohort(self, idx: torch.Tensor, params: torch.Tensor,
               train_xb: torch.Tensor, train_mb: torch.Tensor,
               valid_xb: torch.Tensor, valid_mb: torch.Tensor) -> Cohort:
        """Buffers for the cohort of the rows in `idx` (read at `begin`)."""
        c, dev = idx.shape[0], params.device

        def like(t, dtype=None):
            return torch.empty((c,) + tuple(t.shape[1:]),
                               dtype=dtype or t.dtype, device=dev)

        f32 = torch.float32
        return Cohort(
            idx=idx, p=like(params), opt=AdamState(
                like(params[:, 0], torch.int32), like(params),
                like(params)),
            prev=like(params), best=like(params), train_xb=like(train_xb),
            train_mb=like(train_mb), valid_xb=like(valid_xb),
            valid_mb=like(valid_mb),
            has_b=like(train_mb[:, :, 0], torch.bool),
            nb=like(params[:, 0], f32), nvb=like(params[:, 0], f32),
            min_v=like(params[:, 0], f32),
            worse=like(params[:, 0], torch.int32),
            tracking=torch.empty((c, self.epochs, 3), device=dev),
            epoch=torch.zeros((), dtype=torch.int64, device=dev),
            go=torch.zeros(self.epochs, dtype=torch.bool, device=dev))

    def begin(self, co: Cohort, params, opt_state: AdamState, prev_global,
              train_xb, train_mb, valid_xb, valid_mb) -> None:
        """Gather the cohort's rows and reset its early-stop state."""
        idx = co.idx
        for full, mine in ((params, co.p), (prev_global, co.prev),
                           (train_xb, co.train_xb), (train_mb, co.train_mb),
                           (valid_xb, co.valid_xb), (valid_mb, co.valid_mb),
                           *zip(opt_state, co.opt)):
            torch.index_select(full, 0, idx, out=mine)
        co.has_b.copy_((co.train_mb > 0).any(dim=2))
        co.nb.copy_(torch.clamp(co.has_b.sum(dim=1), min=1))
        co.nvb.copy_(torch.clamp((co.valid_mb > 0).any(dim=2).sum(dim=1),
                                 min=1))
        co.best.copy_(co.p)
        co.min_v.fill_(float("inf"))
        co.worse.zero_()
        co.tracking.zero_()
        co.epoch.zero_()
        co.go.zero_()

    def _valid_loss(self, co: Cohort) -> torch.Tensor:
        s, nvb_max, b, d = co.valid_xb.shape
        lam, p = self.lam, co.p
        _, mse, zn = fused_forward_stats(
            self.layout.tree(p, self.cdt), co.valid_xb.reshape(-1, d),
            client_index(s, nvb_max * b, p.device), compute_dtype=self.cdt)
        m = co.valid_mb
        msum = m.sum(dim=2)
        loss = safe_div((mse.view(s, nvb_max, b) * m).sum(dim=2), msum)
        if lam:
            loss = loss + lam * safe_div(
                (zn.view(s, nvb_max, b) * m).sum(dim=2), msum)
        if self.fedprox:
            loss = loss + self.mu * prox_term(p, co.prev)[:, None]
        has = (m > 0).any(dim=2)
        return torch.where(has, loss, 0.0).sum(dim=1) / co.nvb

    def epoch(self, co: Cohort) -> None:
        """One epoch of every cohort client, in place (no host read)."""
        s, nb_max = co.train_xb.shape[:2]
        p, mu = co.p, self.mu
        # the first epoch always runs (the scan version's patience=0)
        active = (co.worse < self.patience) | (co.epoch == 0)
        loss_sum = torch.zeros(s, device=p.device)
        prev = co.prev if self.fedprox else None
        for b in range(nb_max):
            loss, grads = fused_train_grads(
                p, co.train_xb[:, b], co.train_mb[:, b], layout=self.layout,
                shrink_lambda=self.lam, compute_dtype=self.cdt,
                ctas=self.ctas)
            # the FedProx term, Adam and the loss sum in one update; a
            # padded batch is skipped entirely, no Adam time step
            adam_step_(p, co.opt, grads, co.has_b[:, b], self.lr,
                       active=active, loss=loss, loss_sum=loss_sum,
                       prev=prev, prox_mu=mu)
        train_loss = loss_sum / co.nb
        v_loss = self._valid_loss(co)
        improved = (v_loss < co.min_v) & active
        torch.where(improved, v_loss, co.min_v, out=co.min_v)
        torch.where(improved[:, None], p, co.best, out=co.best)
        torch.where(active, torch.where(improved, 0, co.worse + 1),
                    co.worse, out=co.worse)
        row = torch.stack([train_loss, v_loss, torch.ones_like(v_loss)],
                          dim=1)
        at = torch.arange(self.epochs, device=p.device) == co.epoch
        torch.where(at[None, :, None] & active[:, None, None],
                    row[:, None, :], co.tracking, out=co.tracking)
        torch.where(at, (co.worse < self.patience).any(), co.go, out=co.go)
        co.epoch += 1

    def finish(self, co: Cohort, params, opt_state: AdamState,
               sel_mask: torch.Tensor) -> LocalTrainResult:
        """The cohort's results scattered into the federation's rows:
        selected clients take theirs, the others keep params and state,
        with NaN min_valid and tracking."""
        n, idx = params.shape[0], co.idx
        sel = sel_mask > 0
        nan = float("nan")
        nanmask = torch.where(sel, 1.0, nan)
        final = co.best if self.restore_best else co.p
        rows = sel[:, None]
        return LocalTrainResult(
            torch.where(rows, params.index_copy(0, idx, final), params),
            opt_state.put(idx, co.opt).where(sel, opt_state),
            torch.where(rows, params.index_copy(0, idx, co.best), params),
            torch.full((n,), nan, device=params.device).index_copy(
                0, idx, co.min_v) * nanmask,
            torch.full((n,) + co.tracking.shape[1:], nan,
                       device=params.device).index_copy(
                0, idx, co.tracking) * nanmask[:, None, None])

    def __call__(self, params, opt_state, prev_global, sel_mask, train_xb,
                 train_mb, valid_xb, valid_mb,
                 sel_idx: Optional[torch.Tensor] = None) -> LocalTrainResult:
        idx = (torch.arange(params.shape[0], device=params.device)
               if sel_idx is None else sel_idx.to(params.device).long())
        co = self.cohort(idx, params, train_xb, train_mb, valid_xb,
                         valid_mb)
        self.begin(co, params, opt_state, prev_global, train_xb, train_mb,
                   valid_xb, valid_mb)
        for e in range(self.epochs):
            if e > 0 and not bool(co.go[e - 1]):
                break
            self.epoch(co)
        return self.finish(co, params, opt_state, sel_mask)


def make_local_train_all(model, epochs: int, patience: int, fedprox: bool,
                         mu: float, lr: float,
                         restore_best: bool = False) -> LocalTrainer:
    """The LocalTrainer of these settings (called as train_all, see its
    docstring)."""
    return LocalTrainer(model, epochs, patience, fedprox, mu, lr,
                        restore_best)

"""The federated round: select -> train -> vote -> aggregate -> verify ->
evaluate (port of the per-phase path of fedmse_tpu/federation/rounds.py,
`RoundEngine.run_round`, which keeps the reference's control flow).

Per round:
  1. ceil(ratio N) clients from the host selection stream;
  2. local training of the cohort: one fused train-kernel launch per batch
     step, one fused forward launch per epoch (local_training.py);
  3. first-voter-wins election under the quota: one forward launch per
     voter call (voting.py);
  4. the aggregator merges the cohort (one forward launch for mse_avg);
  5. every client but the aggregator verifies the broadcast (one forward
     launch);
  6. every client is evaluated (one forward launch).
The JAX package's single-dispatch fused round, meshes, attacks, chaos,
elastic membership, clustering and red-team hooks are not ported.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from fedmse_tpu_torch.config import ExperimentConfig
from fedmse_tpu_torch.data.stacking import FederatedData
from fedmse_tpu_torch.evaluation.evaluator import make_evaluate_all
from fedmse_tpu_torch.federation.aggregation import make_aggregate_fn
from fedmse_tpu_torch.federation.local_training import make_local_train_all
from fedmse_tpu_torch.federation.state import (ClientStates, HostState,
                                               init_client_states)
from fedmse_tpu_torch.federation.verification import make_verify_fn
from fedmse_tpu_torch.federation.voting import (elect_aggregator,
                                                make_mse_scores_fn)
from fedmse_tpu_torch.models.flat import ParamLayout
from fedmse_tpu_torch.utils.seeding import ExperimentRngs

logger = logging.getLogger(__name__)

PHASES = ("train", "vote", "aggregate", "verify", "evaluate")


@dataclasses.dataclass
class RoundResult:
    round_index: int
    selected: List[int]
    aggregator: Optional[int]
    client_metrics: np.ndarray           # [n_real] (f1 for 'classification')
    verification_results: List[Dict]     # the reference's verification rows
    mse_scores: Optional[np.ndarray]     # the winning voter's scores
    agg_weights: Optional[np.ndarray]    # aggregation weights [N]
    tracking: np.ndarray                 # [n_real, E, 3] loss curves
    min_valid: np.ndarray                # [n_real] best local valid loss
    metrics_full: Optional[np.ndarray] = None  # [n_real, 3] f1/prec/recall
    # host seconds of each phase, with the device synchronized at each
    # phase's end (RoundEngine(profile=True) only)
    phase_seconds: Optional[Dict[str, float]] = None


def split_metric_columns(metrics: np.ndarray):
    """(client_metrics [n], metrics_full) from an evaluator output that is
    [n] or the [n, 3] f1/precision/recall of metric='classification'."""
    if metrics.ndim == 2:
        return metrics[:, 0], metrics
    return metrics, None


def verification_tensors(cfg: ExperimentConfig, data: FederatedData,
                         n_real: int):
    """The verification rows: [V, D] / [V] when every client shares them
    (verification_method='dev', or the reference's quirk 6: the LAST real
    client's valid split), else each client's own valid split [N, V, D]."""
    if cfg.verification_method == "dev":
        return data.dev_x, torch.ones(data.dev_x.shape[0],
                                      device=data.dev_x.device)
    if cfg.compat.shared_last_client_val:
        return data.valid_x[n_real - 1], data.valid_m[n_real - 1]
    return data.valid_x, data.valid_m


class RoundEngine:
    """One (model_type, update_type) federation over stacked client state.

    `states` (e.g. client_states_from_numpy of the JAX package's init)
    replaces the port's own init; reset_federation restores it."""

    def __init__(self, model, cfg: ExperimentConfig, data: FederatedData,
                 n_real: int, rngs: ExperimentRngs, model_type: str,
                 update_type: str, states: Optional[ClientStates] = None,
                 profile: bool = False):
        self.model = model
        self.cfg = cfg
        self.data = data
        self.n_real = n_real
        self.n_pad = data.client_mask.shape[0]
        self.rngs = rngs
        self.model_type = model_type
        self.update_type = update_type
        self.profile = profile
        self.device = data.train_xb.device
        self.layout = ParamLayout.of(model)
        self.compact = cfg.compact_cohort is not False
        self.train_all = make_local_train_all(
            model, epochs=cfg.epochs, patience=cfg.patience,
            fedprox=(update_type == "fedprox"), mu=cfg.fedprox_mu,
            lr=cfg.lr_rate, restore_best=not cfg.compat.no_best_restore)
        self.scores_fn = make_mse_scores_fn(
            model, restandardize=cfg.compat.restandardize_vote_data,
            tie_break=cfg.compat.vote_tie_break)
        self.aggregate = make_aggregate_fn(model, update_type)
        self.verify = make_verify_fn(
            model, cfg.verification_threshold, cfg.performance_threshold,
            hardened=cfg.hardened_verification,
            recovery_budget=cfg.recovery_budget)
        self.evaluate_all = make_evaluate_all(
            model, model_type, cfg.metric, score_kind=cfg.score_kind,
            knn_bank_size=cfg.knn_bank_size, knn_k=cfg.knn_k,
            knn_topk=cfg.knn_topk)
        self._init_states = None if states is None else states.clone()
        self.states = self._fresh_states()
        self.host = HostState.create(n_real)
        self._ver_x, self._ver_m = verification_tensors(cfg, data, n_real)

    def _fresh_states(self) -> ClientStates:
        if self._init_states is not None:
            return self._init_states.clone()
        return init_client_states(self.model, self.n_pad,
                                  self.rngs.generator, device=self.device)

    def reset_federation(self) -> None:
        """Restart from construction state: fresh random streams, the
        initial client states and host counters."""
        self.rngs = ExperimentRngs(run=self.rngs.run,
                                   data_seed=self.rngs.data_seed,
                                   run_seed_stride=self.rngs.run_seed_stride)
        self.states = self._fresh_states()
        self.host = HostState.create(self.n_real)

    def select_clients(self) -> List[int]:
        """max(1, int(ratio N)) clients from the host stream."""
        n_sel = max(1, int(self.cfg.num_participants * self.n_real))
        return self.rngs.select_rng.sample(range(self.n_real), n_sel)

    def evaluate(self) -> np.ndarray:
        """The evaluator's output for every real client, as numpy."""
        d = self.data
        out = self.evaluate_all(self.model_params(), d.test_x, d.test_m,
                                d.test_y, d.train_xb, d.train_mb)
        return out.cpu().numpy()[: self.n_real]

    def model_params(self):
        """The clients' params as the stacked flax-layout tree."""
        return self.layout.tree(self.states.params)

    def run_round(self, round_index: int,
                  selected: Optional[List[int]] = None) -> RoundResult:
        cfg, data, dev = self.cfg, self.data, self.device
        if selected is None:
            selected = self.select_clients()
        seconds: Dict[str, float] = {}
        clock = [time.perf_counter()]

        def lap(phase: str) -> None:
            if self.profile:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                now = time.perf_counter()
                seconds[phase] = seconds.get(phase, 0.0) + now - clock[0]
                clock[0] = now

        sel_mask = torch.zeros(self.n_pad, device=dev)
        sel_mask[selected] = 1.0
        sel_idx = (torch.tensor(sorted(selected), dtype=torch.long,
                                device=dev) if self.compact else None)
        res = self.train_all(self.states.params, self.states.opt_state,
                             self.states.prev_global, sel_mask, data.train_xb,
                             data.train_mb, data.valid_xb, data.valid_mb,
                             sel_idx=sel_idx)
        self.states = self.states.replace(params=res.params,
                                          opt_state=res.opt_state)
        lap("train")

        # the first selected client's valid split is the vote tensor
        vote_x, vote_m = data.valid_x[selected[0]], data.valid_m[selected[0]]

        def fresh_scores() -> np.ndarray:
            return self.scores_fn(self.states.params, vote_x, vote_m,
                                  self.rngs.generator).cpu().numpy()

        aggregator, scores = elect_aggregator(
            selected, fresh_scores, self.host.aggregation_count,
            self.host.votes_received, cfg.max_aggregation_threshold)
        lap("vote")

        verification_rows: List[Dict] = []
        agg_weights = None
        if aggregator is not None and self.host.aggregation_count[
                aggregator] < cfg.max_aggregation_threshold:
            merged, weights = self.aggregate(self.states.params, sel_mask,
                                             data.dev_x, sel_idx=sel_idx)
            agg_weights = weights.cpu().numpy()
            self.host.aggregation_count[aggregator] += 1
            self.host.rounds_aggregated.append((round_index, aggregator))
            lap("aggregate")
            onehot = torch.zeros(self.n_pad, device=dev)
            onehot[aggregator] = 1.0
            outcome = self.verify(self.states, merged, self._ver_x,
                                  self._ver_m, onehot, data.client_mask)
            self.states = outcome.states
            rejected = self.states.rejected.cpu().numpy()
            lap("verify")
            for i in range(self.n_real):
                if i != aggregator:
                    # the reference's rows: is_verified is rejected == 0,
                    # not this round's accept bit
                    verification_rows.append({
                        "client_id": i,
                        "rejected_updates": int(rejected[i]),
                        "is_verified": bool(rejected[i] == 0)})
                    if rejected[i] >= cfg.max_rejected_updates:
                        logger.error("[Client %d] Too many rejected updates."
                                     " Possible attack detected.", i)
        else:
            logger.warning("No aggregator selected for round %d",
                           round_index)

        metrics, metrics_full = split_metric_columns(self.evaluate())
        lap("evaluate")
        return RoundResult(
            round_index=round_index, selected=list(selected),
            aggregator=aggregator, client_metrics=metrics,
            metrics_full=metrics_full,
            verification_results=verification_rows,
            mse_scores=(None if scores is None
                        else np.asarray(scores)[: self.n_real]),
            agg_weights=agg_weights,
            tracking=res.tracking.cpu().numpy()[: self.n_real],
            min_valid=res.min_valid.cpu().numpy()[: self.n_real],
            phase_seconds=seconds if self.profile else None)

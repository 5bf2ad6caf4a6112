"""The federated round: select -> train -> vote -> aggregate -> verify ->
evaluate (port of fedmse_tpu/federation/rounds.py `RoundEngine`).

Two paths run the same round, as in the JAX package:

  * the fused path (`fused=True`, the driver's default,
    federation/fused.py): the round as three bodies with no host read
    inside, replayed as CUDA graphs on the card; `run_round_fused` runs
    one round, `dispatch_schedule_chunk` / `harvest_schedule_chunk` a
    chunk of rounds (federation/pipeline.py overlaps the two);
  * the per-phase path (`run_round`, and every round under
    `profile=True`, which times the phases and so forces it), the
    reference's control flow with the host between the phases:
    1. max(1, int(ratio N)) clients from the host selection stream;
    2. local training of the cohort: one fused train-kernel launch per
       batch step, one fused forward launch per epoch (local_training.py);
    3. first-voter-wins election under the quota: one forward launch per
       voter call (voting.py);
    4. the aggregator merges the cohort (one forward launch for mse_avg);
    5. every client but the aggregator verifies the broadcast (one forward
       launch);
    6. every client is evaluated (one forward launch).
Meshes, attacks, chaos, elastic membership, clustering and the red-team
hooks are not ported.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from fedmse_tpu_torch.config import ExperimentConfig
from fedmse_tpu_torch.data.stacking import FederatedData
from fedmse_tpu_torch.evaluation.evaluator import make_evaluate_all
from fedmse_tpu_torch.federation.aggregation import make_aggregate_fn
from fedmse_tpu_torch.federation.fused import FusedRound, FusedRoundOut
from fedmse_tpu_torch.federation.local_training import make_local_train_all
from fedmse_tpu_torch.federation.pipeline import InFlightChunk
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


def verification_rows(rejected: np.ndarray, aggregator: int, n_real: int,
                      max_rejected_updates: int) -> List[Dict]:
    """The reference's verification rows of every real client but the
    aggregator (is_verified is rejected == 0, not this round's accept
    bit), logging each client at the rejection limit."""
    rows: List[Dict] = []
    for i in range(n_real):
        if i != aggregator:
            rows.append({"client_id": i,
                         "rejected_updates": int(rejected[i]),
                         "is_verified": bool(rejected[i] == 0)})
            if rejected[i] >= max_rejected_updates:
                logger.error("[Client %d] Too many rejected updates."
                             " Possible attack detected.", i)
    return rows


def absorb_fused_out(out: FusedRoundOut, round_index: int,
                     selected: Sequence[int], n_real: int, host: HostState,
                     max_rejected_updates: int) -> RoundResult:
    """Host bookkeeping and the RoundResult of one fused round's outputs:
    the quota and vote counters, the reference's verification rows and
    the attack flagging (port of fedmse_tpu/federation/rounds.py
    `absorb_fused_out`)."""
    aggregator = out.aggregator
    rows: List[Dict] = []
    if aggregator >= 0:
        host.aggregation_count[aggregator] += 1
        host.votes_received[aggregator] += 1
        host.rounds_aggregated.append((round_index, aggregator))
        rows = verification_rows(out.rejected, aggregator, n_real,
                                 max_rejected_updates)
    else:
        logger.warning("No aggregator selected for round %d", round_index)
    metrics, metrics_full = split_metric_columns(out.metrics[:n_real])
    return RoundResult(
        round_index=round_index, selected=list(selected),
        aggregator=None if aggregator < 0 else aggregator,
        client_metrics=metrics, metrics_full=metrics_full,
        verification_results=rows,
        mse_scores=None if aggregator < 0 else out.scores[:n_real],
        agg_weights=None if aggregator < 0 else out.weights,
        tracking=out.tracking[:n_real], min_valid=out.min_valid[:n_real])


class RoundEngine:
    """One (model_type, update_type) federation over stacked client state.

    `states` (e.g. client_states_from_numpy of the JAX package's init)
    replaces the port's own init; reset_federation restores it.
    `fused=True` runs `run_round` through the fused round
    (federation/fused.py), unless `profile=True`, which times the phases
    and so runs the per-phase path. The fused round updates the tensors of
    `states` in place; clone them to keep a copy (the JAX package donates
    them)."""

    def __init__(self, model, cfg: ExperimentConfig, data: FederatedData,
                 n_real: int, rngs: ExperimentRngs, model_type: str,
                 update_type: str, states: Optional[ClientStates] = None,
                 profile: bool = False, fused: bool = False):
        if fused and cfg.metric == "time":
            raise ValueError(
                "metric='time' times each client's scoring on the host and "
                "cannot run inside the fused round; use fused=False")
        self.model = model
        self.cfg = cfg
        self.data = data
        self.n_real = n_real
        self.n_pad = data.client_mask.shape[0]
        self.rngs = rngs
        self.model_type = model_type
        self.update_type = update_type
        self.profile = profile
        self.fused = fused
        if fused and profile:
            logger.warning("profile=True forces the per-phase round path; "
                           "a fused round is not phase-attributable")
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
        self._fused: Optional[FusedRound] = None

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

    def cohort_size(self) -> int:
        """max(1, int(ratio N)): the clients a round selects."""
        return max(1, int(self.cfg.num_participants * self.n_real))

    def select_clients(self) -> List[int]:
        """cohort_size() clients from the host stream."""
        return self.rngs.select_rng.sample(range(self.n_real),
                                           self.cohort_size())

    def evaluate(self) -> np.ndarray:
        """The evaluator's output for every real client, as numpy."""
        d = self.data
        out = self.evaluate_all(self.model_params(), d.test_x, d.test_m,
                                d.test_y, d.train_xb, d.train_mb)
        return out.cpu().numpy()[: self.n_real]

    def model_params(self):
        """The clients' params as the stacked flax-layout tree."""
        return self.layout.tree(self.states.params)

    # ---- the fused path (federation/fused.py) ---- #

    def fused_round(self, n_rounds: int = 1, cohort: Optional[int] = None
                    ) -> FusedRound:
        """The engine's fused round, built (and on the card captured at its
        first rounds) once for a cohort size and chunks of up to
        max(n_rounds, fused_schedule_chunk) rounds; rebuilt only when a
        call needs another size or more rounds."""
        cohort = self.cohort_size() if cohort is None else cohort
        f = self._fused
        if f is None or f.cohort_size != cohort or f.capacity < n_rounds:
            cfg, d = self.cfg, self.data
            rows = d.train_xb.shape[1] * d.train_xb.shape[2]
            metric_shape = {"AUC": (), "classification": (3,)}.get(
                cfg.metric, (d.test_x.shape[1],))
            f = FusedRound(
                trainer=self.train_all,
                base_scores=make_mse_scores_fn(
                    self.model,
                    restandardize=cfg.compat.restandardize_vote_data,
                    tie_break=False),
                aggregate=self.aggregate, verify=self.verify,
                evaluate_all=self.evaluate_all, layout=self.layout,
                states=self.states.clone(), data=d, ver_x=self._ver_x,
                ver_m=self._ver_m,
                priorities=self.evaluate_all.bank_priorities(
                    self.n_pad, rows, self.device),
                max_threshold=cfg.max_aggregation_threshold, cohort=cohort,
                capacity=max(n_rounds, cfg.fused_schedule_chunk, 1),
                compact=self.compact, tie_break=cfg.compat.vote_tie_break,
                metric_shape=metric_shape)
            self._fused = f
            self.states = f.states
        elif self.states is not f.states:
            # reassigned since the last round (a rewind, a reset): the
            # captured round reads only its own buffers
            f.states.copy_(self.states)
            self.states = f.states
        return f

    def _host_agg_count(self) -> np.ndarray:
        return np.pad(self.host.aggregation_count,
                      (0, self.n_pad - self.n_real))

    def dispatch_schedule_chunk(self, start_round: int, n_rounds: int,
                                agg_count=None, snapshot: bool = False,
                                schedule: Optional[List[List[int]]] = None,
                                draws: Optional[torch.Tensor] = None
                                ) -> InFlightChunk:
        """Enqueue n_rounds fused rounds and return before their outputs
        are read (federation/pipeline.py). Selections and tie-break draws
        come from the host streams, in the order of n_rounds successive
        run_round_fused calls, unless `schedule` / `draws` replay recorded
        ones. `agg_count` is a previous chunk's device quota
        (InFlightChunk.agg_count) to carry on; None uploads the host's.
        `snapshot=True` keeps a device copy of the chunk-entry states for
        an early stop's rewind.

        On the card the call returns once the last round's final epoch is
        enqueued: the host reads each epoch's early-stop flag one epoch
        behind the card (federation/fused.py)."""
        if schedule is None:
            schedule = [self.select_clients() for _ in range(n_rounds)]
        f = self.fused_round(n_rounds, len(schedule[0]))
        if draws is None and self.cfg.compat.vote_tie_break:
            draws = self.rngs.vote_draws(n_rounds, f.cohort_size, self.n_pad)
        snap = self.states.clone() if snapshot else None
        t0 = time.time()
        harvest = f.dispatch(
            schedule, draws,
            None if agg_count is f.agg_count else self._host_agg_count())
        return InFlightChunk(start_round=start_round, n_rounds=n_rounds,
                             schedule=schedule, draws=draws,
                             agg_count=f.agg_count, harvest=harvest,
                             t_dispatch=t0, snap_states=snap)

    def harvest_schedule_chunk(self, chunk: InFlightChunk):
        """Wait for a dispatched chunk's outputs and absorb them into the
        host counters: (results, schedule, draws)."""
        results = [absorb_fused_out(out, chunk.start_round + r,
                                    chunk.schedule[r], self.n_real,
                                    self.host,
                                    self.cfg.max_rejected_updates)
                   for r, out in enumerate(chunk.harvest())]
        return results, chunk.schedule, chunk.draws

    def run_schedule_chunk(self, start_round: int, n_rounds: int):
        """n_rounds fused rounds, dispatched and harvested: (results,
        schedule, draws), the inputs a rewind replays."""
        return self.harvest_schedule_chunk(
            self.dispatch_schedule_chunk(start_round, n_rounds))

    def run_rounds(self, start_round: int, n_rounds: int
                   ) -> List[RoundResult]:
        """n_rounds fused rounds in one chunk (no early stopping)."""
        return self.run_schedule_chunk(start_round, n_rounds)[0]

    def run_round_fused(self, round_index: int,
                        selected: Optional[List[int]] = None,
                        draws: Optional[torch.Tensor] = None
                        ) -> RoundResult:
        """One fused round. `selected` / `draws` ([S, N]) override the host
        streams: the driver replays a chunk's prefix with them."""
        chunk = self.dispatch_schedule_chunk(
            round_index, 1,
            schedule=None if selected is None else [list(selected)],
            draws=None if draws is None else draws[None])
        return self.harvest_schedule_chunk(chunk)[0][0]

    # ---- the per-phase path ---- #

    def run_round(self, round_index: int,
                  selected: Optional[List[int]] = None) -> RoundResult:
        if self.fused and not self.profile:
            return self.run_round_fused(round_index, selected)
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

        rows: List[Dict] = []
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
            rows = verification_rows(rejected, aggregator, self.n_real,
                                     cfg.max_rejected_updates)
        else:
            logger.warning("No aggregator selected for round %d",
                           round_index)

        metrics, metrics_full = split_metric_columns(self.evaluate())
        lap("evaluate")
        return RoundResult(
            round_index=round_index, selected=list(selected),
            aggregator=aggregator, client_metrics=metrics,
            metrics_full=metrics_full,
            verification_results=rows,
            mse_scores=(None if scores is None
                        else np.asarray(scores)[: self.n_real]),
            agg_weights=agg_weights,
            tracking=res.tracking.cpu().numpy()[: self.n_real],
            min_valid=res.min_valid.cpu().numpy()[: self.n_real],
            phase_seconds=seconds if self.profile else None)

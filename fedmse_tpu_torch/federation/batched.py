"""Batched runs: the R seeds of one (model_type, update_type) combination as
one federation of R·N clients (port of fedmse_tpu/federation/batched.py;
the driver's `--batch-runs`).

The sequential driver runs a combination's `num_runs` seeds one after
another. `BatchedRunEngine` stacks the R federations run by run on the
client axis ([R·N, P] states, the data tiled R times) and advances all of
them in one set of captured bodies (fused.BatchedFusedRound): each step is
one train-kernel launch at G = R·S and each scoring one forward launch
over the R·N routed models, where R runs cost R times the launches
sequentially.

Each run stays the sequential driver's run r:
  * its own streams (utils/seeding.make_run_rngs): selections from run r's
    `select_rng` in round order, tie-break draws from its `generator` a
    chunk at a time (above the size rule, voting.keyed_tie_break, applied
    per run at (S, n_real) as run r alone applies it: none drawn, each
    election computing its voter's row from run r's keys), init from its
    generator
    (state.init_batched_client_states), and its chaos, elastic and attack
    streams from its own keys;
  * its own states, verification history, rejected counters, quota and
    election; the train kernel runs one run's CTAs per client, and each
    run is merged on its own rows;
  * global early stopping per run, decided on the host from the chunk's
    outputs and carried into the round as a per-round [k, R] `active`
    mask: a stopped run's lane still launches but its states and quota
    stay frozen. A stop before a chunk's last round rewinds to the
    chunk's entry snapshot and replays it with the freeze matrix and the
    entry quota (pipeline.run_pipelined_batched).

On the CPU the batched runs are the sequential runs bit for bit
(tests/test_torch_batched.py). On the card a reduction's summation order
depends on how many rows it reduces, so a batched run can differ from the
run alone in the last bits (PERF.md).

`metric='time'` is the host's clock and cannot run inside the round; the
engine refuses it, as the JAX package's does. Clustering and the red team
run sequentially (the driver falls back).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from fedmse_tpu_torch.chaos.masks import (ChaosMasks,
                                          make_batched_chaos_masks,
                                          reelection_draws)
from fedmse_tpu_torch.config import ExperimentConfig
from fedmse_tpu_torch.data.stacking import FederatedData
from fedmse_tpu_torch.evaluation.evaluator import make_evaluate_all
from fedmse_tpu_torch.federation.aggregation import make_runs_aggregate_fn
from fedmse_tpu_torch.federation.attack import noise_draws
from fedmse_tpu_torch.federation.elastic import (
    MembershipMasks, make_batched_membership_masks, membership_at)
from fedmse_tpu_torch.federation.fused import BatchedFusedRound
from fedmse_tpu_torch.federation.local_training import make_local_train_all
from fedmse_tpu_torch.federation.pipeline import InFlightChunk
from fedmse_tpu_torch.federation.rounds import (RoundResult,
                                                absorb_fused_out, lane_ids,
                                                verification_tensors)
from fedmse_tpu_torch.federation.state import (ClientStates, HostState,
                                               init_batched_client_states)
from fedmse_tpu_torch.federation.verification import make_verify_fn
from fedmse_tpu_torch.federation.voting import (keyed_tie_break,
                                                make_mse_scores_fn)
from fedmse_tpu_torch.models.flat import ParamLayout
from fedmse_tpu_torch.ops.fused_train import cluster_size
from fedmse_tpu_torch.utils.seeding import make_run_rngs


def tile_federated_data(data: FederatedData, runs: int) -> FederatedData:
    """The federation repeated R times on the client axis (run r's client i
    at row r N + i); the dev set has no client axis and is kept."""
    def tile(t: torch.Tensor) -> torch.Tensor:
        return t.repeat((runs,) + (1,) * (t.dim() - 1))
    return FederatedData(**{
        f.name: (getattr(data, f.name) if f.name == "dev_x"
                 else tile(getattr(data, f.name)))
        for f in dataclasses.fields(FederatedData)})


class BatchedRunEngine:
    """R seeds of one (model_type, update_type) federation (module
    docstring). `run_schedule_chunk` advances every active run by k rounds
    and returns the raw per-(round, run) outputs; `process_round` turns
    one (round, run) into the RoundResult and host bookkeeping of the
    sequential engine. The split lets the driver decide each run's stop
    before the host counters take in rounds after it.

    `states` ([R·N, ...], e.g. the JAX package's R inits) replaces the
    runs' own init; `elastic_masks` (MembershipMasks with [T, R, N]
    leaves) replaces the drawn timelines."""

    def __init__(self, model, cfg: ExperimentConfig, data: FederatedData,
                 n_real: int, runs: int, model_type: str, update_type: str,
                 poison_fn=None, chaos=None, elastic=None,
                 states: Optional[ClientStates] = None,
                 elastic_masks: Optional[MembershipMasks] = None):
        if cfg.metric == "time":
            raise ValueError(
                "metric='time' is host-side wall-clock and cannot be traced "
                "into the batched-runs program; use sequential mode")
        if cfg.state_layout != "dense":
            raise ValueError("batched runs are dense-layout only "
                             f"(state_layout={cfg.state_layout!r})")
        if elastic_masks is not None and elastic is None:
            raise ValueError("elastic_masks needs an ElasticSpec")
        self.model, self.cfg = model, cfg
        self.data, self.n_real, self.runs = data, n_real, runs
        self.n_pad = data.client_mask.shape[0]
        self.model_type, self.update_type = model_type, update_type
        self.poison_fn, self.chaos, self.elastic = poison_fn, chaos, elastic
        self.device = data.train_xb.device
        self.layout = ParamLayout.of(model)
        self.compact = cfg.compact_cohort is not False
        self.tiled = tile_federated_data(data, runs)
        self.train_all = make_local_train_all(
            model, epochs=cfg.epochs, patience=cfg.patience,
            fedprox=(update_type == "fedprox"), mu=cfg.fedprox_mu,
            lr=cfg.lr_rate, restore_best=not cfg.compat.no_best_restore)
        # one run's CTAs per client: each client sums as in the run alone
        self.train_all.ctas = cluster_size(
            self.cohort_size() if self.compact else self.n_pad,
            self.layout.hidden)
        self.evaluate_all = make_evaluate_all(
            model, model_type, cfg.metric, score_kind=cfg.score_kind,
            knn_bank_size=cfg.knn_bank_size, knn_k=cfg.knn_k,
            knn_topk=cfg.knn_topk)
        self._ver_x, self._ver_m = verification_tensors(cfg, self.tiled,
                                                        n_real)
        # a kNN score's bank draws: run r's client i draws client i's
        rows = data.train_xb.shape[1] * data.train_xb.shape[2]
        prio = self.evaluate_all.bank_priorities(self.n_pad, rows,
                                                 self.device)
        self._priorities = None if prio is None else prio.repeat(
            (runs,) + (1,) * (prio.dim() - 1))
        self._fused: Optional[BatchedFusedRound] = None
        self._init_states = None if states is None else states.clone()
        self._elastic_override = elastic_masks
        self.reset_federation()

    def reset_federation(self) -> None:
        """Fresh streams, initial states and host counters for every
        run."""
        cfg = self.cfg
        self.rngs = make_run_rngs(self.runs, data_seed=cfg.data_seed,
                                  run_seed_stride=cfg.run_seed_stride)
        self.states = (self._init_states.clone()
                       if self._init_states is not None else
                       init_batched_client_states(
                           self.model, [r.generator for r in self.rngs],
                           self.n_real, n_pad=self.n_pad,
                           pad_keys=[r.init_pad_key() for r in self.rngs],
                           device=self.device))
        self.host = [HostState.create(self.n_real)
                     for _ in range(self.runs)]
        self._chaos_premade: Optional[ChaosMasks] = None
        self._reelect_premade: Optional[np.ndarray] = None
        self._elastic_premade = self._elastic_override

    def cohort_size(self) -> int:
        return max(1, int(self.cfg.num_participants * self.n_real))

    @property
    def keyed_tie_break(self) -> bool:
        """Whether the runs' rounds key their tie-breaks: the size rule
        per run, at (S, n_real), never at R x S x N."""
        return keyed_tie_break(self.cfg, self.cohort_size(), self.n_real)

    def select_clients(self, run: int) -> List[int]:
        """Run r's selection from its own host stream."""
        return self.rngs[run].select_rng.sample(range(self.n_real),
                                                self.cohort_size())

    def host_agg_count(self) -> np.ndarray:
        """[R, N] int32: the host counters' quota, padded."""
        return np.stack([np.pad(h.aggregation_count,
                                (0, self.n_pad - self.n_real))
                         for h in self.host]).astype(np.int32)

    # ---- the hooks' per-round inputs, each run from its own streams ---- #

    def _horizon(self, end: int) -> int:
        return max(end, self.cfg.num_rounds)

    def _chaos_masks(self, start_round: int, k: int) -> ChaosMasks:
        """[k, R, ...] fault masks, sliced from the whole horizon's."""
        end = start_round + k
        if self._chaos_premade is None \
                or end > self._chaos_premade.crash.shape[0]:
            self._chaos_premade = make_batched_chaos_masks(
                self.chaos, [r.chaos_key() for r in self.rngs], 0,
                self._horizon(end), self.n_pad)
        return ChaosMasks(*(m[start_round:end]
                            for m in self._chaos_premade))

    def _reelect_draws(self, start_round: int, k: int) -> np.ndarray:
        """[k, R, S, N] crash re-election draws."""
        end, cached = start_round + k, self._reelect_premade
        if cached is None or end > cached.shape[0]:
            self._reelect_premade = np.stack([
                reelection_draws(r.chaos_key(), 0, self._horizon(end),
                                 self.cohort_size(), self.n_pad)
                for r in self.rngs], axis=1)
        return self._reelect_premade[start_round:end]

    def _elastic_masks(self, start_round: int, k: int) -> MembershipMasks:
        """[k, R, N] membership masks, sliced from the timelines expanded
        from round 0."""
        end = start_round + k
        if self._elastic_premade is None \
                or end > self._elastic_premade.member.shape[0]:
            if self._elastic_override is not None:
                raise ValueError(
                    f"elastic_masks override covers "
                    f"{self._elastic_override.member.shape[0]} rounds but "
                    f"the schedule needs {end}")
            self._elastic_premade = make_batched_membership_masks(
                self.elastic, [r.elastic_key() for r in self.rngs],
                self._horizon(end), self.n_pad)
        return MembershipMasks(*(m[start_round:end]
                                 for m in self._elastic_premade))

    def _attack_inputs(self, start_round: int, k: int) -> dict:
        """The attack bit [k] and, for a noise attack, each run's noise
        [k, R, P]."""
        out = {"attack": self.poison_fn.active(start_round, k)}
        if self.poison_fn.needs_noise:
            out["noise"] = np.stack([
                noise_draws(r.attack_key(), start_round, k, self.layout.size)
                for r in self.rngs], axis=1)
        return out

    def _hook_inputs(self, start_round: int, k: int) -> dict:
        out = {}
        if self.poison_fn is not None:
            out.update(self._attack_inputs(start_round, k))
        if self.chaos is not None:
            out.update(self._chaos_masks(start_round, k)._asdict())
            if self.cfg.compat.vote_tie_break and not self.keyed_tie_break:
                out["reelect_draws"] = self._reelect_draws(start_round, k)
        if self.elastic is not None:
            out.update(self._elastic_masks(start_round, k)._asdict())
        return out

    def members_at(self, round_index: int, run: int) -> Optional[np.ndarray]:
        """[n_real] bool occupancy of run `run` after `round_index` rounds
        (None without an ElasticSpec)."""
        if self.elastic is None:
            return None
        self._elastic_masks(max(round_index - 1, 0), 1)
        per_run = MembershipMasks(*(m[:, run] for m in self._elastic_premade))
        return membership_at(per_run, round_index, self.n_real)[0]

    # ---- the batched round ---- #

    def fused_round(self, n_rounds: int = 1) -> BatchedFusedRound:
        """The engine's batched round, built once for chunks of up to
        max(n_rounds, fused_schedule_chunk) rounds (captured on the card
        at its first round); `states` reassigned since (a rewind, a reset)
        are copied into its buffers."""
        f = self._fused
        if f is None or f.capacity < n_rounds:
            cfg, d = self.cfg, self.tiled
            metric_shape = {"AUC": (), "classification": (3,)}.get(
                cfg.metric, (d.test_x.shape[1],))
            f = BatchedFusedRound(
                trainer=self.train_all,
                base_scores=make_mse_scores_fn(
                    self.model,
                    restandardize=cfg.compat.restandardize_vote_data,
                    tie_break=False),
                aggregate=make_runs_aggregate_fn(self.model,
                                                 self.update_type, self.runs,
                                                 n_real=self.n_real),
                verify=make_verify_fn(
                    self.model, cfg.verification_threshold,
                    cfg.performance_threshold,
                    hardened=cfg.hardened_verification,
                    recovery_budget=cfg.recovery_budget),
                evaluate_all=self.evaluate_all, layout=self.layout,
                states=self.states.clone(), data=d, ver_x=self._ver_x,
                ver_m=self._ver_m, priorities=self._priorities,
                max_threshold=cfg.max_aggregation_threshold,
                runs=self.runs, cohort=self.cohort_size(),
                capacity=max(n_rounds, cfg.fused_schedule_chunk, 1),
                compact=self.compact, tie_break=cfg.compat.vote_tie_break,
                metric_shape=metric_shape, poison=self.poison_fn,
                chaos=self.chaos is not None,
                elastic=self.elastic is not None,
                tie_keys=({"vote": [r.vote_key() for r in self.rngs],
                           "reelect": [r.reelect_key() for r in self.rngs]}
                          if self.keyed_tie_break else None))
            self._fused = f
            self.states = f.states
        elif self.states is not f.states:
            f.states.copy_(self.states)
            self.states = f.states
        return f

    def dispatch_schedule_chunk(self, start_round: int, k: int,
                                active: np.ndarray,
                                schedule: Optional[list] = None,
                                draws: Optional[torch.Tensor] = None,
                                active_rounds: Optional[np.ndarray] = None,
                                agg_count=None,
                                snapshot: bool = False) -> InFlightChunk:
        """Enqueue k rounds of every run and return before their outputs
        are read. `active` [R] bool: the runs whose early stop has not
        fired. Selections and draws come from each run's streams in round
        order (k successive sequential rounds per run) unless `schedule`
        ([k][R][S]) / `draws` replay recorded ones with a tighter
        `active_rounds` [k, R]; keyed rounds draw nothing and replay the
        same keyed rounds (`draws` None). `agg_count`: None uploads the
        host's quota, a previous chunk's device quota
        (InFlightChunk.agg_count) carries on, an [R, N] array (a replay's
        entry quota) is uploaded.
        `snapshot=True` keeps the chunk-entry states for a rewind."""
        if schedule is None:
            schedule = [[self.select_clients(r) for r in range(self.runs)]
                        for _ in range(k)]
            if self.cfg.compat.vote_tie_break and not self.keyed_tie_break:
                draws = torch.stack([
                    r.vote_draws(k, self.cohort_size(), self.n_real,
                                 width=self.n_pad)
                    for r in self.rngs], dim=1)
        f = self.fused_round(k)
        keyed = {}
        if self.keyed_tie_break:
            if f.tie_keys is None:
                raise RuntimeError("above the tie-break's size rule the "
                                   "batched round must be keyed")
            keyed = {"rounds": range(start_round, start_round + k),
                     "lane_ids": lane_ids(self.n_real, self.n_pad)}
        if active_rounds is None:
            active_rounds = np.broadcast_to(np.asarray(active, bool),
                                            (k, self.runs))
        if agg_count is f.agg_count:
            quota = None
        else:
            quota = self.host_agg_count() if agg_count is None else agg_count
        snap = self.states.clone() if snapshot else None
        t0 = time.time()
        harvest = f.dispatch(schedule, draws, quota, active_rounds,
                             self._hook_inputs(start_round, k),
                             start_round=start_round, **keyed)
        return InFlightChunk(start_round=start_round, n_rounds=k,
                             schedule=schedule, draws=draws,
                             agg_count=f.agg_count, harvest=harvest,
                             t_dispatch=t0, snap_states=snap,
                             active=np.asarray(active, bool).copy())

    def harvest_schedule_chunk(self, chunk: InFlightChunk):
        """Wait for a chunk's outputs: (outs [k][R] FusedRoundOuts,
        schedule, draws). The driver absorbs them (process_round)."""
        return chunk.harvest(), chunk.schedule, chunk.draws

    def run_schedule_chunk(self, start_round: int, k: int,
                           active: np.ndarray, schedule=None, draws=None,
                           active_rounds=None, agg_count=None):
        """k rounds of every run, dispatched and harvested."""
        return self.harvest_schedule_chunk(self.dispatch_schedule_chunk(
            start_round, k, active, schedule=schedule, draws=draws,
            active_rounds=active_rounds, agg_count=agg_count))

    def process_round(self, run: int, round_index: int,
                      selected: Sequence[int], outs,
                      chunk_pos: int) -> RoundResult:
        """One (round, run) of a chunk's outputs -> RoundResult and run r's
        host bookkeeping (call it only up to run r's stop round)."""
        return absorb_fused_out(outs[chunk_pos][run], round_index, selected,
                                self.n_real, self.host[run],
                                self.cfg.max_rejected_updates)

    def evaluate_final(self) -> np.ndarray:
        """[R, n_real] (or [R, n_real, 3]) final metrics of every run, one
        evaluation over the R·N clients."""
        d = self.tiled
        out = self.evaluate_all(self.layout.tree(self.states.params),
                                d.test_x, d.test_m, d.test_y, d.train_xb,
                                d.train_mb, priorities=self._priorities)
        out = out.cpu().numpy()
        return out.reshape((self.runs, self.n_pad) + out.shape[1:])[
            :, : self.n_real]

    def run_params(self, run: int) -> torch.Tensor:
        """Run r's flat [N, P] params."""
        return self.states.params.chunk(self.runs)[run]

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

The fault hooks (`poison_fn=`, `chaos=`, `elastic=`, `elastic_masks=`):
the attack runs on both paths, between aggregation and verification;
chaos and elastic membership exist in the fused round only, and the
engine refuses them on the per-phase path (`fused=False` or
`profile=True`), as the JAX engine does. Their per-round inputs are
evaluated on the host per absolute round and uploaded per chunk: the
attack bit and noise, the chaos masks and the crash re-election's draws,
the membership timeline. The membership timeline is a Markov chain, so
the engine expands it from round 0 for the whole horizon and slices it
(`_elastic_masks`); the memoryless chaos masks are cached the same way.

The fused round's vote tie-break follows the size rule (voting.
keyed_tie_break at (S, n_real): the REAL clients, so a padded axis or W
ranks key exactly when the unpadded run on one card does). Within it a
chunk's [R, S, N] uniforms come from the run's generator
(ExperimentRngs.vote_draws) and the crash re-election's from the chaos
stream (chaos.reelection_draws), and a rewind replays the recorded
sheet. Above it nothing of S x N exists: the round is built with the
run's keys (`vote_key`, `reelect_key`) and each election computes the
row of the one voter it reads on the device, from the chunk's absolute
rounds and the lanes' absolute ids; the generator draws no tie-break,
and a rewind replays the same keyed rounds.

Clustered federation (`cluster=` a ClusterSpec, cluster/) is fused-only
too. The gateway -> cluster assignment is fitted on the host at a chunk's
entry from the current states (cluster.fit_from_states: one probe-encode
launch, the JS matrix on the device, the medoids in numpy) and holds for
the whole chunk; `refit_every` refits at the first chunk entry that many
rounds after the last fit. `cluster_assignment=` pins an assignment
instead (a resume, or a comparison fed one assignment). A null spec
(k = 1, no personalization) builds nothing.

The red team (`redteam=` a RedteamSpec, redteam/) is fused-only too, and a
null spec is no spec. Its per-round inputs are the coalition and the
min-tenure gate, expanded for the whole horizon like the chaos masks
(`_redteam_masks`; the gate reads the membership timeline, so
`min_tenure` > 0 needs an ElasticSpec), the poison rounds' flags and, for
a noise poison, the update and merge noise of the run's red-team stream.
`redteam_masks=` replaces the drawn masks, as `elastic_masks=` does.

A client mesh (`mesh=` a parallel.ClientMesh of more than one rank) shards
the client axis: the engine keeps its rank's block of the states and data
and runs `fused.ShardedFusedRound`, or the per-phase round on its block
with the fleet's scores, merge partials and results gathered (compact off
on either path), with the merge of `cfg.aggregation_backend` resolved at
use on both paths (`agg_backend`: 'auto' through the measured plan,
parallel/costmodel.plan_merge). A mesh of
one rank leaves the axis unsharded: the engine is the plain one, and every
backend degrades to 'einsum' with one warning, as the JAX engine's does
off a sharded mesh. Every rank must drive its engine through the same
calls: each round, fit and evaluation is collective.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from fedmse_tpu_torch.config import ExperimentConfig
from fedmse_tpu_torch.data.stacking import FederatedData
from fedmse_tpu_torch.evaluation.evaluator import make_evaluate_all
from fedmse_tpu_torch.chaos.masks import (ChaosMasks, make_chaos_masks,
                                          reelection_draws)
# a module import: cluster.assign imports this package in turn
from fedmse_tpu_torch.cluster import assign as cluster_assign
from fedmse_tpu_torch.cluster.merge import (make_clustered_aggregate_fn,
                                            shared_mask)
from fedmse_tpu_torch.federation.aggregation import (BACKENDS,
                                                     make_aggregate_fn,
                                                     make_aggregate_for,
                                                     real_rows_merge)
from fedmse_tpu_torch.federation.attack import noise_draws
from fedmse_tpu_torch.federation.elastic import (MembershipMasks,
                                                 make_membership_masks,
                                                 membership_at)
from fedmse_tpu_torch.federation.fused import (FusedRound, FusedRoundOut,
                                              ShardedFusedRound,
                                              gather_vote_rows)
from fedmse_tpu_torch.federation.local_training import make_local_train_all
from fedmse_tpu_torch.federation.pipeline import InFlightChunk
from fedmse_tpu_torch.federation.state import (ClientStates, HostState,
                                               init_client_states,
                                               shard_client_states)
from fedmse_tpu_torch.federation.verification import make_verify_fn
from fedmse_tpu_torch.federation.voting import (elect_aggregator,
                                                keyed_tie_break,
                                                make_mse_scores_fn)
from fedmse_tpu_torch.models.flat import ParamLayout
from fedmse_tpu_torch.redteam.adversary import (make_redteam_fns,
                                                merge_noise, update_noise)
from fedmse_tpu_torch.redteam.masks import RedteamMasks, make_redteam_masks
from fedmse_tpu_torch.utils.profiling import PhaseTimer
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
    # the merge's effective backend: 'einsum' off a sharded mesh
    backend: Optional[str] = None
    # host seconds of each phase, with the device synchronized at each
    # phase's end (RoundEngine(profile=True) only)
    phase_seconds: Optional[Dict[str, float]] = None
    # the fault hooks' observables (fused path; None where not measured):
    # the selected clients that contributed (everyone selected without
    # chaos or elastic), the aggregator that crashed and was replaced,
    # each client's distance to the federation's mean model (chaos), the
    # occupied real slots and their tenant generations (elastic)
    effective: Optional[List[int]] = None
    crashed_aggregator: Optional[int] = None
    divergence: Optional[np.ndarray] = None
    members: Optional[List[int]] = None
    generations: Optional[np.ndarray] = None


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
                      max_rejected_updates: int,
                      row_ids: Optional[Sequence[int]] = None) -> List[Dict]:
    """The reference's verification rows of every real client (or of the
    ascending `row_ids` only) but the aggregator (is_verified is rejected
    == 0, not this round's accept bit), logging each client at the
    rejection limit."""
    rows: List[Dict] = []
    for i in (range(n_real) if row_ids is None else row_ids):
        i = int(i)
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
                     max_rejected_updates: int,
                     row_ids: Optional[Sequence[int]] = None
                     ) -> RoundResult:
    """Host bookkeeping and the RoundResult of one fused round's outputs:
    the quota and vote counters, the reference's verification rows and
    the attack flagging (port of fedmse_tpu/federation/rounds.py
    `absorb_fused_out`). `row_ids` (ascending) restricts the verification
    rows to those clients: the tiered layout's cohort, the only clients
    that verified (range(n_real) when the cohort is the fleet)."""
    aggregator = out.aggregator
    rows: List[Dict] = []
    if aggregator >= 0:
        host.aggregation_count[aggregator] += 1
        host.votes_received[aggregator] += 1
        host.rounds_aggregated.append((round_index, aggregator))
        rows = verification_rows(out.rejected, aggregator, n_real,
                                 max_rejected_updates, row_ids)
    else:
        logger.warning("No aggregator selected for round %d", round_index)
    metrics, metrics_full = split_metric_columns(out.metrics[:n_real])
    eff = out.eff_mask
    crashed = -1 if out.crashed is None else out.crashed
    return RoundResult(
        round_index=round_index, selected=list(selected),
        aggregator=None if aggregator < 0 else aggregator,
        client_metrics=metrics, metrics_full=metrics_full,
        verification_results=rows,
        mse_scores=None if aggregator < 0 else out.scores[:n_real],
        agg_weights=None if aggregator < 0 else out.weights,
        tracking=out.tracking[:n_real], min_valid=out.min_valid[:n_real],
        effective=(list(selected) if eff is None
                   else [i for i in selected if eff[i] > 0]),
        crashed_aggregator=None if crashed < 0 else crashed,
        divergence=(None if out.divergence is None
                    else out.divergence[:n_real]),
        members=(None if out.member is None else
                 np.flatnonzero(out.member[:n_real] > 0).tolist()),
        generations=(None if out.generation is None
                     else out.generation[:n_real]))


def make_round_fns(model, cfg: ExperimentConfig, model_type: str,
                   update_type: str, cluster=None,
                   device: Optional[torch.device] = None) -> Dict:
    """The round's functions, shared by the dense and the tiered engine:
    local training, the per-phase vote's scores, the merge (and the
    clustered merge and the shared-module mask when `cluster` is not
    null), verification and evaluation."""
    fns = {
        "train_all": make_local_train_all(
            model, epochs=cfg.epochs, patience=cfg.patience,
            fedprox=(update_type == "fedprox"), mu=cfg.fedprox_mu,
            lr=cfg.lr_rate, restore_best=not cfg.compat.no_best_restore),
        "scores_fn": make_mse_scores_fn(
            model, restandardize=cfg.compat.restandardize_vote_data,
            tie_break=cfg.compat.vote_tie_break),
        "aggregate": make_aggregate_fn(model, update_type),
        "verify": make_verify_fn(
            model, cfg.verification_threshold, cfg.performance_threshold,
            hardened=cfg.hardened_verification,
            recovery_budget=cfg.recovery_budget),
        "evaluate_all": make_evaluate_all(
            model, model_type, cfg.metric, score_kind=cfg.score_kind,
            knn_bank_size=cfg.knn_bank_size, knn_k=cfg.knn_k,
            knn_topk=cfg.knn_topk),
        "cluster_aggregate": None, "shared": None}
    if cluster is not None and not cluster.is_null:
        fns["cluster_aggregate"] = make_clustered_aggregate_fn(
            model, update_type, cluster.k)
        if cluster.personalize:
            fns["shared"] = shared_mask(ParamLayout.of(model),
                                        cluster.shared_modules,
                                        device=device)
    return fns


def lane_ids(n_real: int, n_pad: int) -> np.ndarray:
    """A keyed round's lanes: the padded axis' absolute client ids, -1 on
    the pad lanes (a jitter factor of 1)."""
    ids = np.arange(n_pad, dtype=np.int64)
    ids[n_real:] = -1
    return ids


def build_fused_round(model, cfg: ExperimentConfig, fns: Dict, *,
                      states: ClientStates, data: FederatedData, ver_x,
                      ver_m, priorities: Optional[torch.Tensor],
                      cohort: int, capacity: int, compact: bool,
                      poison_fn=None, chaos=None, elastic=None, cluster=None,
                      redteam_fns=None, mesh=None, n_global: int = 0,
                      tie_keys=None) -> FusedRound:
    """The fused round of `fns` (make_round_fns) on the buffers given: the
    dense engine's at the federation's width N, the tiered engine's at
    its cohort's width C. The round reads and updates these very
    tensors. A sharded `mesh` builds the rank's ShardedFusedRound over
    the block of an axis of `n_global` (its merge `fns["aggregate"]` /
    `fns["cluster_aggregate"]` the mesh's, `fns["divergence"]` the chaos
    mean's). `tie_keys` keys the tie-break (FusedRound: no [S, N]
    draws)."""
    metric_shape = {"AUC": (), "classification": (3,)}.get(
        cfg.metric, (data.test_x.shape[1],))
    spec = cluster if cluster is not None and not cluster.is_null else None
    cls, extra = FusedRound, {}
    if mesh is not None and mesh.sharded:
        cls = ShardedFusedRound
        extra = {"mesh": mesh, "n_global": n_global,
                 "divergence": fns.get("divergence")}
    return cls(**extra,
        trainer=fns["train_all"],
        base_scores=make_mse_scores_fn(
            model, restandardize=cfg.compat.restandardize_vote_data,
            tie_break=False),
        aggregate=(fns["aggregate"] if spec is None
                   else fns["cluster_aggregate"]),
        verify=fns["verify"], evaluate_all=fns["evaluate_all"],
        layout=ParamLayout.of(model), states=states, data=data,
        ver_x=ver_x, ver_m=ver_m, priorities=priorities,
        max_threshold=cfg.max_aggregation_threshold, cohort=cohort,
        capacity=capacity, compact=compact,
        tie_break=cfg.compat.vote_tie_break, metric_shape=metric_shape,
        poison=poison_fn, chaos=chaos is not None,
        elastic=elastic is not None,
        cluster_k=1 if spec is None else spec.k,
        personalize=spec is not None and spec.personalize,
        shared=fns["shared"], redteam=redteam_fns, tie_keys=tie_keys)


class MeshBackends:
    """The merge's backend of an engine over a client mesh, shared by the
    dense and the tiered engine. The engine sets `cfg`, `mesh`, `sharded`,
    `model`, `update_type`, `layout`, `fns`, `clustered` / `cluster`,
    `_merge_plan` (None) and `_warned_backend_off` (False)."""

    @property
    def agg_backend(self) -> str:
        """The effective backend, resolved at use: off a sharded mesh every
        backend is 'einsum' (one warning); 'auto' resolves once through
        the measured plan."""
        backend = self.cfg.aggregation_backend
        if backend == "einsum":
            return "einsum"
        if not self.sharded:
            if not self._warned_backend_off:
                self._warned_backend_off = True
                logger.warning(
                    "aggregation_backend=%s inert: the client axis is not "
                    "sharded across ranks; using the dense einsum "
                    "reduction", backend)
            return "einsum"
        if backend == "auto":
            return self._plan_backend()
        return backend

    def _plan_backend(self) -> str:
        if self._merge_plan is None:
            from fedmse_tpu_torch.parallel.costmodel import plan_merge
            k = self.cluster.k if self.clustered else 1
            hosts = self.cfg.quant_hosts
            self._merge_plan = plan_merge(
                self.mesh, [self.layout.size], k=k, n_hosts=hosts or None,
                group_counts=(hosts,) if hosts > 0 else None,
                dcn_gbps=self.cfg.merge_dcn_gbps)
            logger.info("merge plan (auto): %s", self._merge_plan["chosen"])
        return self._merge_plan["chosen"]["backend"]

    def _quant_knobs(self, backend: str):
        """(num_groups, block_size) of the quantized merge: the plan's when
        'auto' chose it, else the config's."""
        plan = self._merge_plan
        if plan is not None and plan["chosen"]["backend"] == backend:
            return (plan["chosen"]["num_groups"],
                    plan["chosen"]["block_size"] or self.cfg.quant_block_size)
        return self.cfg.quant_hosts, self.cfg.quant_block_size

    def _mesh_fns(self) -> Dict:
        """make_round_fns' functions with the merge (and the chaos mean) of
        the effective backend on the mesh."""
        backend = self.agg_backend
        hosts, block = self._quant_knobs(backend)
        fns = dict(self.fns)
        k = self.cluster.k if self.clustered else 0
        fns["aggregate"] = make_aggregate_for(
            self.model, self.update_type, backend, self.mesh,
            quant_hosts=hosts, quant_block_size=block)
        if k:
            fns["cluster_aggregate"] = make_aggregate_for(
                self.model, self.update_type, backend, self.mesh,
                quant_hosts=hosts, quant_block_size=block, cluster_k=k)
        from fedmse_tpu_torch.parallel.collectives import \
            make_shardmap_divergence
        fns["divergence"] = make_shardmap_divergence(self.mesh)
        return fns

    def model_params(self):
        """The clients' params as the stacked flax-layout tree."""
        return self.layout.tree(self.states.params)



class RoundEngine(MeshBackends):
    """One (model_type, update_type) federation over stacked client state.

    `states` (e.g. client_states_from_numpy of the JAX package's init)
    replaces the port's own init; reset_federation restores it.
    `fused=True` runs `run_round` through the fused round
    (federation/fused.py), unless `profile=True`, which times the phases
    and so runs the per-phase path. The fused round updates the tensors of
    `states` in place; clone them to keep a copy (the JAX package donates
    them).

    `poison_fn` (federation/attack.make_poison_fn) tampers with the merged
    model on either path; `chaos` (a ChaosSpec) and `elastic` (an
    ElasticSpec) need the fused path. `elastic_masks` (a MembershipMasks
    with [T, N] leaves) replaces the spec's drawn timeline, as in the
    JAX engine; the spec still builds the hook in. `cluster` (a
    ClusterSpec) needs the fused path unless it is null;
    `cluster_assignment` ([n_real] ints) pins the assignment instead of
    fitting one. `redteam` (a RedteamSpec) needs the fused path unless it
    is null, and an ElasticSpec when its `min_tenure` > 0;
    `redteam_masks` (RedteamMasks with [T, N] leaves) replaces its drawn
    coalition and gate. `mesh` (a parallel.ClientMesh) shards the client
    axis when it has more than one rank (module docstring): `data` and
    `states` are then the whole federation's, padded to a multiple of the
    ranks, and the engine keeps its rank's block."""

    def __init__(self, model, cfg: ExperimentConfig, data: FederatedData,
                 n_real: int, rngs: ExperimentRngs, model_type: str,
                 update_type: str, states: Optional[ClientStates] = None,
                 profile: bool = False, fused: bool = False,
                 poison_fn=None, chaos=None, elastic=None,
                 elastic_masks: Optional[MembershipMasks] = None,
                 cluster=None, cluster_assignment=None, redteam=None,
                 redteam_masks: Optional[RedteamMasks] = None, mesh=None):
        if cfg.state_layout != "dense":
            raise ValueError(
                f"state_layout={cfg.state_layout!r}: RoundEngine keeps the "
                "dense layout; state_layout='tiered' runs on "
                "federation/tiered.TieredRoundEngine")
        if fused and cfg.metric == "time":
            raise ValueError(
                "metric='time' times each client's scoring on the host and "
                "cannot run inside the fused round; use fused=False")
        for name, spec in (("chaos fault injection", chaos),
                           ("elastic membership", elastic)):
            if spec is not None and (not fused or profile):
                raise ValueError(
                    f"{name} is compiled into the fused round; construct "
                    "the engine with fused=True (and profile=False)")
        if cluster is not None and not cluster.is_null \
                and (not fused or profile):
            raise ValueError(
                "clustered federation is compiled into the fused round "
                "program; construct the engine with fused=True (and "
                "profile=False)")
        if elastic_masks is not None and elastic is None:
            raise ValueError(
                "elastic_masks needs an ElasticSpec: the override "
                "replaces the spec's TIMELINE, not the elastic hook "
                "itself (pass any non-null spec to build it in)")
        if redteam is not None and redteam.is_null:
            redteam = None  # builds nothing: the rounds of no spec
        if redteam is not None and (not fused or profile):
            raise ValueError(
                "redteam adversaries are compiled into the fused round "
                "program; construct the engine with fused=True (and "
                "profile=False)")
        if redteam is not None and redteam.min_tenure > 0 and elastic is None:
            raise ValueError("min_tenure > 0 needs an ElasticSpec: the "
                             "gate defers recycled tenants' votes, and a "
                             "static fleet has none to defer")
        if redteam_masks is not None and redteam is None:
            raise ValueError("redteam_masks needs a non-null RedteamSpec: "
                             "the override replaces the spec's masks, not "
                             "its hooks")
        if cfg.aggregation_backend not in BACKENDS:
            raise ValueError(f"unknown aggregation_backend "
                             f"{cfg.aggregation_backend!r} (auto | einsum | "
                             f"shard_map | quantized)")
        self.mesh = mesh
        self.sharded = mesh is not None and mesh.sharded
        self._warned_backend_off = False
        self._merge_plan = None
        self._full_data = data
        if self.sharded:
            from fedmse_tpu_torch.parallel.mesh import shard_federation
            data = shard_federation(data, None, mesh)[0]
        self.redteam = redteam
        self._redteam_fns = make_redteam_fns(redteam)
        self._redteam_override = redteam_masks
        self._redteam_premade = redteam_masks
        self.poison_fn, self.chaos, self.elastic = poison_fn, chaos, elastic
        self._elastic_override = elastic_masks
        self._chaos_premade: Optional[ChaosMasks] = None
        self._reelect_premade: Optional[np.ndarray] = None
        self._premade_seed = rngs.run_seed  # the streams the caches hold
        self._elastic_premade = elastic_masks
        self.model = model
        self.cfg = cfg
        self.data = data
        self.n_real = n_real
        self.n_pad = self._full_data.client_mask.shape[0]
        # this rank's rows [lo, hi) of the padded client axis
        self.block = (mesh.block(self.n_pad) if self.sharded
                      else (0, self.n_pad))
        self.rngs = rngs
        self.model_type = model_type
        self.update_type = update_type
        self.profile = profile
        self.fused = fused
        # the per-phase round's phase seconds, summed over its rounds
        self.timer = PhaseTimer(enabled=profile,
                                device=data.train_xb.device)
        if fused and profile:
            logger.warning("profile=True forces the per-phase round path; "
                           "a fused round's device time is kept per body "
                           "(enter, epoch, leave), not per phase, in "
                           "utils/profiling.recent_chunks()")
        self.device = data.train_xb.device
        self.layout = ParamLayout.of(model)
        # compact gathers would cross ranks on a sharded axis: off there
        self.compact = cfg.compact_cohort is not False and not self.sharded
        self.fns = make_round_fns(model, cfg, model_type, update_type,
                                  cluster, self.device)
        if not self.sharded and self.n_pad > n_real:
            # the pad clients weigh 0: merge the real rows, the unpadded
            # merge's bits
            for key in ("aggregate", "cluster_aggregate"):
                if self.fns[key] is not None:
                    self.fns[key] = real_rows_merge(self.fns[key], n_real)
        self.train_all = self.fns["train_all"]
        self.scores_fn = self.fns["scores_fn"]
        self.aggregate = self.fns["aggregate"]
        self.verify = self.fns["verify"]
        self.evaluate_all = self.fns["evaluate_all"]
        if states is not None and self.sharded:
            states = shard_client_states(states, mesh)
        self._init_states = None if states is None else states.clone()
        self.states = self._fresh_states()
        self.host = HostState.create(n_real)
        shared_ver = (cfg.verification_method == "dev"
                      or cfg.compat.shared_last_client_val)
        self._ver_x, self._ver_m = (
            t.to(self.device) for t in verification_tensors(
                cfg, self._full_data if shared_ver else data, n_real))
        self._fused: Optional[FusedRound] = None
        self._phase_merges: Dict[str, Callable] = {}  # by effective backend
        self.cluster = cluster
        self._cluster_assign = None  # the fitted ClusterAssignment
        self._cluster_vec: Optional[np.ndarray] = None  # [n_real] int32
        self._cluster_fitted_round = 0
        self._cluster_override = (None if cluster_assignment is None
                                  else np.asarray(cluster_assignment,
                                                  np.int32))
        self._cluster_stats_fn = None
        # per fit: its round and seconds (fit_from_states' timings)
        self.cluster_fit_seconds: List[Dict[str, float]] = []
        self.cluster_aggregate = self.fns["cluster_aggregate"]
        self._shared = self.fns["shared"]

    def _fresh_states(self) -> ClientStates:
        if self._init_states is not None:
            return self._init_states.clone()
        return init_client_states(self.model, self.n_real,
                                  self.rngs.generator, n_pad=self.n_pad,
                                  pad_key=self.rngs.init_pad_key(),
                                  device=self.device, mesh=self.mesh)

    def reset_federation(self) -> None:
        """Restart from construction state: fresh random streams, the
        initial client states and host counters."""
        self.rngs = ExperimentRngs(run=self.rngs.run,
                                   data_seed=self.rngs.data_seed,
                                   run_seed_stride=self.rngs.run_seed_stride)
        self.states = self._fresh_states()
        self.host = HostState.create(self.n_real)
        # the red team re-keys from the fresh streams
        self._redteam_premade = self._redteam_override
        if self.cluster is not None and self._cluster_override is None:
            # a fresh federation fits from its fresh init states
            self._cluster_assign = self._cluster_vec = None
            self._cluster_fitted_round = 0

    @property
    def clustered(self) -> bool:
        """Whether the fused round has clustered federation built in."""
        return self.cluster is not None and not self.cluster.is_null

    def cohort_size(self) -> int:
        """max(1, int(ratio N)): the clients a round selects."""
        return max(1, int(self.cfg.num_participants * self.n_real))

    def select_clients(self) -> List[int]:
        """cohort_size() clients from the host stream."""
        return self.rngs.select_rng.sample(range(self.n_real),
                                           self.cohort_size())

    def _fleet(self, t: torch.Tensor) -> np.ndarray:
        """A per-client tensor of the engine's rows as the fleet's [N, ...]
        numpy: on a sharded mesh the ranks' blocks gathered in rank order
        (a collective), otherwise a copy to the host."""
        if not self.sharded:
            return t.cpu().numpy()
        from fedmse_tpu_torch.parallel.mesh import host_fetch
        return host_fetch(t, self.mesh)

    def evaluate(self) -> np.ndarray:
        """The evaluator's output for every real client, as numpy (on a
        sharded mesh each rank evaluates its block, each client with its
        own kNN bank draw, and the blocks are gathered: a collective)."""
        d = self.data
        out = self.evaluate_all(self.model_params(), d.test_x, d.test_m,
                                d.test_y, d.train_xb, d.train_mb,
                                first=self.block[0])
        return self._fleet(out)[: self.n_real]

    def gathered_states(self) -> ClientStates:
        """The fleet's states [N, ...] on the host (CPU tensors), the same
        on every rank: a collective on a sharded mesh, a copy otherwise."""
        if not self.sharded:
            return self.states.apply(lambda t: t.detach().to("cpu",
                                                             copy=True))
        from fedmse_tpu_torch.parallel.mesh import host_fetch
        return self.states.apply(
            lambda t: torch.from_numpy(host_fetch(t, self.mesh)))

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
            d = self.data
            priorities = self.evaluate_all.bank_priorities(
                self.n_pad, d.train_xb.shape[1] * d.train_xb.shape[2],
                self.device)
            if self.sharded and priorities is not None:
                lo, hi = self.mesh.block(self.n_pad)
                priorities = priorities[lo:hi]
            f = build_fused_round(
                self.model, self.cfg,
                self._mesh_fns() if self.sharded else self.fns,
                states=self.states.clone(),
                data=d, ver_x=self._ver_x, ver_m=self._ver_m,
                priorities=priorities,
                cohort=cohort,
                capacity=max(n_rounds, self.cfg.fused_schedule_chunk, 1),
                compact=self.compact, poison_fn=self.poison_fn,
                chaos=self.chaos, elastic=self.elastic,
                cluster=self.cluster, redteam_fns=self._redteam_fns,
                mesh=self.mesh, n_global=self.n_pad,
                tie_keys=self._tie_keys() if self._keyed(cohort) else None)
            self._fused = f
            self.states = f.states
        elif self.states is not f.states:
            # reassigned since the last round (a rewind, a reset): the
            # captured round reads only its own buffers
            f.states.copy_(self.states)
            self.states = f.states
        return f

    # ---- the vote tie-break's size rule (voting.keyed_tie_break) ---- #

    def _keyed(self, cohort: Optional[int] = None) -> bool:
        """Whether a fused round of `cohort` selected clients (default
        cohort_size()) keys its tie-breaks: the rule at (S, n_real)."""
        cohort = self.cohort_size() if cohort is None else cohort
        return keyed_tie_break(self.cfg, cohort, self.n_real)

    @property
    def keyed_tie_break(self) -> bool:
        """Whether the engine's fused rounds key their tie-breaks."""
        return self._keyed()

    def _tie_keys(self) -> Dict:
        return {"vote": self.rngs.vote_key(),
                "reelect": self.rngs.reelect_key()}

    # ---- the fault hooks' per-round inputs ---- #

    def _check_premade(self) -> None:
        """Drop the cached timelines if `rngs` now holds another run's
        streams (a reset keeps the run, and the caches with it)."""
        if self._premade_seed != self.rngs.run_seed:
            self._premade_seed = self.rngs.run_seed
            self._chaos_premade = self._reelect_premade = None
            self._elastic_premade = self._elastic_override
            self._redteam_premade = self._redteam_override

    @staticmethod
    def _too_short(cached, end: int) -> bool:
        """Whether a cached [T, ...] timeline misses round end - 1."""
        return cached is None or end > cached[0].shape[0]

    def _chaos_masks(self, start_round: int, n_rounds: int) -> ChaosMasks:
        """The chunk's fault masks, sliced from the whole horizon's (a pure
        function of the spec, the run's chaos key and the absolute round,
        so every chunking and replay sees the same masks)."""
        self._check_premade()
        end = start_round + n_rounds
        if self._too_short(self._chaos_premade, end):
            self._chaos_premade = make_chaos_masks(
                self.chaos, self.rngs.chaos_key(), 0,
                max(end, self.cfg.num_rounds), self.n_pad)
        return ChaosMasks(*(m[start_round:end] for m in self._chaos_premade))

    def _reelect_draws(self, start_round: int, n_rounds: int,
                       cohort: int) -> np.ndarray:
        """The crash re-election's tie-break draws [R, S, N] of the chunk,
        sliced from the horizon's like the masks (redrawn for another
        cohort size)."""
        self._check_premade()
        end, cached = start_round + n_rounds, self._reelect_premade
        if cached is None or end > cached.shape[0] or \
                cached.shape[1] != cohort:
            self._reelect_premade = reelection_draws(
                self.rngs.chaos_key(), 0, max(end, self.cfg.num_rounds),
                cohort, self.n_pad)
        return self._reelect_premade[start_round:end]

    def _elastic_masks(self, start_round: int, n_rounds: int
                       ) -> MembershipMasks:
        """The chunk's membership masks, sliced from the timeline expanded
        from round 0 (a Markov chain; regrowing the horizon keeps its
        prefix)."""
        self._check_premade()
        end = start_round + n_rounds
        if self._too_short(self._elastic_premade, end):
            if self._elastic_override is not None:
                raise ValueError(
                    f"elastic_masks override covers "
                    f"{self._elastic_override.member.shape[0]} rounds but "
                    f"the schedule needs {end}")
            self._elastic_premade = make_membership_masks(
                self.elastic, self.rngs.elastic_key(),
                max(end, self.cfg.num_rounds), self.n_pad)
        return MembershipMasks(*(m[start_round:end]
                                 for m in self._elastic_premade))

    def generation_at(self, round_index: int) -> Optional[np.ndarray]:
        """[n_real] tenant generations after `round_index` rounds (None
        without an ElasticSpec): the checkpoint's roster record."""
        if self.elastic is None:
            return None
        self._elastic_masks(max(round_index - 1, 0), 1)
        return membership_at(self._elastic_premade, round_index,
                             self.n_real)[1]

    def members_at(self, round_index: int) -> Optional[np.ndarray]:
        """[n_real] bool occupancy after `round_index` rounds (None without
        an ElasticSpec): the final evaluation's NaN mask."""
        if self.elastic is None:
            return None
        self._elastic_masks(max(round_index - 1, 0), 1)
        return membership_at(self._elastic_premade, round_index,
                             self.n_real)[0]

    def _attack_inputs(self, start_round: int, n_rounds: int) -> dict:
        """The attack bit [R] and, for a noise attack, the noise [R, P]
        ([R, K·P] when clustered: a row per cluster merge)."""
        out = {"attack": self.poison_fn.active(start_round, n_rounds)}
        if self.poison_fn.needs_noise:
            width = self.layout.size * (self.cluster.k if self.clustered
                                        else 1)
            out["noise"] = noise_draws(self.rngs.attack_key(), start_round,
                                       n_rounds, width)
        return out

    def _redteam_masks(self, start_round: int, n_rounds: int
                       ) -> RedteamMasks:
        """The chunk's coalition and tenure gate, sliced from the whole
        horizon's (the gate reads the membership timeline over the same
        rounds)."""
        self._check_premade()
        end = start_round + n_rounds
        if self._too_short(self._redteam_premade, end):
            if self._redteam_override is not None:
                raise ValueError(
                    f"redteam_masks override covers "
                    f"{self._redteam_override.adv.shape[0]} rounds but the "
                    f"schedule needs {end}")
            horizon = max(end, self.cfg.num_rounds)
            membership = None
            if self.redteam.min_tenure > 0:
                self._elastic_masks(0, horizon)
                membership = self._elastic_premade
            self._redteam_premade = make_redteam_masks(
                self.redteam, self.rngs.redteam_key(), horizon, self.n_pad,
                membership=membership)
        return RedteamMasks(*(m[start_round:end]
                              for m in self._redteam_premade))

    def _redteam_noise(self, start_round: int, n_rounds: int) -> dict:
        """A noise poison's draws for the chunk: the update stage's [R, N,
        P] and the merge stage's [R, P] ([R, K·P] when clustered)."""
        p, key = self.layout.size, self.rngs.redteam_key()
        width = p * (self.cluster.k if self.clustered else 1)
        return {"rt_update_noise": update_noise(key, start_round, n_rounds,
                                                self.n_pad, p),
                "rt_merge_noise": merge_noise(key, start_round, n_rounds,
                                              width)}

    def _redteam_inputs(self, start_round: int, n_rounds: int) -> dict:
        """The red team's inputs for rounds [start_round, +n_rounds), by
        FusedRound.input_names."""
        fns, out = self._redteam_fns, {}
        masks = self._redteam_masks(start_round, n_rounds)
        if self.redteam.attacks:
            out["rt_adv"] = masks.adv
            out["rt_active"] = fns.active(start_round, n_rounds)
        if fns.gate_votes:
            out["rt_vote_ok"] = masks.vote_ok
        if fns.needs_noise:
            out.update(self._redteam_noise(start_round, n_rounds))
        return out

    def _hook_inputs(self, start_round: int, n_rounds: int,
                     cohort: int) -> dict:
        """Every built-in hook's inputs for rounds [start_round, +n_rounds),
        by FusedRound.input_names (a keyed round's crash re-election reads
        the keyed stream: no draws)."""
        out = {}
        if self.poison_fn is not None:
            out.update(self._attack_inputs(start_round, n_rounds))
        if self.chaos is not None:
            out.update(self._chaos_masks(start_round, n_rounds)._asdict())
            if self.cfg.compat.vote_tie_break and not self._keyed(cohort):
                out["reelect_draws"] = self._reelect_draws(
                    start_round, n_rounds, cohort)
        if self.elastic is not None:
            out.update(self._elastic_masks(start_round, n_rounds)._asdict())
        if self.redteam is not None:
            out.update(self._redteam_inputs(start_round, n_rounds))
        return out

    # ---- clustered federation (cluster/) ---- #

    @property
    def cluster_assignment(self) -> Optional[np.ndarray]:
        """The current [n_real] gateway -> cluster vector (None until the
        first clustered dispatch fits it): the checkpoint extra reads it."""
        return self._cluster_vec

    @property
    def cluster_fitted_round(self) -> int:
        """The round the current assignment was fitted at (or pinned with):
        a refit is due `refit_every` rounds after it."""
        return int(self._cluster_fitted_round)

    @property
    def cluster_fit(self) -> Optional[cluster_assign.ClusterAssignment]:
        """The fitted ClusterAssignment (latent statistics, pooled cluster
        Gaussians); None when the assignment was pinned."""
        return self._cluster_assign

    def set_cluster_assignment(self, assignment, fitted_round: int = 0
                               ) -> None:
        """Pin the assignment (a resume: the snapshot's states were merged
        under it; a refit resumes on the recorded cadence clock)."""
        assignment = np.asarray(assignment, np.int32)
        if len(assignment) != self.n_real:
            raise ValueError(f"assignment covers {len(assignment)} "
                             f"gateways, federation has {self.n_real}")
        spec = self.cluster
        if spec is not None and assignment.size \
                and int(assignment.max()) >= spec.k:
            raise ValueError(
                f"assignment references cluster {int(assignment.max())} "
                f"but the spec has k={spec.k}; a K change re-tenants every "
                "cluster model — resume with the matching ClusterSpec")
        self._cluster_vec = assignment
        self._cluster_assign = None
        self._cluster_fitted_round = fitted_round

    def cluster_refit_due(self, round_index: int) -> bool:
        """Whether a dispatch at `round_index` fits the assignment anew (it
        then reads the states every earlier round left)."""
        if not self.clustered:
            return False
        if self._cluster_override is not None:
            return False
        return (self._cluster_vec is None
                or (self.cluster.refit_every > 0
                    and round_index - self._cluster_fitted_round
                    >= self.cluster.refit_every))

    def _ensure_cluster_fit(self, round_index: int) -> None:
        """Fit (or refit on the cadence) the assignment before a dispatch:
        the incumbent mean of the current states probes every gateway's
        normal-train rows, and the JS k-medoids groups their latent
        statistics (cluster/assign.py)."""
        spec = self.cluster
        if self._cluster_override is not None:
            if self._cluster_vec is None:
                self.set_cluster_assignment(self._cluster_override)
            return
        if not self.cluster_refit_due(round_index):
            return
        if self._cluster_stats_fn is None:
            maker = (cluster_assign.make_latent_rows_fn
                     if spec.metric == "gmm"
                     else cluster_assign.make_latent_stats_fn)
            self._cluster_stats_fn = maker(self.model)
        timings: Dict[str, float] = {}
        params, d = self.states.params, self.data
        xb, mb, cm = d.train_xb, d.train_mb, d.client_mask
        if self.sharded:
            # every rank fits from the whole fleet, on the same bits
            full = self._full_data
            params = self.gathered_states().params.to(self.device)
            xb, mb, cm = (t.to(self.device) for t in (
                full.train_xb, full.train_mb, full.client_mask))
        self._cluster_assign = cluster_assign.fit_from_states(
            self.model, spec, params, xb, mb, cm, self.n_real,
            fitted_round=round_index, stats_fn=self._cluster_stats_fn,
            prev_assignment=self._cluster_vec, timings=timings)
        self.cluster_fit_seconds.append({"round": round_index, **timings})
        self._cluster_vec = self._cluster_assign.assignment
        self._cluster_fitted_round = round_index
        logger.info("cluster fit at round %d: k=%d sizes=%s", round_index,
                    spec.k, np.bincount(self._cluster_vec,
                                        minlength=spec.k).tolist())

    def _cluster_input(self, round_index: int) -> Optional[np.ndarray]:
        """The [n_pad] assignment a dispatch at `round_index` uploads (None
        when clustering is off or null); pad slots carry cluster 0."""
        if not self.clustered:
            return None
        self._ensure_cluster_fit(round_index)
        vec = np.zeros(self.n_pad, np.int32)
        vec[: self.n_real] = self._cluster_vec
        return vec

    def _host_agg_count(self) -> np.ndarray:
        return np.pad(self.host.aggregation_count,
                      (0, self.n_pad - self.n_real))

    def dispatch_schedule_chunk(self, start_round: int, n_rounds: int,
                                agg_count=None, snapshot: bool = False,
                                schedule: Optional[List[List[int]]] = None,
                                draws: Optional[torch.Tensor] = None,
                                cluster_in: Optional[np.ndarray] = None
                                ) -> InFlightChunk:
        """Enqueue n_rounds fused rounds and return before their outputs
        are read (federation/pipeline.py). Selections and tie-break draws
        come from the host streams, in the order of n_rounds successive
        run_round_fused calls, unless `schedule` / `draws` replay recorded
        ones; above the size rule the rounds are keyed and draw nothing
        (`draws` must then be None: a keyed round holds no sheet).
        `agg_count` is a previous chunk's device quota
        (InFlightChunk.agg_count) to carry on; None uploads the host's.
        `snapshot=True` keeps a device copy of the chunk-entry states for
        an early stop's rewind. A clustered engine fits the assignment
        when one is due (`cluster_refit_due`) unless `cluster_in` replays a
        recorded one.

        On the card the call returns once the last round's final epoch is
        enqueued: the host reads each epoch's early-stop flag one epoch
        behind the card (federation/fused.py)."""
        if schedule is None:
            schedule = [self.select_clients() for _ in range(n_rounds)]
        f = self.fused_round(n_rounds, len(schedule[0]))
        keyed = {}
        if self._keyed(f.cohort_size):
            if f.tie_keys is None:
                raise RuntimeError("above the tie-break's size rule the "
                                   "fused round must be keyed")
            f.set_tie_keys(self._tie_keys())
            keyed = {"rounds": range(start_round, start_round + n_rounds),
                     "lane_ids": lane_ids(self.n_real, self.n_pad)}
        elif draws is None and self.cfg.compat.vote_tie_break:
            draws = self.rngs.vote_draws(n_rounds, f.cohort_size,
                                         self.n_real, width=self.n_pad)
        if cluster_in is None:
            cluster_in = self._cluster_input(start_round)
        snap = self.states.clone() if snapshot else None
        t0 = time.time()
        inputs = self._hook_inputs(start_round, n_rounds, f.cohort_size)
        harvest = f.dispatch(
            schedule, draws,
            None if agg_count is f.agg_count else self._host_agg_count(),
            inputs, cluster_in=cluster_in, start_round=start_round, **keyed)
        return InFlightChunk(start_round=start_round, n_rounds=n_rounds,
                             schedule=schedule, draws=draws,
                             agg_count=f.agg_count, harvest=harvest,
                             t_dispatch=t0, snap_states=snap,
                             cluster_in=cluster_in)

    def harvest_schedule_chunk(self, chunk: InFlightChunk):
        """Wait for a dispatched chunk's outputs and absorb them into the
        host counters: (results, schedule, draws)."""
        results = [absorb_fused_out(out, chunk.start_round + r,
                                    chunk.schedule[r], self.n_real,
                                    self.host,
                                    self.cfg.max_rejected_updates)
                   for r, out in enumerate(chunk.harvest())]
        backend = self.agg_backend
        for result in results:
            result.backend = backend
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
                        draws: Optional[torch.Tensor] = None,
                        cluster_in: Optional[np.ndarray] = None
                        ) -> RoundResult:
        """One fused round. `selected` / `draws` ([S, N]) / `cluster_in`
        override the host streams and the assignment: the driver replays a
        chunk's prefix with them."""
        chunk = self.dispatch_schedule_chunk(
            round_index, 1,
            schedule=None if selected is None else [list(selected)],
            draws=None if draws is None else draws[None],
            cluster_in=cluster_in)
        return self.harvest_schedule_chunk(chunk)[0][0]

    # ---- the per-phase path ---- #

    def _phase_merge(self):
        """The per-phase round's merge of the effective backend: the dense
        merge off a sharded mesh, else the mesh's (built once a
        backend)."""
        backend = self.agg_backend
        if not self.sharded:
            return self.aggregate
        if backend not in self._phase_merges:
            self._phase_merges[backend] = self._mesh_fns()["aggregate"]
        return self._phase_merges[backend]

    def _vote_rows(self, voter: int):
        """The valid split of client `voter` (a global id): this rank's row
        off a mesh, else gathered from the rank that owns it."""
        d = self.data
        if not self.sharded:
            return d.valid_x[voter], d.valid_m[voter]
        return gather_vote_rows(self.mesh, d, self.block[0],
                                torch.tensor([voter], device=self.device))

    def run_round(self, round_index: int,
                  selected: Optional[List[int]] = None) -> RoundResult:
        """One round: the fused round unless the engine is per-phase
        (`fused=False` or `profile=True`). The per-phase round runs the
        phases with the host between them; on a sharded mesh each rank
        runs them on its block, and the fleet's scores, merge partials,
        rejection counts and results are gathered (every rank makes the
        same collectives: the election runs on the gathered bits, so
        every rank makes the same voter calls)."""
        if self.fused and not self.profile:
            return self.run_round_fused(round_index, selected)
        if self.chaos is not None or self.elastic is not None:
            raise ValueError("chaos and elastic membership run in the fused "
                             "round only (profile=True forces the per-phase "
                             "path)")
        cfg, data, dev, timer = self.cfg, self.data, self.device, self.timer
        lo, hi = self.block
        if selected is None:
            selected = self.select_clients()
        before = timer.timings()
        sel_all = torch.zeros(self.n_pad, device=dev)
        sel_all[selected] = 1.0
        sel_mask = sel_all[lo:hi]
        sel_idx = (torch.tensor(sorted(selected), dtype=torch.long,
                                device=dev) if self.compact else None)
        with timer.phase("train"):
            res = self.train_all(self.states.params, self.states.opt_state,
                                 self.states.prev_global, sel_mask,
                                 data.train_xb, data.train_mb, data.valid_xb,
                                 data.valid_mb, sel_idx=sel_idx)
            self.states = self.states.replace(params=res.params,
                                              opt_state=res.opt_state)

        with timer.phase("vote"):
            # the first selected client's valid split is the vote tensor
            vote_x, vote_m = self._vote_rows(selected[0])

            def fresh_scores() -> np.ndarray:
                return self._fleet(self.scores_fn(
                    self.states.params, vote_x, vote_m, self.rngs.generator,
                    fleet=(lo, self.n_real)))

            aggregator, scores = elect_aggregator(
                selected, fresh_scores, self.host.aggregation_count,
                self.host.votes_received, cfg.max_aggregation_threshold)

        rows: List[Dict] = []
        agg_weights = None
        if aggregator is not None and self.host.aggregation_count[
                aggregator] < cfg.max_aggregation_threshold:
            with timer.phase("aggregate"):
                merged, weights = self._phase_merge()(
                    self.states.params, sel_mask, data.dev_x,
                    sel_idx=sel_idx)
                if self.poison_fn is not None:  # the malicious aggregator
                    attack = {k: torch.as_tensor(v[0]).to(dev) for k, v in
                              self._attack_inputs(round_index, 1).items()}
                    merged = self.poison_fn(merged, attack["attack"],
                                            attack.get("noise"))
                agg_weights = self._fleet(weights)
                self.host.aggregation_count[aggregator] += 1
                self.host.rounds_aggregated.append((round_index, aggregator))
            with timer.phase("verify"):
                onehot = (torch.arange(lo, hi, device=dev)
                          == aggregator).to(torch.float32)
                outcome = self.verify(self.states, merged, self._ver_x,
                                      self._ver_m, onehot, data.client_mask)
                self.states = outcome.states
                rejected = self._fleet(self.states.rejected)
            rows = verification_rows(rejected, aggregator, self.n_real,
                                     cfg.max_rejected_updates)
        else:
            logger.warning("No aggregator selected for round %d",
                           round_index)

        with timer.phase("evaluate"):
            metrics, metrics_full = split_metric_columns(self.evaluate())
        # this round's share of the timer's running sums
        seconds = {k: v - before.get(k, 0.0)
                   for k, v in timer.timings().items() if v != before.get(k)}
        return RoundResult(
            round_index=round_index, selected=list(selected),
            aggregator=aggregator, client_metrics=metrics,
            metrics_full=metrics_full,
            verification_results=rows,
            mse_scores=(None if scores is None
                        else np.asarray(scores)[: self.n_real]),
            agg_weights=agg_weights,
            tracking=self._fleet(res.tracking)[: self.n_real],
            min_valid=self._fleet(res.min_valid)[: self.n_real],
            backend=self.agg_backend,
            phase_seconds=seconds if self.profile else None)

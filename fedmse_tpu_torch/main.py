"""Experiment driver: the sweep {model_type x update_type x run} with the
reference's results artifacts (port of fedmse_tpu/main.py).

  * data is prepared ONCE and shared by every combination (the reference
    re-seeds to data_seed before each, so every combination sees the same
    splits);
  * `run_combination` is the reference round loop, the final evaluation
    and the artifacts of one (model_type, update_type, run). By default
    it runs the fused schedule (federation/fused.py): chunks of
    `fused_schedule_chunk` fused rounds, pipelined so that the host's
    bookkeeping of a chunk overlaps the next one on the card
    (federation/pipeline.py). `--no-pipeline` (fused_pipeline=False) runs
    the serial chunk loop, `--fused-schedule false` or `--fused-rounds
    false` round by round (the latter on the per-phase path);
  * global early stopping keeps the reference's inverted-AUC comparison and
    its state shared across combinations (compat switches), checked per
    round; a stop inside a chunk rewinds to the chunk's entry and replays
    its prefix with the same selections and draws;
  * `run_experiment` sweeps every combination and writes the summary.
  * `--model-types kitnet` trains Kitsune's KitNET (models/kitnet.py) on
    the same round; it needs `--scaler minmax`, and the federation's
    feature map is computed once from the gateways' train rows at the
    combination's set-up. It runs the dense layout without the fault
    hooks, batched runs, a mesh, snapshots or serving (each refused by
    name).

  * the fault path: `--attack-*` (a malicious aggregator,
    federation/attack.py), `--chaos-*` (churn, stragglers, aggregator
    crashes, broadcast loss; chaos/) and `--elastic-*` (joins, leaves and
    preemptions of client slots; federation/elastic.py) compose in the
    fused round; each tags the experiment name so its artifacts land in a
    tree of their own, and the summary records the specs;
  * `--cluster-k K [--cluster-personalize] [--cluster-refit-every N]`
    splits the federation into K cluster-level models (cluster/), fitted
    from the gateways' latent statistics at a chunk's entry, with each
    gateway's decoder kept local under personalization; it tags the
    experiment name and the summary records the spec;
  * `--resume-dir` snapshots the federation after every chunk (or round)
    and resumes a killed run where it stopped (checkpointing/io.py
    CheckpointManager), with the selection and torch streams where they
    were: a resumed run is the uninterrupted one. It runs the serial chunk
    loop, as in the JAX package (a pipelined boundary is speculative);
  * `--state-layout tiered` keeps the fleet's client state and data in
    host memory and moves each round's cohort to the card
    (`run_tiered_combination`, federation/tiered.py): the same artifacts,
    with a non-cohort client's round metric NaN below full participation;
  * `--batch-runs` runs a combination's `num_runs` seeds as one batched
    federation (`run_batched_combination`, federation/batched.py): R runs
    x N clients in one set of captured bodies, per-run early stopping as
    a freeze mask, and per run the artifacts the sequential driver
    writes. It needs the fused schedule and the dense layout: under
    --resume-dir, metric='time', --cluster-k, --state-layout tiered, or
    with fused rounds or the fused schedule off, the driver warns and runs
    the seeds one after another;
  * `--serve` then runs the serving pass (serving/smoke.py) on the first
    combination's checkpoint, and `--flywheel` the closed-loop pass
    (flywheel/harness.py): the checkpoint served through the continuous
    front with the reservoir tap and the controller, a covariate shift
    ramped into the stream, the drift-triggered fine-tune and the hot swap
    (the `--flywheel-*` knobs are ExperimentConfig fields);
  * `--serve-net` runs the network plane's pass (net/smoke.py) on the same
    checkpoint: `--net-replicas` engine replicas, each on a CUDA stream of
    its own, behind the roster-aware router and tiered admission, served
    over a localhost TCP socket (`--net-port`, 0 = ephemeral) in NIC-poll
    bursts with a mid-stream calibration swap broadcast to every replica.

CLI (runs on the card unless --device cpu):
    python -m fedmse_tpu_torch.main --dataset-config <reference json>
        [--data-root DIR] [--device cpu] [--no-save] [--paper-scale]
        [--num-rounds 20] [--epochs 100] [--score-kind knn] [--no-pipeline]
        [--attack-kind scale ...] [--chaos-dropout 0.2 ...]
        [--elastic-leave 0.1 ...] [--cluster-k 4 [--cluster-personalize]
        [--cluster-refit-every N]] [--resume-dir DIR] [--batch-runs]
        [--state-layout tiered [--host-sharded true]] [--use-mesh
        [--aggregation-backend einsum|shard_map|quantized|auto]
        [--quant-hosts G] [--quant-block-size B]]
        [--serve [--serve-rows N] [--serve-warmup] [--serve-continuous]]
        [--flywheel [--flywheel-rounds 3 --flywheel-async true ...]]
        [--serve-net [--net-replicas N --net-port P]]
        [--model-types kitnet --scaler minmax [--kitnet-max-ae 10]
        [--kitnet-hidden-ratio 0.75]] ...
Many ranks: `--use-mesh` shards the client axis over the ranks of a
torch.distributed launch (parallel/; `torchrun --nproc-per-node W -m
fedmse_tpu_torch.main --use-mesh ...` on a host with W cards, or the
launcher's environment on many hosts). `main` joins the launch before any
CUDA use (parallel/multihost.initialize): NCCL between cards, gloo under
--device cpu. A mesh is built only when the world size is above 1 (at
world 1 the run is the plain run, bit for bit); the client axis is padded
to a multiple of the ranks, every rank trains its block, and only rank 0
writes results, checkpoints and snapshots, from the gathered states.
Padding draws nothing (utils/seeding.py): the init and the tie-breaks
are drawn at the real client count, so any W makes the one-card run's
draws and selections. The merge sums the ranks' partials in rank order
(as the JAX package's psum does), so only its last bits move with W:
with the tie-break off the elections are the one-card run's; with it on
round 1's are, and a later one may flip where Adam on a loss plateau
turns those bits into another ranking.
`--state-layout tiered --use-mesh` shards each round's cohort over the
ranks, and `--host-sharded true` keeps each rank's block of the fleet's
tier on its own host (federation/tiered.py). The red team is ported
(fedmse_tpu_torch/redteam/: its round half through RoundEngine(redteam=),
its ingest half in redteam/ingest.py); as in the JAX package, no flag
drives it. The network plane's worker and the
gateway frontend are entries of their own: `python -m
fedmse_tpu_torch.net.server` and `python -m
fedmse_tpu_torch.gateway.frontend` (both take --device).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from fedmse_tpu_torch.chaos import ChaosSpec
from fedmse_tpu_torch.cluster import ClusterSpec, assignment_from_extra
from fedmse_tpu_torch.checkpointing import (CheckpointManager, ResultsWriter,
                                            save_client_models,
                                            save_latent_data,
                                            save_training_tracking)
from fedmse_tpu_torch.config import (DatasetConfig, ExperimentConfig,
                                     add_cli_overrides, apply_cli_overrides,
                                     paper_scale)
from fedmse_tpu_torch.data import (FederatedData, build_dev_dataset,
                                   pad_federated_data, prepare_clients,
                                   stack_clients)
from fedmse_tpu_torch.device import DeviceLike, resolve_device
from fedmse_tpu_torch.evaluation.evaluator import client_index
from fedmse_tpu_torch.federation import (ClientStates, RoundEngine,
                                         split_metric_columns)
from fedmse_tpu_torch.federation.attack import AttackSpec, make_poison_fn
from fedmse_tpu_torch.federation.elastic import ElasticSpec
from fedmse_tpu_torch.federation.batched import BatchedRunEngine
from fedmse_tpu_torch.federation.pipeline import (run_pipelined_batched,
                                                  run_pipelined_schedule)
from fedmse_tpu_torch.federation.tiered import run_tiered_combination
from fedmse_tpu_torch.flywheel import run_flywheel_smoke
from fedmse_tpu_torch.models import kitnet, make_model
from fedmse_tpu_torch.net.smoke import run_net_smoke
from fedmse_tpu_torch.ops.fused_ae import fused_forward_stats
from fedmse_tpu_torch.ops.precision import get_policy
from fedmse_tpu_torch.parallel.mesh import (ClientMesh, client_mesh,
                                            pad_to_multiple)
from fedmse_tpu_torch.parallel.multihost import initialize as \
    initialize_multihost
from fedmse_tpu_torch.parallel.multihost import uniform_decision
from fedmse_tpu_torch.serving.smoke import run_serve_smoke
from fedmse_tpu_torch.utils.seeding import ExperimentRngs

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class GlobalEarlyStop:
    """The reference's global early stop: `min(client_metrics) < best`
    counts as improvement (a loss convention applied to AUC), and the state
    may be carried across combinations."""

    inverted: bool = True
    patience: int = 1
    best: float = dataclasses.field(init=False)
    worse: int = dataclasses.field(init=False)

    def __post_init__(self):
        self.reset()

    def reset(self):
        self.best, self.worse = (math.inf if self.inverted else -math.inf), 0

    def should_stop(self, client_metrics: np.ndarray) -> bool:
        value = float(np.nanmin(client_metrics))
        improved = value < self.best if self.inverted else value > self.best
        if improved:
            self.best, self.worse = value, 0
            return False
        self.worse += 1
        return self.worse > self.patience


def prepare_federation(cfg: ExperimentConfig, dataset: DatasetConfig, *,
                       device: DeviceLike = "cuda"):
    """Load, split and stack the federation once; the feature tensors are
    stored in the precision policy's compute dtype."""
    dev = resolve_device(device)  # before any file is read
    rngs = ExperimentRngs(run=0, data_seed=cfg.data_seed)
    clients = prepare_clients(dataset, cfg, rngs.data_rng)
    dev_x = build_dev_dataset(clients, rngs.data_rng)
    data = stack_clients(clients, dev_x, cfg.batch_size,
                         dtype=get_policy(cfg.precision).compute_dtype,
                         device=dev)
    return clients, data, len(clients)


@torch.no_grad()
def _save_hybrid_latents(writer: ResultsWriter, engine, run: int,
                         update_type: str,
                         params: Optional[torch.Tensor] = None,
                         data: Optional[FederatedData] = None) -> None:
    """The hybrid's test latents and labels of every real client (`params`
    [N, P]: a batched engine's run, or a meshed engine's gathered states
    with its whole `data`; the engine's states by default)."""
    d, n = engine.data if data is None else data, engine.n_real
    cdt = engine.model.compute_dtype
    t = d.test_x.shape[1]
    params = engine.states.params if params is None else params
    if d.test_x.device != params.device:
        d = FederatedData(**{f.name: getattr(d, f.name).to(params.device)
                             for f in dataclasses.fields(FederatedData)})
    latent, _, _ = fused_forward_stats(
        engine.layout.tree(params[:n], cdt),
        d.test_x[:n].reshape(n * t, -1).to(cdt),
        client_index(n, t, d.test_x.device), compute_dtype=cdt)
    mask = d.test_m[:n].reshape(-1).cpu().numpy() > 0
    save_latent_data(writer, run, update_type,
                     latent.cpu().numpy()[mask],
                     d.test_y[:n].reshape(-1).cpu().numpy()[mask])


def run_combination(cfg: ExperimentConfig, data, n_real: int,
                    model_type: str, update_type: str, run: int,
                    writer: Optional[ResultsWriter] = None,
                    early_stop: Optional[GlobalEarlyStop] = None,
                    device_names: Optional[List[str]] = None,
                    save_checkpoints: bool = False,
                    states: Optional[ClientStates] = None,
                    profile: bool = False,
                    on_round=None,
                    resume: Optional[CheckpointManager] = None,
                    attack: Optional[AttackSpec] = None,
                    chaos: Optional[ChaosSpec] = None,
                    elastic: Optional[ElasticSpec] = None,
                    cluster: Optional[ClusterSpec] = None,
                    device: Optional[DeviceLike] = None,
                    mesh: Optional[ClientMesh] = None) -> Dict:
    """One (model_type, update_type, run): the reference round loop, the
    final evaluation and the artifacts. Runs on `device`, by default where
    `data` lives (state_layout='tiered': run_tiered_combination, whose
    data may stay on the host while the rounds run on the card). `states`
    replaces the port's own init (a JAX-exported init, say); `profile`
    times each round's phases (RoundResult.phase_seconds) on the
    per-phase path; `on_round(result, seconds)` sees every round.
    `attack`, `chaos` and `elastic` are the fault specs, `cluster` the
    clustering; `resume`
    snapshots the run after each chunk (or round) and resumes it from its
    snapshot when there is one. `mesh` (more than one rank) shards the
    client axis: `data` is then the whole federation (on the host), every
    rank calls this together, and only the rank with a `writer` writes
    (rank 0 in the driver)."""
    sharded = mesh is not None and mesh.sharded
    device = data.train_xb.device if device is None else \
        resolve_device(device)
    feature_map = None
    if model_type == "kitnet":
        kitnet.check_supported(cfg, use_mesh=sharded,
                               resume=resume is not None)
        feature_map = kitnet.federated_feature_map(
            data.train_xb, data.train_mb, data.client_mask, cfg.kitnet_max_ae)
        logger.info("KitNET feature map: %d autoencoders of %s features",
                    len(feature_map), [len(c) for c in feature_map])
    if cfg.state_layout == "tiered":
        if profile:
            raise ValueError("profile=True times the per-phase round; the "
                             "tiered layout runs the fused cohort round")
        return run_tiered_combination(
            cfg, data, n_real, model_type, update_type, run, writer=writer,
            early_stop=early_stop, device_names=device_names, resume=resume,
            save_checkpoints=save_checkpoints, attack=attack, chaos=chaos,
            elastic=elastic, cluster=cluster, states=states,
            on_round=on_round, device=device, mesh=mesh)
    if sharded:
        device = mesh.device
    elif data.train_xb.device.type != device.type:
        raise ValueError(f"the dense layout runs where its data lives "
                         f"({data.train_xb.device}), not on {device}")
    if not sharded:
        device = data.train_xb.device
    rngs = ExperimentRngs(run=run, data_seed=cfg.data_seed,
                          run_seed_stride=cfg.run_seed_stride)
    model = make_model(model_type, cfg.dim_features, cfg.hidden_neus,
                       cfg.latent_dim, cfg.shrink_lambda,
                       precision=cfg.precision, device=device,
                       feature_map=feature_map,
                       hidden_ratio=cfg.kitnet_hidden_ratio)
    engine = RoundEngine(model, cfg, data, n_real=n_real, rngs=rngs,
                         model_type=model_type, update_type=update_type,
                         states=states, profile=profile,
                         fused=cfg.fused_rounds,
                         poison_fn=None if attack is None
                         else make_poison_fn(attack),
                         chaos=chaos, elastic=elastic, cluster=cluster,
                         mesh=mesh)
    round_times: List[float] = []
    all_tracking: List[np.ndarray] = []  # every round's [n_real, E, 3]
    results = []

    tag = f"{model_type}_{update_type}_run{run}"
    start_round = 0
    # a snapshot resumes only under the membership timeline and the
    # clustering it was written with (the generations are recomputed from
    # the spec, the states were merged under the assignment); the port has
    # no flattened optimizer, the JAX package's default
    elastic_sig = None if elastic is None else elastic.signature()
    cluster_sig = None if cluster is None else cluster.signature()
    clustered = cluster is not None and not cluster.is_null
    expected = {"flatten_optimizer": False, "elastic": elastic_sig,
                "cluster": cluster_sig}
    defaults = {"flatten_optimizer": False, "elastic": None,
                "cluster": None}

    def snapshot(rounds_done: int) -> None:
        gen = engine.generation_at(rounds_done)
        extra = {**expected,
                 "elastic_generation": None if gen is None else gen.tolist(),
                 "rngs": engine.rngs.state_dict()}
        if clustered and engine.cluster_assignment is not None:
            # the assignment the states were merged under, the JAX keys
            extra.update(
                cluster_k=cluster.k,
                cluster_assignment=engine.cluster_assignment.tolist(),
                cluster_fitted_round=engine.cluster_fitted_round)
        # a meshed run's snapshot is the gathered dense one, rank 0's
        states = engine.gathered_states() if sharded else engine.states
        if not sharded or mesh.rank == 0:
            resume.save(tag, states, engine.host, rounds_done,
                        layout=engine.layout, extra=extra,
                        tracking=(np.concatenate(all_tracking, axis=1)
                                  if all_tracking else None))
        if sharded:
            mesh.barrier()

    if resume is not None and resume.exists(tag):
        if clustered:
            # a K change fails by name before the states are read
            saved = resume.extra(tag)
            vec = assignment_from_extra(saved, cluster, n_real)
            if vec is not None:
                engine.set_cluster_assignment(
                    vec, saved.get("cluster_fitted_round", 0))
        engine.states, engine.host, start_round, tracking = resume.restore(
            tag, layout=engine.layout, device="cpu" if sharded else device,
            expected_extra=expected, extra_defaults=defaults)
        if sharded:
            from fedmse_tpu_torch.federation.state import \
                shard_client_states
            engine.states = shard_client_states(engine.states, mesh)
        saved_rngs = resume.extra(tag).get("rngs")
        if saved_rngs is not None:  # a snapshot the JAX package wrote has none
            engine.rngs.load_state_dict(saved_rngs)
        if tracking is not None:
            all_tracking.append(tracking)
        logger.info("resumed %s at round %d", tag, start_round)

    def bookkeep(result, sec: float) -> bool:
        """Per-round logging and artifacts; True when early stop fires."""
        round_times.append(sec)
        all_tracking.append(result.tracking)
        results.append(result)
        if on_round is not None:
            on_round(result, sec)
        logger.info("[%s/%s run %d] round %d: agg=%s mean %s=%.4f (%.2fs)",
                    model_type, update_type, run, result.round_index + 1,
                    result.aggregator, cfg.metric,
                    float(np.nanmean(result.client_metrics)), sec)
        if writer is not None:
            writer.append_round_metrics(run, result.round_index,
                                        result.client_metrics, model_type,
                                        update_type)
            writer.append_verification(run, result.round_index,
                                       result.verification_results)
        stop = early_stop is not None and early_stop.should_stop(
            result.client_metrics)
        if sharded:  # rank 0's decision: a rank that differs deadlocks
            stop = uniform_decision(stop, mesh)
        if stop:
            logger.info("Early stopping in global round!")
        return stop

    use_schedule = (cfg.fused_schedule and engine.fused
                    and not engine.profile)
    if use_schedule and cfg.fused_schedule_chunk < 1:
        raise ValueError(f"fused_schedule_chunk must be >= 1, got "
                         f"{cfg.fused_schedule_chunk}")
    pipeline = None
    if use_schedule:
        def consume(chunk_results, sec):
            for j, result in enumerate(chunk_results):
                if bookkeep(result, sec):
                    return j
            return None

        pipeline = run_pipelined_schedule(
            engine, start_round, cfg.num_rounds, cfg.fused_schedule_chunk,
            consume, can_rewind=early_stop is not None,
            pipelined=cfg.fused_pipeline and resume is None,
            on_chunk=None if resume is None else snapshot).summary()
    else:
        for round_index in range(start_round, cfg.num_rounds):
            t0 = time.perf_counter()
            result = engine.run_round(round_index)
            fired = bookkeep(result, time.perf_counter() - t0)
            if resume is not None:
                snapshot(round_index + 1)
            if fired:
                break

    final_metrics, final_full = split_metric_columns(engine.evaluate())
    if elastic is not None:
        # a retired slot's params belong to a departed tenant: NaN
        member = engine.members_at(results[-1].round_index + 1 if results
                                   else start_round)
        final_metrics = np.where(member, final_metrics, np.nan)
        if final_full is not None:
            final_full = np.where(member[:, None], final_full, np.nan)
    params = engine.states.params
    if sharded and save_checkpoints and device_names:
        # every rank gathers (a collective); the rank with a writer writes
        params = engine.gathered_states().params.to(device)
    if writer is not None and save_checkpoints and device_names:
        n = n_real
        tree = engine.layout.saved_tree(params[:n], engine.states.stats[:n])
        save_client_models(writer, run, model_type, update_type,
                           device_names, tree)
        if all_tracking:
            save_training_tracking(writer, run, model_type, update_type,
                                   device_names,
                                   np.concatenate(all_tracking, axis=1))
        if model_type == "hybrid":
            _save_hybrid_latents(writer, engine, run, update_type,
                                 params=params if sharded else None,
                                 data=data if sharded else None)
    out = {
        "final_metrics": final_metrics,
        "best_final": float(np.nanmax(final_metrics)),
        "round_times": round_times,
        "rounds_run": len(round_times),
        "aggregation_count": engine.host.aggregation_count.tolist(),
        "votes_received": engine.host.votes_received.tolist(),
        "aggregation_backend_effective": engine.agg_backend,
        "rounds": results,
        "engine": engine,
        # the chunk loop's telemetry (None off the fused schedule)
        "pipeline": pipeline,
    }
    if final_full is not None:
        out["final_metrics_full"] = final_full
    return out


def run_batched_combination(cfg: ExperimentConfig, data, n_real: int,
                            model_type: str, update_type: str,
                            writer: Optional[ResultsWriter] = None,
                            device_names: Optional[List[str]] = None,
                            save_checkpoints: bool = False,
                            attack: Optional[AttackSpec] = None,
                            chaos: Optional[ChaosSpec] = None,
                            elastic: Optional[ElasticSpec] = None
                            ) -> List[Dict]:
    """All `cfg.num_runs` seeds of one (model_type, update_type) as one
    batched federation (federation/batched.py), with per run the
    artifacts the sequential driver writes: round JSON lines,
    verification rows, client models, training_tracking.pkl and the
    hybrid's latents. Global early stopping runs per run on the host, as
    the sequential loop checks it, and reaches the round as a freeze mask
    (pipeline.run_pipelined_batched). Its state is per run: the
    reference's shared-state quirk cannot couple runs that run at once.
    Returns one result dict per run, shaped like run_combination's."""
    runs = cfg.num_runs
    model = make_model(model_type, cfg.dim_features, cfg.hidden_neus,
                       cfg.latent_dim, cfg.shrink_lambda,
                       precision=cfg.precision, device=data.train_xb.device)
    engine = BatchedRunEngine(
        model, cfg, data, n_real=n_real, runs=runs, model_type=model_type,
        update_type=update_type,
        poison_fn=None if attack is None else make_poison_fn(attack),
        chaos=chaos, elastic=elastic)
    early = [GlobalEarlyStop(inverted=cfg.compat.inverted_global_early_stop,
                             patience=cfg.global_patience)
             for _ in range(runs)]
    round_times: List[List[float]] = [[] for _ in range(runs)]
    all_tracking: List[List[np.ndarray]] = [[] for _ in range(runs)]
    results: List[list] = [[] for _ in range(runs)]

    def consume(outs, schedule, start_round, k, sec, active):
        """Each run's rounds up to its stop, in the sequential driver's
        order; returns each run's stop position in the chunk, or None."""
        stop_pos: List[Optional[int]] = [None] * runs
        for i in range(k):
            for r in range(runs):
                if not active[r] or stop_pos[r] is not None:
                    continue  # a stopped run's rounds reach no record
                result = engine.process_round(r, start_round + i,
                                              schedule[i][r], outs, i)
                round_times[r].append(sec)
                all_tracking[r].append(result.tracking)
                results[r].append(result)
                logger.info(
                    "[%s/%s run %d] round %d: agg=%s mean %s=%.4f (%.2fs)",
                    model_type, update_type, r, result.round_index + 1,
                    result.aggregator, cfg.metric,
                    float(np.nanmean(result.client_metrics)), sec)
                if writer is not None:
                    writer.append_round_metrics(r, result.round_index,
                                                result.client_metrics,
                                                model_type, update_type)
                    writer.append_verification(r, result.round_index,
                                               result.verification_results)
                if early[r].should_stop(result.client_metrics):
                    logger.info("Early stopping in global round!")
                    stop_pos[r] = i
        return stop_pos

    if cfg.fused_schedule_chunk < 1:
        raise ValueError(f"fused_schedule_chunk must be >= 1, got "
                         f"{cfg.fused_schedule_chunk}")
    pipeline = run_pipelined_batched(
        engine, cfg.num_rounds, cfg.fused_schedule_chunk, consume,
        pipelined=cfg.fused_pipeline).summary()
    finals = engine.evaluate_final()
    outs: List[Dict] = []
    for r in range(runs):
        final_metrics, final_full = split_metric_columns(finals[r])
        if elastic is not None:
            member = engine.members_at(len(round_times[r]), r)
            final_metrics = np.where(member, final_metrics, np.nan)
            if final_full is not None:
                final_full = np.where(member[:, None], final_full, np.nan)
        params = engine.run_params(r)
        if writer is not None and save_checkpoints and device_names:
            save_client_models(writer, r, model_type, update_type,
                               device_names,
                               engine.layout.tree(params[:n_real]))
            if all_tracking[r]:
                save_training_tracking(writer, r, model_type, update_type,
                                       device_names,
                                       np.concatenate(all_tracking[r],
                                                      axis=1))
            if model_type == "hybrid":
                _save_hybrid_latents(writer, engine, r, update_type,
                                     params=params)
        out = {
            "final_metrics": final_metrics,
            "best_final": float(np.nanmax(final_metrics)),
            "round_times": round_times[r],
            "rounds_run": len(round_times[r]),
            "aggregation_count": engine.host[r].aggregation_count.tolist(),
            "votes_received": engine.host[r].votes_received.tolist(),
            "aggregation_backend_effective": "einsum",
            "rounds": results[r],
            "engine": engine,
            "pipeline": pipeline,
        }
        if final_full is not None:
            out["final_metrics_full"] = final_full
        outs.append(out)
    return outs


def batch_runs_refusals(cfg: ExperimentConfig, resume_dir: Optional[str],
                        cluster: Optional[ClusterSpec],
                        mesh: Optional[ClientMesh] = None) -> List[str]:
    """Why --batch-runs cannot batch this sweep (empty: it can), in the
    JAX driver's words."""
    reasons = []
    if mesh is not None:
        reasons.append("--use-mesh (client axis is device-sharded)")
    if resume_dir:
        reasons.append("--resume-dir (per-chunk resume is per-run)")
    if cfg.metric == "time":
        reasons.append("metric='time' (host-side wall clock)")
    if not (cfg.fused_rounds and cfg.fused_schedule):
        reasons.append("fused_rounds/fused_schedule disabled")
    if cfg.state_layout == "tiered":
        reasons.append("state_layout=tiered (runs-axis batching is "
                       "dense-layout only)")
    if cluster is not None and not cluster.is_null:
        reasons.append("--cluster-k (per-run assignment fits are "
                       "sequential-driver only)")
    return reasons


def check_layout(cfg: ExperimentConfig) -> None:
    """The state layout's settings, before any file is read."""
    if cfg.state_layout not in ("dense", "tiered"):
        raise ValueError(f"unknown state_layout {cfg.state_layout!r} "
                         "(dense | tiered)")
    if cfg.host_sharded and cfg.state_layout != "tiered":
        raise ValueError("--host-sharded shards the tier: it needs "
                         "--state-layout tiered")


def run_experiment(cfg: ExperimentConfig, dataset: DatasetConfig,
                   save_checkpoints: bool = True, *,
                   device: DeviceLike = "cuda", serve: bool = False,
                   serve_rows: int = 2048, serve_warmup: bool = False,
                   serve_continuous: bool = False,
                   resume_dir: Optional[str] = None,
                   attack: Optional[AttackSpec] = None,
                   chaos: Optional[ChaosSpec] = None,
                   elastic: Optional[ElasticSpec] = None,
                   cluster: Optional[ClusterSpec] = None,
                   batch_runs: bool = False, flywheel: bool = False,
                   serve_net: bool = False, use_mesh: bool = False) -> Dict:
    """The full sweep -> training summary dict. `batch_runs` runs each
    combination's seeds as one batched federation where the sweep allows
    it (batch_runs_refusals), else sequentially with a warning.
    `serve=True` appends the
    serving pass on the first combination's checkpoint (its report under
    "serve_smoke"); it needs the checkpoints, so under
    save_checkpoints=False it is skipped with a warning. `flywheel=True`
    appends the closed-loop pass (flywheel/harness.py) on the same
    checkpoint, its report under "flywheel_smoke" (skipped the same way
    without checkpoints), and `serve_net=True` the network plane's pass
    (net/smoke.py), its report under "net_smoke". `resume_dir`
    snapshots every combination there and resumes from it; the fault
    specs and the clustering go to every combination and into the
    summary. `use_mesh` shards the client axis over the ranks of the
    process group when there is more than one (parallel/; the serving
    passes then run on rank 0 only)."""
    dev = resolve_device(device)
    check_layout(cfg)
    if "kitnet" in cfg.model_types:
        kitnet.check_supported(
            cfg, batch_runs=batch_runs, use_mesh=use_mesh,
            serving=serve or flywheel or serve_net,
            resume=resume_dir is not None)
    mesh = None
    if use_mesh:
        mesh = client_mesh(device=dev if dev.type == "cpu" else None)
        if not mesh.sharded:
            mesh = None  # world 1: the plain run
        else:
            dev = mesh.device
    lead = mesh is None or mesh.rank == 0
    tiered = cfg.state_layout == "tiered"
    resume = CheckpointManager(resume_dir) if resume_dir else None
    if resume is not None and cfg.fused_pipeline and cfg.fused_rounds \
            and cfg.fused_schedule and not tiered:
        logger.warning(
            "--resume-dir disables fused_pipeline: per-chunk checkpoints "
            "need a non-speculative state at every chunk boundary, so the "
            "schedule runs the serial chunk loop (pass --no-pipeline to "
            "silence this, or drop --resume-dir to keep the pipelined "
            "executor)")
    # the tiered layout keeps the fleet's data on the host
    clients, data, n_real = prepare_federation(
        cfg, dataset, device="cpu" if tiered or mesh is not None else dev)
    if mesh is not None and not tiered:
        n_old = data.client_mask.shape[0]
        n_new = pad_to_multiple(n_old, mesh.world_size)
        if n_new != n_old:
            logger.info("padding client axis %d -> %d (+%d zero-weight pad "
                        "clients) to tile the %d-rank mesh", n_old, n_new,
                        n_new - n_old, mesh.world_size)
            data = pad_federated_data(data, n_new)
    device_names = [c.name for c in clients]
    writer = ResultsWriter(cfg.checkpoint_dir, cfg.network_size,
                           cfg.experiment_name, cfg.scen_name, cfg.metric,
                           cfg.num_participants) if lead else None
    early_stop = GlobalEarlyStop(
        inverted=cfg.compat.inverted_global_early_stop,
        patience=cfg.global_patience)
    if batch_runs:
        reasons = batch_runs_refusals(cfg, resume_dir, cluster, mesh)
        if reasons:
            logger.warning("--batch-runs disabled (%s); running runs "
                           "sequentially", "; ".join(reasons))
            batch_runs = False
        elif cfg.compat.global_early_stop_state_shared:
            logger.warning(
                "--batch-runs: global early-stop state is per run — the "
                "reference's shared-state quirk "
                "(compat.global_early_stop_state_shared) cannot couple runs "
                "that execute simultaneously; sequential mode remains the "
                "oracle for that quirk")
    best_metrics = {mt: {ut: float("-inf") for ut in cfg.update_types}
                    for mt in cfg.model_types}
    all_results = {}
    for model_type in cfg.model_types:
        for update_type in cfg.update_types:
            if batch_runs:
                run_outs = run_batched_combination(
                    cfg, data, n_real, model_type, update_type,
                    writer=writer, device_names=device_names,
                    save_checkpoints=save_checkpoints, attack=attack,
                    chaos=chaos, elastic=elastic)
                for run, out in enumerate(run_outs):
                    best_metrics[model_type][update_type] = max(
                        best_metrics[model_type][update_type],
                        out["best_final"])
                    all_results[f"{model_type}/{update_type}/run{run}"] = {
                        "final_metrics": out["final_metrics"].tolist(),
                        "round_times": out["round_times"],
                        "aggregation_backend_effective":
                            out["aggregation_backend_effective"],
                    }
                continue
            for run in range(cfg.num_runs):
                if not cfg.compat.global_early_stop_state_shared:
                    early_stop.reset()
                out = run_combination(
                    cfg, data, n_real, model_type, update_type, run,
                    writer=writer, early_stop=early_stop,
                    device_names=device_names,
                    save_checkpoints=save_checkpoints, resume=resume,
                    attack=attack, chaos=chaos, elastic=elastic,
                    cluster=cluster, device=dev, mesh=mesh)
                best_metrics[model_type][update_type] = max(
                    best_metrics[model_type][update_type], out["best_final"])
                all_results[f"{model_type}/{update_type}/run{run}"] = {
                    "final_metrics": out["final_metrics"].tolist(),
                    "round_times": out["round_times"],
                    "aggregation_backend_effective":
                        out["aggregation_backend_effective"],
                }
    summary_path = None
    if writer is not None:
        summary_path = writer.write_summary(best_metrics, cfg.num_runs,
                                            results=all_results)
        logger.info("Saved training summary to %s", summary_path)
    out = {"best_metrics": best_metrics, "results": all_results,
           "summary_path": summary_path}
    for name, spec in (("attack", attack), ("chaos", chaos),
                       ("elastic", elastic), ("cluster", cluster)):
        if spec is not None:
            out[name] = dataclasses.asdict(spec)
    if not lead and (serve or flywheel or serve_net):
        logger.info("the serving passes run on rank 0")
        serve = flywheel = serve_net = False
    if (serve or flywheel or serve_net) \
            and data.train_xb.device.type != dev.type:
        data = FederatedData(**{f.name: getattr(data, f.name).to(dev)
                                for f in dataclasses.fields(FederatedData)})
    if serve:
        if not save_checkpoints:
            logger.warning("--serve needs the checkpointed ClientModel tree"
                           " (run without --no-save); skipping the serving"
                           " pass")
        else:
            out["serve_smoke"] = run_serve_smoke(
                cfg, data, n_real, writer, device_names,
                model_type=cfg.model_types[0],
                update_type=cfg.update_types[0], run=0,
                max_rows=serve_rows, max_batch=cfg.serve_max_batch,
                max_wait_ms=cfg.serve_latency_budget_ms,
                warmup=serve_warmup, continuous=serve_continuous)
    if flywheel:
        if not save_checkpoints:
            logger.warning("--flywheel needs the checkpointed ClientModel "
                           "tree (run without --no-save); skipping the "
                           "closed-loop pass")
        else:
            out["flywheel_smoke"] = run_flywheel_smoke(
                cfg, data, n_real, writer, device_names,
                model_type=cfg.model_types[0],
                update_type=cfg.update_types[0], run=0,
                max_rows=serve_rows)
    if serve_net:
        if not save_checkpoints:
            logger.warning("--serve-net needs the checkpointed ClientModel "
                           "tree (run without --no-save); skipping the "
                           "network-plane pass")
        else:
            out["net_smoke"] = run_net_smoke(
                cfg, data, n_real, writer, device_names,
                model_type=cfg.model_types[0],
                update_type=cfg.update_types[0], run=0,
                max_rows=serve_rows)
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="FedMSE training sweep on the PyTorch + CUDA port",
        epilog="--model-types takes hybrid, autoencoder and kitnet "
               "(Kitsune's KitNET: needs --scaler minmax; its ensemble "
               "by --kitnet-max-ae and --kitnet-hidden-ratio)")
    p.add_argument("--dataset-config", required=True,
                   help="reference-format dataset JSON")
    p.add_argument("--data-root", default=None,
                   help="root replacing the JSON's relative data_path")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; the CUDA kernels) or cpu (their "
                        "plain PyTorch versions)")
    p.add_argument("--use-mesh", action="store_true",
                   help="shard the client axis over the ranks of the "
                        "launch (torchrun; one card each) when there is "
                        "more than one")
    p.add_argument("--no-save", action="store_true",
                   help="skip the per-client model and tracking artifacts")
    p.add_argument("--no-pipeline", action="store_true",
                   help="run the fused schedule's serial chunk loop "
                        "(dispatch, harvest, bookkeep, then the next "
                        "chunk) instead of the pipelined one")
    p.add_argument("--paper-scale", action="store_true",
                   help="epochs=100 rounds=20 lr=1e-5 lambda=10")
    p.add_argument("--serve", action="store_true",
                   help="after the sweep, serve the first combination's "
                        "checkpoint: build (and, for --score-kind knn, "
                        "persist) its scoring state, calibrate per-gateway "
                        "thresholds on validation normals, stream test "
                        "traffic through the bucketed scorer, report "
                        "latency, verdicts and drift")
    p.add_argument("--serve-rows", type=int, default=2048,
                   help="max test rows streamed by the --serve (and the "
                        "--serve-net) pass")
    p.add_argument("--serve-net", action="store_true",
                   help="after the sweep, run the network plane's pass "
                        "(net/): --net-replicas engine replicas behind the "
                        "roster-aware router and tiered admission, served "
                        "over a localhost TCP socket (--net-port; 0 = "
                        "ephemeral) in NIC-poll bursts, with a mid-stream "
                        "hot swap broadcast to every replica")
    p.add_argument("--serve-warmup", action="store_true",
                   help="score one bucket of every rung before the served "
                        "stream; the seconds land in the report")
    p.add_argument("--serve-continuous", action="store_true",
                   help="stream the --serve pass through the "
                        "continuous-batching front (double-buffered "
                        "dispatch, adaptive bucket pick) instead of the "
                        "micro-batcher")
    p.add_argument("--flywheel", action="store_true",
                   help="after the sweep, run the closed-loop flywheel "
                        "pass on the first combination's checkpoint: the "
                        "continuous front with the fresh-data reservoir "
                        "tap and the controller, a gradually drifting "
                        "stream, the drift-triggered federated fine-tune "
                        "and the zero-downtime hot swap (stale vs adapted "
                        "AUC, ticket integrity, swap events)")
    p.add_argument("--batch-runs", action="store_true",
                   help="run all num_runs seeds of each combination as one "
                        "batched federation (federation/batched.py); the "
                        "per-run artifacts are the sequential driver's")
    p.add_argument("--resume-dir", default=None,
                   help="snapshot every combination here after each chunk "
                        "(or round) and resume from the snapshot when one "
                        "exists; runs the serial chunk loop")
    p.add_argument("--attack-kind", default=None,
                   choices=("scale", "noise", "sign_flip", "zero"),
                   help="a malicious aggregator tampers with the broadcast "
                        "(federation/attack.py)")
    p.add_argument("--attack-strength", type=float, default=10.0)
    p.add_argument("--attack-every-k", type=int, default=1,
                   help="attack every k-th round from --attack-start")
    p.add_argument("--attack-start", type=int, default=1,
                   help="first attacked round (default 1: round 0 builds "
                        "the verification history)")
    p.add_argument("--attack-stop", type=int, default=None,
                   help="first round NOT attacked (default: none)")
    p.add_argument("--chaos-dropout", type=float, default=0.0,
                   help="per-client per-round dropout probability (never "
                        "trains, casts no vote, misses the broadcast)")
    p.add_argument("--chaos-straggler", type=float, default=0.0,
                   help="per-client per-round straggler probability (its "
                        "update misses the deadline)")
    p.add_argument("--chaos-crash", type=float, default=0.0,
                   help="per-round probability the ELECTED aggregator "
                        "crashes; the others re-elect on the device")
    p.add_argument("--chaos-broadcast-loss", type=float, default=0.0,
                   help="per-client probability of missing the broadcast")
    p.add_argument("--chaos-start", type=int, default=0,
                   help="first chaotic round")
    p.add_argument("--chaos-stop", type=int, default=None,
                   help="first round chaos stops (default: never)")
    p.add_argument("--elastic-leave", type=float, default=0.0,
                   help="per-slot per-round probability an occupied slot's "
                        "tenant leaves")
    p.add_argument("--elastic-join", type=float, default=0.0,
                   help="per-slot per-round probability a retired slot is "
                        "recycled by a joining tenant")
    p.add_argument("--elastic-preempt", type=float, default=0.0,
                   help="per-slot per-round probability an occupied slot is "
                        "preempted (a leave and a join in one round)")
    p.add_argument("--elastic-start", type=int, default=0,
                   help="first round membership may change")
    p.add_argument("--elastic-stop", type=int, default=None,
                   help="first round membership freezes again (default: "
                        "never)")
    p.add_argument("--elastic-initial-members", type=float, default=1.0,
                   help="fraction of slots occupied at round 0")
    p.add_argument("--cluster-k", type=int, default=0,
                   help="number of cluster-level global models (0/1 = the "
                        "single-global federation; > 1 builds the masked "
                        "per-cluster merge into the fused round)")
    p.add_argument("--cluster-personalize", action="store_true",
                   help="layer-mask personalization: the encoder is "
                        "federated (per cluster, or globally at k<=1), "
                        "each gateway's decoder stays local; the broadcast "
                        "a client verifies and loads is cluster-encoder + "
                        "own-decoder")
    p.add_argument("--cluster-refit-every", type=int, default=0,
                   help="assignment refit cadence in rounds (0 = fit once "
                        "at round 0; the fused schedule refits at a "
                        "chunk's entry)")
    add_cli_overrides(p)
    return p


def fault_specs(args, cfg: ExperimentConfig):
    """(cfg with the fault tags in its experiment name, attack, chaos,
    elastic) from the parsed flags. A nonzero probability (not "> 0")
    turns a spec on, so a negative typo reaches its validation."""
    attack = chaos = elastic = None
    name = cfg.experiment_name
    if args.attack_kind:
        attack = AttackSpec(kind=args.attack_kind,
                            strength=args.attack_strength,
                            every_k=args.attack_every_k,
                            start_round=args.attack_start,
                            stop_round=args.attack_stop)
        name += (f"_attack-{attack.kind}-{attack.strength:g}"
                 f"-k{attack.every_k}s{attack.start_round}"
                 + ("" if attack.stop_round is None
                    else f"e{attack.stop_round}"))
    if any(p != 0 for p in (args.chaos_dropout, args.chaos_straggler,
                            args.chaos_crash, args.chaos_broadcast_loss)):
        chaos = ChaosSpec(dropout_p=args.chaos_dropout,
                          straggler_p=args.chaos_straggler,
                          crash_p=args.chaos_crash,
                          broadcast_loss_p=args.chaos_broadcast_loss,
                          start_round=args.chaos_start,
                          stop_round=args.chaos_stop)
        name += (f"_chaos-d{chaos.dropout_p:g}g{chaos.straggler_p:g}"
                 f"c{chaos.crash_p:g}b{chaos.broadcast_loss_p:g}"
                 f"s{chaos.start_round}"
                 + ("" if chaos.stop_round is None
                    else f"e{chaos.stop_round}"))
    if any(p != 0 for p in (args.elastic_leave, args.elastic_join,
                            args.elastic_preempt)) \
            or args.elastic_initial_members != 1.0:
        elastic = ElasticSpec(
            leave_p=args.elastic_leave, join_p=args.elastic_join,
            preempt_p=args.elastic_preempt, start_round=args.elastic_start,
            stop_round=args.elastic_stop,
            initial_member_frac=args.elastic_initial_members)
        name += (f"_elastic-l{elastic.leave_p:g}j{elastic.join_p:g}"
                 f"p{elastic.preempt_p:g}s{elastic.start_round}"
                 + ("" if elastic.stop_round is None
                    else f"e{elastic.stop_round}"))
    return cfg.replace(experiment_name=name), attack, chaos, elastic


def cluster_spec(args, cfg: ExperimentConfig):
    """(cfg with the clustering's tag in its experiment name, ClusterSpec
    or None) from the parsed flags, as the JAX driver makes them."""
    if args.cluster_k <= 1 and not args.cluster_personalize:
        return cfg, None
    cluster = ClusterSpec(k=max(1, args.cluster_k),
                          personalize=args.cluster_personalize,
                          refit_every=args.cluster_refit_every)
    return cfg.replace(experiment_name=(
        f"{cfg.experiment_name}_cluster-{cluster.signature()}")), cluster


def main(argv: Optional[List[str]] = None) -> Dict:
    args = build_parser().parse_args(argv)
    # join a launch of many ranks before any other CUDA use (no launch
    # configured: the process stays alone)
    initialize_multihost(device=args.device)
    cfg = apply_cli_overrides(ExperimentConfig(), args)
    if args.no_pipeline:
        cfg = cfg.replace(fused_pipeline=False)
    if args.paper_scale:
        cfg = paper_scale(cfg)
    # the specs validate before any file is read
    cfg, attack, chaos, elastic = fault_specs(args, cfg)
    cfg, cluster = cluster_spec(args, cfg)
    check_layout(cfg)
    dataset = DatasetConfig.from_json(args.dataset_config, args.data_root)
    return run_experiment(cfg, dataset, save_checkpoints=not args.no_save,
                          device=args.device, serve=args.serve,
                          serve_rows=args.serve_rows,
                          serve_warmup=args.serve_warmup,
                          serve_continuous=args.serve_continuous,
                          resume_dir=args.resume_dir, attack=attack,
                          chaos=chaos, elastic=elastic, cluster=cluster,
                          batch_runs=args.batch_runs,
                          flywheel=args.flywheel,
                          serve_net=args.serve_net,
                          use_mesh=args.use_mesh)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()

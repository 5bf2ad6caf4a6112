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

  * `--serve` then runs the serving pass (serving/smoke.py) on the first
    combination's checkpoint.

CLI (runs on the card unless --device cpu):
    python -m fedmse_tpu_torch.main --dataset-config <reference json>
        [--data-root DIR] [--device cpu] [--no-save] [--paper-scale]
        [--num-rounds 20] [--epochs 100] [--score-kind knn] [--no-pipeline]
        [--serve [--serve-rows N] [--serve-warmup] [--serve-continuous]] ...
Not ported: resume (--resume-dir), meshes, batched runs, the network and
flywheel smokes, attacks, chaos, elastic membership and clustering.
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

from fedmse_tpu_torch.checkpointing import (ResultsWriter, save_client_models,
                                            save_latent_data,
                                            save_training_tracking)
from fedmse_tpu_torch.config import (DatasetConfig, ExperimentConfig,
                                     add_cli_overrides, apply_cli_overrides,
                                     paper_scale)
from fedmse_tpu_torch.data import (build_dev_dataset, prepare_clients,
                                   stack_clients)
from fedmse_tpu_torch.device import DeviceLike, resolve_device
from fedmse_tpu_torch.evaluation.evaluator import client_index
from fedmse_tpu_torch.federation import (ClientStates, RoundEngine,
                                         split_metric_columns)
from fedmse_tpu_torch.federation.pipeline import run_pipelined_schedule
from fedmse_tpu_torch.models import make_model
from fedmse_tpu_torch.ops.fused_ae import fused_forward_stats
from fedmse_tpu_torch.ops.precision import get_policy
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
def _save_hybrid_latents(writer: ResultsWriter, engine: RoundEngine,
                         run: int, update_type: str) -> None:
    """The hybrid's test latents and labels of every real client."""
    d, n = engine.data, engine.n_real
    cdt = engine.model.compute_dtype
    t = d.test_x.shape[1]
    latent, _, _ = fused_forward_stats(
        engine.layout.tree(engine.states.params[:n], cdt),
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
                    on_round=None) -> Dict:
    """One (model_type, update_type, run): the reference round loop, the
    final evaluation and the artifacts. Runs where `data` lives. `states`
    replaces the port's own init (a JAX-exported init, say); `profile`
    times each round's phases (RoundResult.phase_seconds) on the
    per-phase path; `on_round(result, seconds)` sees every round."""
    rngs = ExperimentRngs(run=run, data_seed=cfg.data_seed,
                          run_seed_stride=cfg.run_seed_stride)
    device = data.train_xb.device
    model = make_model(model_type, cfg.dim_features, cfg.hidden_neus,
                       cfg.latent_dim, cfg.shrink_lambda,
                       precision=cfg.precision, device=device)
    engine = RoundEngine(model, cfg, data, n_real=n_real, rngs=rngs,
                         model_type=model_type, update_type=update_type,
                         states=states, profile=profile,
                         fused=cfg.fused_rounds)
    round_times: List[float] = []
    all_tracking: List[np.ndarray] = []  # every round's [n_real, E, 3]
    results = []

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
        if early_stop is not None and early_stop.should_stop(
                result.client_metrics):
            logger.info("Early stopping in global round!")
            return True
        return False

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
            engine, 0, cfg.num_rounds, cfg.fused_schedule_chunk, consume,
            can_rewind=early_stop is not None,
            pipelined=cfg.fused_pipeline).summary()
    else:
        for round_index in range(cfg.num_rounds):
            t0 = time.perf_counter()
            result = engine.run_round(round_index)
            if bookkeep(result, time.perf_counter() - t0):
                break

    final_metrics, final_full = split_metric_columns(engine.evaluate())
    if writer is not None and save_checkpoints and device_names:
        n = n_real
        save_client_models(writer, run, model_type, update_type,
                           device_names,
                           engine.layout.tree(engine.states.params[:n]))
        if all_tracking:
            save_training_tracking(writer, run, model_type, update_type,
                                   device_names,
                                   np.concatenate(all_tracking, axis=1))
        if model_type == "hybrid":
            _save_hybrid_latents(writer, engine, run, update_type)
    out = {
        "final_metrics": final_metrics,
        "best_final": float(np.nanmax(final_metrics)),
        "round_times": round_times,
        "rounds_run": len(round_times),
        "aggregation_count": engine.host.aggregation_count.tolist(),
        "votes_received": engine.host.votes_received.tolist(),
        # the merge is the dense weighted mean, the JAX package's 'einsum'
        "aggregation_backend_effective": "einsum",
        "rounds": results,
        "engine": engine,
        # the chunk loop's telemetry (None off the fused schedule)
        "pipeline": pipeline,
    }
    if final_full is not None:
        out["final_metrics_full"] = final_full
    return out


def run_experiment(cfg: ExperimentConfig, dataset: DatasetConfig,
                   save_checkpoints: bool = True, *,
                   device: DeviceLike = "cuda", serve: bool = False,
                   serve_rows: int = 2048, serve_warmup: bool = False,
                   serve_continuous: bool = False) -> Dict:
    """The full sweep -> training summary dict. `serve=True` appends the
    serving pass on the first combination's checkpoint (its report under
    "serve_smoke"); it needs the checkpoints, so under
    save_checkpoints=False it is skipped with a warning."""
    dev = resolve_device(device)
    clients, data, n_real = prepare_federation(cfg, dataset, device=dev)
    device_names = [c.name for c in clients]
    writer = ResultsWriter(cfg.checkpoint_dir, cfg.network_size,
                           cfg.experiment_name, cfg.scen_name, cfg.metric,
                           cfg.num_participants)
    early_stop = GlobalEarlyStop(
        inverted=cfg.compat.inverted_global_early_stop,
        patience=cfg.global_patience)
    best_metrics = {mt: {ut: float("-inf") for ut in cfg.update_types}
                    for mt in cfg.model_types}
    all_results = {}
    for model_type in cfg.model_types:
        for update_type in cfg.update_types:
            for run in range(cfg.num_runs):
                if not cfg.compat.global_early_stop_state_shared:
                    early_stop.reset()
                out = run_combination(
                    cfg, data, n_real, model_type, update_type, run,
                    writer=writer, early_stop=early_stop,
                    device_names=device_names,
                    save_checkpoints=save_checkpoints)
                best_metrics[model_type][update_type] = max(
                    best_metrics[model_type][update_type], out["best_final"])
                all_results[f"{model_type}/{update_type}/run{run}"] = {
                    "final_metrics": out["final_metrics"].tolist(),
                    "round_times": out["round_times"],
                    "aggregation_backend_effective":
                        out["aggregation_backend_effective"],
                }
    summary_path = writer.write_summary(best_metrics, cfg.num_runs,
                                        results=all_results)
    logger.info("Saved training summary to %s", summary_path)
    out = {"best_metrics": best_metrics, "results": all_results,
           "summary_path": summary_path}
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
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="FedMSE training sweep on the PyTorch + CUDA port")
    p.add_argument("--dataset-config", required=True,
                   help="reference-format dataset JSON")
    p.add_argument("--data-root", default=None,
                   help="root replacing the JSON's relative data_path")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; the CUDA kernels) or cpu (their "
                        "plain PyTorch versions)")
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
                   help="max test rows streamed by the --serve pass")
    p.add_argument("--serve-warmup", action="store_true",
                   help="score one bucket of every rung before the served "
                        "stream; the seconds land in the report")
    p.add_argument("--serve-continuous", action="store_true",
                   help="stream the --serve pass through the "
                        "continuous-batching front (double-buffered "
                        "dispatch, adaptive bucket pick) instead of the "
                        "micro-batcher")
    add_cli_overrides(p)
    return p


def main(argv: Optional[List[str]] = None) -> Dict:
    args = build_parser().parse_args(argv)
    cfg = apply_cli_overrides(ExperimentConfig(), args)
    if args.no_pipeline:
        cfg = cfg.replace(fused_pipeline=False)
    if args.paper_scale:
        cfg = paper_scale(cfg)
    dataset = DatasetConfig.from_json(args.dataset_config, args.data_root)
    return run_experiment(cfg, dataset, save_checkpoints=not args.no_save,
                          device=args.device, serve=args.serve,
                          serve_rows=args.serve_rows,
                          serve_warmup=args.serve_warmup,
                          serve_continuous=args.serve_continuous)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()

"""Typed configuration: the port's own copy of the fields of
fedmse_tpu/config.py that the training, scoring and serving paths read.

  * `DatasetConfig` reads the reference's JSON layout ({data_path,
    devices_list: [{id, name, normal_data_path, abnormal_data_path,
    test_normal_data_path}]}).
  * `CompatConfig` holds the switches for the reference's accidental but
    load-bearing behaviours; the defaults reproduce them.
  * `ExperimentConfig` defaults are the reference's quick-run values;
    `paper_scale` gives the paper's schedule.
  * `add_cli_overrides` / `apply_cli_overrides` turn every scalar field
    into a --flag and every compat switch into --compat-<name>.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """One gateway's data locations."""

    id: int
    name: str
    normal_data_path: str
    abnormal_data_path: str
    test_normal_data_path: str


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    """The reference's dataset JSON (e.g. scen2-nba-iot-10clients.json)."""

    data_path: str
    devices_list: Tuple[DeviceSpec, ...]

    @staticmethod
    def from_json(path: str, data_root: Optional[str] = None
                  ) -> "DatasetConfig":
        """Load a reference-format JSON file; `data_root`, if given,
        replaces the directory of its relative `data_path`."""
        with open(path, "r") as f:
            raw = json.load(f)
        data_path = raw["data_path"]
        if data_root is not None:
            data_path = os.path.join(data_root,
                                     os.path.basename(data_path.rstrip("/")))
        devices = tuple(
            DeviceSpec(id=int(d["id"]), name=str(d["name"]),
                       normal_data_path=str(d["normal_data_path"]),
                       abnormal_data_path=str(d["abnormal_data_path"]),
                       test_normal_data_path=str(d["test_normal_data_path"]))
            for d in raw["devices_list"])
        return DatasetConfig(data_path=data_path, devices_list=devices)

    def to_json(self) -> Dict[str, Any]:
        return {"data_path": self.data_path,
                "devices_list": [dataclasses.asdict(d)
                                 for d in self.devices_list]}

    @staticmethod
    def for_client_dirs(data_path: str, n_clients: int,
                        name_prefix: str = "Client") -> "DatasetConfig":
        """The standard shard layout
        `<data_path>/Client-k/{normal,abnormal,test_normal}`."""
        return DatasetConfig(data_path=data_path, devices_list=tuple(
            DeviceSpec(id=k, name=f"{name_prefix}-{k}",
                       normal_data_path=f"Client-{k}/normal",
                       abnormal_data_path=f"Client-{k}/abnormal",
                       test_normal_data_path=f"Client-{k}/test_normal")
            for k in range(1, n_clients + 1)))


@dataclasses.dataclass(frozen=True)
class CompatConfig:
    """Switches for the reference's accidental behaviours (defaults
    reproduce them; False gives the fixed behaviour)."""

    # every client verifies on the LAST client's valid split (quirk 6)
    shared_last_client_val: bool = True
    # global early stop treats AUC as a loss: improvement = min < best
    inverted_global_early_stop: bool = True
    # the global early-stop state is never reset between combinations
    global_early_stop_state_shared: bool = True
    # the FINAL local weights, not the best-valid ones, enter aggregation
    no_best_restore: bool = True
    # the vote re-standardizes already-standardized rows (ddof=1, +1e-8)
    restandardize_vote_data: bool = True
    # each vote score times 1 + (U(0,1) - 0.5) * 2e-4
    vote_tie_break: bool = True


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    # federation schedule
    num_participants: float = 0.5
    epochs: int = 5
    num_rounds: int = 3
    network_size: int = 10
    # optimization (Adam)
    lr_rate: float = 1e-3
    batch_size: int = 12
    shrink_lambda: float = 5.0
    fedprox_mu: float = 0.001
    # local and global early stopping
    patience: int = 1
    global_patience: int = 1
    # sweep axes and model topology (the paper's width)
    model_types: Tuple[str, ...] = ("hybrid", "autoencoder")
    update_types: Tuple[str, ...] = ("avg", "fedprox", "mse_avg")
    dim_features: int = 115
    hidden_neus: int = 27
    latent_dim: int = 7
    # verification of the broadcast and the aggregation quota
    verification_method: str = "val"  # "val" | "dev"
    verification_threshold: float = 3.0
    performance_threshold: float = 0.002
    max_aggregation_threshold: int = 3
    max_rejected_updates: int = 3
    # deltas and the performance bar against each client's OWN model, no
    # free first contact (federation/verification.py)
    hardened_verification: bool = False
    # cumulative ceiling on the hardened verifier's recovery waiver
    recovery_budget: Optional[float] = None
    # runs and seeds
    num_runs: int = 1
    data_seed: int = 1234
    run_seed_stride: int = 10000
    # data handling: new-device normals in the test set, the scaler, the
    # train/valid/dev fractions of the normal rows (test gets the rest)
    new_device: bool = True
    scaler: str = "standard"
    split_fractions: Tuple[float, float, float] = (0.4, 0.1, 0.4)
    # 'AUC' | 'classification' | 'scores' | 'time' (evaluation/evaluator.py)
    metric: str = "AUC"
    scen_name: str = "FL-IoT"
    experiment_name: str = "fedmse-tpu"
    checkpoint_dir: str = "Checkpoint"
    # 'f32' (the pinned mode) or 'bf16' (ops/precision.py)
    precision: str = "f32"
    # train only the selected cohort (gather -> train -> scatter); False
    # trains every client and masks the unselected away; None = True
    compact_cohort: Optional[bool] = None
    # 'auto' (autoencoder -> mse, hybrid -> centroid) | 'mse' | 'centroid'
    # | 'knn': distance to the knn_k-th nearest neighbour in a per-gateway
    # bank of knn_bank_size normal train latents (knn/); knn_topk 'approx'
    # keeps each strided bin's minimum (exact whenever a gateway's valid
    # rows fit the bins), 'exact' is the blocked partial top-k. The JAX
    # package's defaults.
    score_kind: str = "auto"
    knn_bank_size: int = 512
    knn_k: int = 8
    knn_topk: str = "approx"
    # serving front: largest dispatch bucket and the micro-batcher's wait
    serve_max_batch: int = 256
    serve_latency_budget_ms: float = 2.0
    # the fused round (federation/fused.py): vote, aggregation,
    # verification and evaluation with no host read, local training in
    # epoch bodies; on the card each is a replayed CUDA graph. The same
    # math as the per-phase path (bitwise with compat.vote_tie_break off;
    # with it on, only the tie-break draws' bookkeeping differs)
    fused_rounds: bool = True
    # the driver runs the fused rounds in chunks of fused_schedule_chunk,
    # early stopping checked per round from the chunk's stacked outputs (a
    # mid-chunk stop restores the chunk-entry snapshot and replays the
    # prefix with the same selections and draws)
    fused_schedule: bool = True
    fused_schedule_chunk: int = 32
    # chunk k + 1 is enqueued before chunk k is harvested, the quota
    # carried on the device (federation/pipeline.py); --no-pipeline runs
    # the serial chunk loop
    fused_pipeline: bool = True

    compat: CompatConfig = dataclasses.field(default_factory=CompatConfig)

    def replace(self, **kw: Any) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(raw: Dict[str, Any]) -> "ExperimentConfig":
        """Build from a full JSON config (the JAX package's layout): the
        fields the port reads are taken, the rest are ignored."""
        names = {f.name for f in dataclasses.fields(ExperimentConfig)}
        kw = {k: v for k, v in raw.items() if k in names}
        if isinstance(kw.get("compat"), dict):
            compat = {f.name for f in dataclasses.fields(CompatConfig)}
            kw["compat"] = CompatConfig(**{k: v for k, v in
                                           kw["compat"].items()
                                           if k in compat})
        for key in ("model_types", "update_types", "split_fractions"):
            if isinstance(kw.get(key), list):
                kw[key] = tuple(kw[key])
        return ExperimentConfig(**kw)


def paper_scale(cfg: ExperimentConfig) -> ExperimentConfig:
    """The paper-scale schedule (reference README)."""
    return cfg.replace(epochs=100, num_rounds=20, lr_rate=1e-5,
                       shrink_lambda=10.0)


def _parse_bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes")


def _is_bool_field(f: dataclasses.Field) -> bool:
    return isinstance(f.default, bool) or (f.default is None
                                           and "bool" in str(f.type))


def add_cli_overrides(parser) -> None:
    """Register every scalar ExperimentConfig field as --<field-name> and
    every CompatConfig switch as --compat-<name>."""
    for f in dataclasses.fields(ExperimentConfig):
        name = "--" + f.name.replace("_", "-")
        if f.name == "compat":
            continue
        if _is_bool_field(f):
            parser.add_argument(name, type=_parse_bool, default=None)
        elif f.default is None and "float" in str(f.type):
            parser.add_argument(name, type=float, default=None)
        elif isinstance(f.default, (int, float, str)):
            parser.add_argument(name, type=type(f.default), default=None)
        elif isinstance(f.default, tuple) and isinstance(f.default[0], str):
            parser.add_argument(name, type=lambda s: tuple(s.split(",")),
                                default=None)
    for f in dataclasses.fields(CompatConfig):
        parser.add_argument("--compat-" + f.name.replace("_", "-"),
                            dest="compat_" + f.name, type=_parse_bool,
                            default=None)


def apply_cli_overrides(cfg: ExperimentConfig, args) -> ExperimentConfig:
    updates = {f.name: getattr(args, f.name)
               for f in dataclasses.fields(ExperimentConfig)
               if f.name != "compat" and getattr(args, f.name, None)
               is not None}
    compat = {f.name: getattr(args, "compat_" + f.name)
              for f in dataclasses.fields(CompatConfig)
              if getattr(args, "compat_" + f.name, None) is not None}
    if compat:
        updates["compat"] = dataclasses.replace(cfg.compat, **compat)
    return cfg.replace(**updates) if updates else cfg

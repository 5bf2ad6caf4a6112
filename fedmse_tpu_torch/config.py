"""Typed configuration: the port's own copy of the `ExperimentConfig`
fields the scoring and serving path reads (fedmse_tpu/config.py keeps the
full set). Defaults are the reference's quick-run values.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    # model topology (reference src/main.py:60-62)
    dim_features: int = 115
    hidden_neus: int = 27
    latent_dim: int = 7
    shrink_lambda: float = 5.0
    # minibatch rows of the stacked train/valid splits
    batch_size: int = 12
    # 'f32' (the pinned mode) or 'bf16' (ops/precision.py)
    precision: str = "f32"
    # 'AUC' | 'classification' | 'scores' (evaluation/evaluator.py)
    metric: str = "AUC"
    # 'auto' (autoencoder -> mse, hybrid -> centroid) | 'mse' | 'centroid'
    score_kind: str = "auto"
    # serving front: largest dispatch bucket and the micro-batcher's wait
    serve_max_batch: int = 256
    serve_latency_budget_ms: float = 2.0

    def replace(self, **kw: Any) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def from_json(raw: Dict[str, Any]) -> "ExperimentConfig":
        """Build from a full JSON config (the JAX package's layout): the
        fields this slice reads are taken, the rest are ignored."""
        names = {f.name for f in dataclasses.fields(ExperimentConfig)}
        return ExperimentConfig(**{k: v for k, v in raw.items() if k in names})

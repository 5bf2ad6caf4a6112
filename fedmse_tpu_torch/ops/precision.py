"""Mixed-precision policy: bf16 compute with f32 masters and f32 accumulation.

The port's copy of fedmse_tpu/ops/precision.py with torch dtypes:

  * param_dtype (f32 always): master weights, centroid statistics,
    checkpoints. bf16 is a compute format here, never a storage format for
    state that accumulates.
  * compute_dtype (f32 | bf16): the matmul operand dtype: input rows and
    layer weights as the fused kernel reads them, and the storage dtype of
    stacked feature tensors (data/stacking.py).
  * accum_dtype (f32 always): every dot, loss and score reduction
    accumulates in f32 whatever the operand dtype, because the scores
    decide verdicts and thresholds.

`cast_params` builds the compute copy of a parameter tree in the layout the
fused kernel takes: kernels in the compute dtype, biases in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Union

import torch


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """One experiment-wide dtype contract."""

    name: str
    param_dtype: torch.dtype
    compute_dtype: torch.dtype
    accum_dtype: torch.dtype


_POLICIES = {
    "f32": PrecisionPolicy("f32", torch.float32, torch.float32, torch.float32),
    "bf16": PrecisionPolicy("bf16", torch.float32, torch.bfloat16,
                            torch.float32),
}


def get_policy(precision: Union[str, PrecisionPolicy]) -> PrecisionPolicy:
    """Resolve a preset name (or pass a policy through)."""
    if isinstance(precision, PrecisionPolicy):
        return precision
    policy = _POLICIES.get(precision)
    if policy is None:
        raise ValueError(f"unknown precision {precision!r}; expected one of "
                         f"{sorted(_POLICIES)} or a PrecisionPolicy")
    return policy


def cast_params(tree: Any, compute_dtype: torch.dtype) -> Any:
    """A nested param dict with every `kernel` leaf in `compute_dtype` and
    every other leaf (the biases) in f32. Leaves already in the right dtype
    are returned as they are."""
    if isinstance(tree, dict):
        return {k: (v.to(compute_dtype) if k == "kernel"
                    and isinstance(v, torch.Tensor)
                    else cast_params(v, compute_dtype))
                for k, v in tree.items()}
    return tree.to(torch.float32)

"""Blockwise int8 codec of the quantized merge's cross-group exchange (port
of fedmse_tpu/parallel/quantize.py).

The merge's math stays f32: only the bytes that cross between host groups
are int8, dequantized before they are summed
(parallel/collectives.make_hierarchical_aggregate). The scheme, symmetric
with one f32 scale per block:

  * the leaf is flattened and cut into blocks of `block_size` elements, the
    tail zero-padded to a whole block;
  * block b's scale is s_b = max|x_b| / 127, or 1 for an all-zero block
    (never 0/0; its codes are zero either way);
  * the codes are round(x / s_b) clipped to [-127, 127] as int8.
    `torch.round` rounds half to even, as `jnp.round` does, so on the same
    f32 inputs the codes and the scales are the JAX package's, bit for bit;
  * decoding is q * s_b in f32, and accumulation is dequantize-then-sum in
    f32.

One pass errs by at most s_b / 2 = max|x_b| / 254 per element
(`quantization_error_bound`). A merge that quantizes H group partials errs
by at most the sum of their bounds: linear in groups, never in clients.

The clustered merge's [K, ...] partial sheet is coded row by row
(`quantize_blockwise_k`): a block never spans two cluster rows, so a hot
cluster's scale never widens a quiet cluster's step, and at K = 1 it is
`quantize_blockwise` of the single row.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

INT8_MAX = 127.0
# a step is amax / 127; the worst rounding error half a step: amax / 254
ERROR_DENOM = 2.0 * INT8_MAX


def quantize_blocks(blocks: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """blocks [..., B] f32 -> (codes int8 [..., B], scales f32 [...]): one
    symmetric scale per block; leading axes are batch."""
    amax = blocks.abs().amax(dim=-1)
    # a tensor divisor: CUDA divides by a Python scalar through its
    # reciprocal, which is not always the quotient's bits
    scales = torch.where(amax > 0, amax / torch.full_like(amax, INT8_MAX),
                         torch.ones_like(amax)).to(torch.float32)
    q = torch.clamp(torch.round(blocks / scales[..., None]),
                    -INT8_MAX, INT8_MAX).to(torch.int8)
    return q, scales


def dequantize_sum_blocks(q_stack: torch.Tensor, scale_stack: torch.Tensor
                          ) -> torch.Tensor:
    """(codes [H, ..., B] int8, scales [H, ...] f32) -> f32 [..., B]: every
    payload dequantized, then summed over the leading axis in f32, in
    order (a Python fold, so the order is the stack's on every device)."""
    deq = q_stack.to(torch.float32) * scale_stack[..., None]
    total = deq[0]
    for h in range(1, deq.shape[0]):
        total = total + deq[h]
    return total


def _blocked(flat: torch.Tensor, block_size: int) -> torch.Tensor:
    """[K, E] -> [K, nb, block_size], the tail of each row zero-padded."""
    pad = (-flat.shape[1]) % block_size
    flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(flat.shape[0], -1, block_size)


def quantize_blockwise(x: torch.Tensor, block_size: int = 256
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (any shape) -> (codes int8 [nb, block_size], scales f32 [nb])."""
    flat = x.to(torch.float32).reshape(1, -1)
    q, s = quantize_blocks(_blocked(flat, block_size))
    return q[0], s[0]


def quantize_blockwise_k(x: torch.Tensor, block_size: int = 256
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [K, ...] -> (codes int8 [K, nb, block_size], scales f32 [K, nb]):
    each row flattened, padded and scaled on its own."""
    flat = x.to(torch.float32).reshape(x.shape[0], -1)
    return quantize_blocks(_blocked(flat, block_size))


def _numel(shape: Sequence[int]) -> int:
    return int(np.prod(shape, dtype=np.int64))


def dequantize_blockwise(q: torch.Tensor, scales: torch.Tensor,
                         shape: Sequence[int]) -> torch.Tensor:
    """The inverse of `quantize_blockwise`, up to its rounding."""
    flat = q.to(torch.float32) * scales[:, None]
    return flat.reshape(-1)[:_numel(shape)].reshape(tuple(shape))


def dequantize_sum_k(q_stack: torch.Tensor, scale_stack: torch.Tensor,
                     shape: Sequence[int]) -> torch.Tensor:
    """H leading-K payloads ([H, K, nb, B] int8, [H, K, nb] f32) summed in
    f32 into [K, ...] = `shape`, each row's pad dropped."""
    total = dequantize_sum_blocks(q_stack, scale_stack)
    k = shape[0]
    return total.reshape(k, -1)[:, :_numel(shape[1:])].reshape(tuple(shape))


def quantization_error_bound(x, block_size: int = 256) -> float:
    """The worst absolute elementwise error of one pass over `x`:
    max_b max|x_b| / 254."""
    flat = np.asarray(x, dtype=np.float32).reshape(-1)
    flat = np.pad(flat, (0, (-flat.size) % block_size))
    amax = np.abs(flat.reshape(-1, block_size)).max(axis=1)
    return float(amax.max() / ERROR_DENOM) if amax.size else 0.0


def clustered_quantization_error_bound(x, block_size: int = 256
                                       ) -> np.ndarray:
    """[K] float64: row k's bound over its own blocks only."""
    arr = np.asarray(x, dtype=np.float32)
    k = arr.shape[0]
    flat = arr.reshape(k, -1)
    flat = np.pad(flat, ((0, 0), (0, (-flat.shape[1]) % block_size)))
    if flat.shape[1] == 0:
        return np.zeros(k, dtype=np.float64)
    amax = np.abs(flat.reshape(k, -1, block_size)).max(axis=2)
    return (amax.max(axis=1) / ERROR_DENOM).astype(np.float64)

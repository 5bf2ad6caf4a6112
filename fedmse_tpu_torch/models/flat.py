"""One client's parameters as one flat f32 row.

The training path keeps every client's parameters in one [N, P] f32
buffer, laid out leaf after leaf in flax's order and shapes:

    W1 [D, H], b1 [H], W2 [H, L], b2 [L], W3 [L, H], b3 [H], W4 [H, D], b4 [D]

(W1/b1 = encoder/Dense_0, W2/b2 = encoder/Dense_1, W3/b3 = decoder/Dense_0,
W4/b4 = decoder/Dense_1; every matrix row-major [in, out]). P = 6,764 at
the paper's 115/27/7. Adam, the proximal term, the verifier's Frobenius
deltas and the aggregation's weighted mean then each run as a few ops on
one tensor, and the fused train kernel (csrc/fused_train.cu) reads a
client's row as it is. `ParamLayout.tree` gives the stacked flax-named tree
the forward kernel and the checkpoint writer take.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

# (coder, dense) of W1..W4, in layout order
DENSES = (("encoder", "Dense_0"), ("encoder", "Dense_1"),
          ("decoder", "Dense_0"), ("decoder", "Dense_1"))


@dataclasses.dataclass(frozen=True)
class ParamLayout:
    """Offsets of each leaf in a flat parameter row of a D -> H -> L model."""

    dim: int
    hidden: int
    latent: int

    @staticmethod
    def of(model) -> "ParamLayout":
        return ParamLayout(model.input_dim, model.hidden_neus, model.latent_dim)

    def layer_shapes(self) -> List[Tuple[int, int]]:
        d, h, lat = self.dim, self.hidden, self.latent
        return [(d, h), (h, lat), (lat, h), (h, d)]

    def leaves(self) -> List[Tuple[Tuple[str, str, str], int, Tuple[int, ...]]]:
        """(path, offset, shape) of the eight leaves in layout order."""
        out, off = [], 0
        for (coder, dense), (fan_in, fan_out) in zip(DENSES,
                                                     self.layer_shapes()):
            out.append(((coder, dense, "kernel"), off, (fan_in, fan_out)))
            off += fan_in * fan_out
            out.append(((coder, dense, "bias"), off, (fan_out,)))
            off += fan_out
        return out

    @property
    def size(self) -> int:
        _, off, shape = self.leaves()[-1]
        return off + shape[0]

    def slices(self) -> List[slice]:
        """The column range of each leaf, in layout order."""
        return [slice(off, off + _numel(shape))
                for _, off, shape in self.leaves()]

    def flatten(self, tree: Dict[str, Any]) -> torch.Tensor:
        """[G, P] f32 from a stacked flax-layout tree (leaves [G, ...])."""
        parts = []
        for (coder, dense, leaf), _, shape in self.leaves():
            t = torch.as_tensor(tree[coder][dense][leaf])
            if tuple(t.shape[1:]) != shape:
                raise ValueError(f"{coder}/{dense}/{leaf} has shape "
                                 f"{tuple(t.shape)}, the layout [G, "
                                 f"{', '.join(map(str, shape))}]")
            parts.append(t.reshape(t.shape[0], -1).to(torch.float32))
        return torch.cat(parts, dim=1)

    def views(self, flat: torch.Tensor) -> Dict[str, Any]:
        """The stacked flax-layout tree of a [G, P] buffer as views into it
        (leaves [G, in, out] and [G, out]; writes go through)."""
        if flat.dim() != 2 or flat.shape[1] != self.size:
            raise ValueError(f"flat params must be [G, {self.size}], got "
                             f"{tuple(flat.shape)}")
        out: Dict[str, Any] = {}
        g = flat.shape[0]
        for (coder, dense, leaf), off, shape in self.leaves():
            out.setdefault(coder, {}).setdefault(dense, {})[leaf] = \
                flat[:, off:off + _numel(shape)].view((g,) + shape)
        return out

    def tree(self, flat: torch.Tensor,
             compute_dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
        """The same tree as contiguous tensors, kernels in `compute_dtype`
        and biases in f32: what the forward kernel takes
        (ops/precision.cast_params)."""
        return {coder: {dense: {
            leaf: t.to(compute_dtype if leaf == "kernel"
                       else torch.float32).contiguous()
            for leaf, t in layer.items()} for dense, layer in layers.items()}
            for coder, layers in self.views(flat).items()}


def _numel(shape: Tuple[int, ...]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n

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

The model gives the layout (`ParamLayout.of`): a model that carries its
own `param_layout` has that one. KitNET's (`KitnetLayout`,
models/kitnet.py) lays out its ensemble of tied-weight autoencoders, one
per cluster of the feature map, and then its output autoencoder, each as

    W [n, h], b [h] (hidden bias), c [n] (visible bias)

n the autoencoder's inputs and h = ceil(hidden_ratio n) its hidden units.
Its models also carry running statistics that are no parameter: the
min-max normalisation (lo, hi) of each ensemble member's RMSE, [2k] a
client beside its [P] row (`stats_width`). Its `tree` is an
ops/kitnet.KitnetParams, the kernels' operand.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, ClassVar, Dict, List, Optional, Tuple

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
    family: ClassVar[str] = "autoencoder"
    stats_width: ClassVar[int] = 0  # running statistics a client: none

    @staticmethod
    def of(model) -> "ParamLayout":
        """The model's own layout where it carries one (KitNET's), else the
        D -> H -> L autoencoder's."""
        own = getattr(model, "param_layout", None)
        if own is not None:
            return own
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
             compute_dtype: torch.dtype = torch.float32,
             stats: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """The same tree as contiguous tensors, kernels in `compute_dtype`
        and biases in f32: what the forward kernel takes
        (ops/precision.cast_params). `stats` is KitNET's (ignored)."""
        return {coder: {dense: {
            leaf: t.to(compute_dtype if leaf == "kernel"
                       else torch.float32).contiguous()
            for leaf, t in layer.items()} for dense, layer in layers.items()}
            for coder, layers in self.views(flat).items()}

    def saved_tree(self, flat: torch.Tensor,
                   stats: torch.Tensor) -> Dict[str, Any]:
        """What a checkpoint saves of the models flat [G, P] with their
        running statistics [G, 0] (none): `tree`."""
        return self.tree(flat)


@dataclasses.dataclass(frozen=True)
class KitnetLayout:
    """Offsets of each leaf in a flat row of a KitNET model (the module
    docstring): the ensemble autoencoders in map order, then the output
    autoencoder over their k RMSEs. `feature_map` partitions the D
    features into k clusters (each the inputs of one ensemble member, in
    the map's order)."""

    feature_map: Tuple[Tuple[int, ...], ...]
    hidden_ratio: float = 0.75
    family: ClassVar[str] = "kitnet"

    def __post_init__(self):
        flat = [f for cluster in self.feature_map for f in cluster]
        if not self.feature_map or any(not c for c in self.feature_map) \
                or sorted(flat) != list(range(len(flat))):
            raise ValueError("a KitNET feature map partitions the features "
                             "0 .. D - 1 into non-empty clusters")

    @property
    def dim(self) -> int:
        return sum(len(c) for c in self.feature_map)

    @property
    def k(self) -> int:
        return len(self.feature_map)

    def hidden(self, n: int) -> int:
        """Hidden units of an autoencoder of n inputs: ceil(ratio n)."""
        return max(1, int(math.ceil(self.hidden_ratio * n)))

    def autoencoders(self) -> List[Tuple[str, int, int]]:
        """(name, inputs, hidden units) of each autoencoder, layout order:
        the ensemble's, then the output one."""
        out = [(f"ensemble_{a}", len(c), self.hidden(len(c)))
               for a, c in enumerate(self.feature_map)]
        return out + [("output", self.k, self.hidden(self.k))]

    @property
    def stats_width(self) -> int:
        """Running statistics a client: lo [k] then hi [k]."""
        return 2 * self.k

    def leaves(self) -> List[Tuple[Tuple[str, str], int, Tuple[int, ...]]]:
        """(path, offset, shape) of every leaf in layout order."""
        out, off = [], 0
        for name, n, h in self.autoencoders():
            for leaf, shape in (("W", (n, h)), ("b", (h,)), ("c", (n,))):
                out.append(((name, leaf), off, shape))
                off += _numel(shape)
        return out

    @property
    def size(self) -> int:
        _, off, shape = self.leaves()[-1]
        return off + shape[0]

    def slices(self) -> List[slice]:
        return [slice(off, off + _numel(shape))
                for _, off, shape in self.leaves()]

    def views(self, flat: torch.Tensor) -> Dict[str, Any]:
        """{autoencoder: {"W", "b", "c"}} of a [G, P] buffer, as views."""
        if flat.dim() != 2 or flat.shape[1] != self.size:
            raise ValueError(f"flat params must be [G, {self.size}], got "
                             f"{tuple(flat.shape)}")
        out: Dict[str, Any] = {}
        g = flat.shape[0]
        for (name, leaf), off, shape in self.leaves():
            out.setdefault(name, {})[leaf] = \
                flat[:, off:off + _numel(shape)].view((g,) + shape)
        return out

    def flatten(self, tree: Dict[str, Any]) -> torch.Tensor:
        """[G, P] f32 from a stacked tree as `views` gives it."""
        return torch.cat([torch.as_tensor(tree[name][leaf]).reshape(
            len(tree[name][leaf]), -1).to(torch.float32)
            for (name, leaf), _, _ in self.leaves()], dim=1)

    def tree(self, flat: torch.Tensor,
             compute_dtype: torch.dtype = torch.float32,
             stats: Optional[torch.Tensor] = None):
        """The kernels' operand (ops/kitnet.KitnetParams): these params
        with their statistics."""
        from fedmse_tpu_torch.ops.kitnet import KitnetParams
        if compute_dtype != torch.float32:
            raise ValueError("KitNET computes in float32 only")
        if stats is None:
            raise ValueError("KitNET models are read with their running "
                             "statistics (stats [G, 2k])")
        return KitnetParams(flat, stats, self)

    def saved_tree(self, flat: torch.Tensor,
                   stats: torch.Tensor) -> Dict[str, Any]:
        """What a checkpoint saves: the autoencoders' leaves (`views`) and
        the running statistics [G, 2k] under norm/stats."""
        return dict(self.views(flat), norm={"stats": stats})


def _numel(shape: Tuple[int, ...]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n

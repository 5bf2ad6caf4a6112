"""Autoencoder models (port of fedmse_tpu/models/autoencoder.py).

Topology D -> hidden -> latent -> hidden -> D (115 -> 27 -> 7 -> 27 -> 115
at the paper's width), ReLU after each hidden layer. Parameters are STACKED
over a leading model axis and kept in flax's layout and names, so a JAX
param tree imports 1:1 (`params_from_numpy`):

    {"encoder": {"Dense_0": {"kernel": [G, D, H], "bias": [G, H]},
                 "Dense_1": {"kernel": [G, H, L], "bias": [G, L]}},
     "decoder": {"Dense_0": {"kernel": [G, L, H], "bias": [G, H]},
                 "Dense_1": {"kernel": [G, H, D], "bias": [G, D]}}}

The modules hold one such stack as nn.Parameters (`param_tree()` is the
dict view); the evaluator and the serving engine take param trees, with the
module supplying widths, the compute dtype and the loss. Own init is
U(+-1/sqrt(fan_in)) weights and zero biases, drawn from an explicit
torch.Generator (CPU, so the draw does not depend on the device).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from fedmse_tpu_torch.device import DeviceLike, resolve_device
from fedmse_tpu_torch.ops.fused_ae import forward_rows, model_groups, unpack_params
from fedmse_tpu_torch.ops.losses import mse_loss, shrink_loss
from fedmse_tpu_torch.ops.precision import (PrecisionPolicy, cast_params,
                                            get_policy)
from fedmse_tpu_torch.utils.seeding import stream_rng

ParamTree = Dict[str, Dict[str, Dict[str, torch.Tensor]]]


def _layer_dims(input_dim: int, hidden: int, latent: int):
    return {"encoder": ((input_dim, hidden), (hidden, latent)),
            "decoder": ((latent, hidden), (hidden, input_dim))}


def init_kernels(n_models: int, fan_in: int, fan_out: int,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """[n_models, fan_in, fan_out] U(+-1/sqrt(fan_in)) kernels on the CPU.
    The CPU generator draws element by element, so two calls of n and m
    models draw what one call of n + m does (the host tier's chunked init,
    federation/state.TieredClientStore.create). A whole tree is drawn
    layer by layer (`init_stacked_params`), so only its first layer has
    that prefix property: every later layer of model i moves with the
    model count, and the engines draw at the real client count only
    (federation/state.init_client_states)."""
    bound = 1.0 / fan_in ** 0.5
    return (torch.rand((n_models, fan_in, fan_out), generator=generator)
            * 2.0 - 1.0) * bound


def _init_tree(dims, n_models: int, generator: Optional[torch.Generator],
               device: torch.device) -> ParamTree:
    tree: ParamTree = {}
    for coder, layers in dims.items():
        tree[coder] = {}
        for i, (fan_in, fan_out) in enumerate(layers):
            kernel = init_kernels(n_models, fan_in, fan_out, generator)
            tree[coder][f"Dense_{i}"] = {
                "kernel": kernel.to(device),
                "bias": torch.zeros((n_models, fan_out), device=device)}
    return tree


class Dense(nn.Module):
    """One stacked layer in flax's layout: kernel [G, in, out], bias [G, out]."""

    def __init__(self, n_models: int, in_features: int, out_features: int,
                 device: torch.device):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(
            (n_models, in_features, out_features), device=device))
        self.bias = nn.Parameter(torch.zeros((n_models, out_features),
                                             device=device))


class Coder(nn.Module):
    """Dense(hidden) -> ReLU -> Dense(out), the encoder or the decoder."""

    def __init__(self, n_models: int, in_features: int, hidden: int,
                 out: int, device: torch.device):
        super().__init__()
        self.Dense_0 = Dense(n_models, in_features, hidden, device)
        self.Dense_1 = Dense(n_models, hidden, out, device)


class Autoencoder(nn.Module):
    """Plain AE: anomaly score = per-row reconstruction MSE; loss = MSE."""

    model_type = "autoencoder"

    def __init__(self, input_dim: int = 115, hidden_neus: int = 27,
                 latent_dim: int = 7, *, n_models: int = 1,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.input_dim = input_dim
        self.hidden_neus = hidden_neus
        self.latent_dim = latent_dim
        self.compute_dtype = compute_dtype
        self.encoder = Coder(n_models, input_dim, hidden_neus, latent_dim, dev)
        self.decoder = Coder(n_models, latent_dim, hidden_neus, input_dim, dev)
        self.load_param_tree(init_stacked_params(self, n_models, generator,
                                                 device=dev))

    def param_tree(self) -> ParamTree:
        """The module's parameters as a stacked flax-layout dict (views)."""
        return {coder: {name: {"kernel": layer.kernel, "bias": layer.bias}
                        for name, layer in getattr(self, coder).named_children()}
                for coder in ("encoder", "decoder")}

    @torch.no_grad()
    def load_param_tree(self, tree: ParamTree) -> None:
        own = self.param_tree()
        for coder, layers in own.items():
            for name, leaves in layers.items():
                for leaf, param in leaves.items():
                    param.copy_(torch.as_tensor(tree[coder][name][leaf]))

    def apply_params(self, params: ParamTree, x: torch.Tensor,
                     model_idx: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(latent [R, L], recon [R, D]) of rows x under stacked `params`,
        row r under model model_idx[r] (None: model 0). Plain PyTorch with
        f32 matmuls, activations rounded to the compute dtype between
        layers — the fused kernel's arithmetic, with the reconstruction
        kept (training needs it; scoring goes through the kernel)."""
        weights = unpack_params(cast_params(params, self.compute_dtype))
        rows = x.shape[0]
        if model_idx is None:
            return forward_rows(tuple(t[0] for t in weights), x,
                                self.compute_dtype)
        latent = x.new_full((rows, self.latent_dim), float("nan"),
                            dtype=torch.float32)
        recon = x.new_full((rows, self.input_dim), float("nan"),
                           dtype=torch.float32)
        for m, sel in model_groups(model_idx, weights[0].shape[0], rows):
            z, r = forward_rows(tuple(t[m] for t in weights), x[sel],
                                self.compute_dtype)
            latent[sel], recon[sel] = z, r
        return latent, recon

    def forward(self, x: torch.Tensor,
                model_idx: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.apply_params(self.param_tree(), x, model_idx)

    def loss(self, x, latent, recon, mask=None) -> torch.Tensor:
        return mse_loss(x, recon, mask)


class ShrinkAutoencoder(Autoencoder):
    """Shrink AE: the latent-norm penalty pulls normal traffic toward the
    latent origin, which the centroid classifier then scores by distance."""

    model_type = "hybrid"

    def __init__(self, input_dim: int = 115, hidden_neus: int = 27,
                 latent_dim: int = 7, shrink_lambda: float = 10.0, **kw):
        super().__init__(input_dim, hidden_neus, latent_dim, **kw)
        self.shrink_lambda = shrink_lambda

    def loss(self, x, latent, recon, mask=None) -> torch.Tensor:
        return shrink_loss(x, recon, latent, self.shrink_lambda, mask)


def make_model(model_type: str, dim_features: int, hidden_neus: int = 27,
               latent_dim: int = 7, shrink_lambda: float = 10.0,
               precision: Union[str, PrecisionPolicy] = "f32", *,
               n_models: int = 1, generator: Optional[torch.Generator] = None,
               device: DeviceLike = "cuda",
               feature_map=None, hidden_ratio: float = 0.75) -> Autoencoder:
    """'hybrid' -> ShrinkAutoencoder, 'autoencoder' -> Autoencoder,
    'kitnet' -> models/kitnet.Kitnet of `feature_map` (the federation's,
    models/kitnet.federated_feature_map) and `hidden_ratio`; `precision`
    picks the compute dtype, params stay f32."""
    if model_type == "kitnet":
        from fedmse_tpu_torch.models.kitnet import Kitnet
        if feature_map is None:
            raise ValueError("model_type 'kitnet' needs the federation's "
                             "feature map (models/kitnet."
                             "federated_feature_map)")
        return Kitnet(feature_map, hidden_ratio,
                      compute_dtype=get_policy(precision).compute_dtype)
    kw = dict(n_models=n_models, generator=generator, device=device,
              compute_dtype=get_policy(precision).compute_dtype)
    if model_type == "hybrid":
        return ShrinkAutoencoder(dim_features, hidden_neus, latent_dim,
                                 shrink_lambda, **kw)
    if model_type == "autoencoder":
        return Autoencoder(dim_features, hidden_neus, latent_dim, **kw)
    raise ValueError(f"unknown model_type {model_type!r}")


def init_stacked_params(model: Autoencoder, n_clients: int,
                        generator: Optional[torch.Generator] = None, *,
                        device: DeviceLike = "cuda") -> ParamTree:
    """Independent per-client f32 inits stacked [n_clients, ...]:
    U(+-1/sqrt(fan_in)) kernels, zero biases, from `generator` (a CPU
    torch.Generator; None uses torch's default generator)."""
    return _init_tree(_layer_dims(model.input_dim, model.hidden_neus,
                                  model.latent_dim),
                      n_clients, generator, resolve_device(device))


def init_pad_params(model: Autoencoder, ids, key, *,
                    device: DeviceLike = "cuda") -> ParamTree:
    """The init of pad clients `ids` (absolute client ids) stacked
    [len(ids), ...]: U(+-1/sqrt(fan_in)) kernels, zero biases, like a real
    client's, but pad client i draws from the stream `key`
    (ExperimentRngs.init_pad_key) at id i only (utils/seeding.stream_rng),
    never from the run's generator: padding the client axis draws nothing
    that a real client's init or tie-break would draw. The rows are finite
    and not degenerate, as the verifier's deltas and every row-wide
    reduction read them."""
    dev = resolve_device(device)
    dims = _layer_dims(model.input_dim, model.hidden_neus, model.latent_dim)
    rngs = [stream_rng(key, i) for i in ids]
    tree: ParamTree = {}
    for coder, layers in dims.items():
        tree[coder] = {}
        for i, (fan_in, fan_out) in enumerate(layers):
            bound = np.float32(1.0 / fan_in ** 0.5)
            kernel = np.stack(
                [(r.random((fan_in, fan_out), dtype=np.float32) * 2 - 1)
                 * bound for r in rngs])
            tree[coder][f"Dense_{i}"] = {
                "kernel": torch.from_numpy(kernel).to(dev),
                "bias": torch.zeros((len(rngs), fan_out), device=dev)}
    return tree


def params_from_numpy(tree: Dict[str, Any], device: DeviceLike = "cuda",
                      dtype: torch.dtype = torch.float32) -> ParamTree:
    """The JAX package's params (a nested dict of numpy arrays, one
    client's [in, out] or stacked [G, in, out]; tensors are taken as well)
    as the port's stacked tree on `device`: kernels in `dtype`, biases in
    f32 (ops/precision.cast_params). A tensor already on `device` in its
    target dtype is taken as it is (no copy): a tree placed once installs
    as the same tensors (a hot swap's executor-side placement)."""
    dev = resolve_device(device)

    def convert(t):
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(np.array(t, dtype=np.float32))
        if t.dtype in (torch.float32, dtype):
            return t.detach().to(device=dev)
        return t.detach().to(device=dev, dtype=torch.float32)

    out: ParamTree = {}
    for coder in ("encoder", "decoder"):
        out[coder] = {}
        for name in ("Dense_0", "Dense_1"):
            kernel = convert(tree[coder][name]["kernel"])
            bias = convert(tree[coder][name]["bias"])
            if kernel.dim() == 2:
                kernel, bias = kernel[None], bias[None]
            out[coder][name] = {"kernel": kernel, "bias": bias}
    return cast_params(out, dtype)

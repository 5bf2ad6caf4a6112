"""Fused autoencoder forward: per-row latent, reconstruction MSE and latent
norm in one kernel launch.

`fused_forward_stats` is the port of fedmse_tpu/ops/pallas_ae.py
`fused_forward_stats`, whose TPU kernel `_kernel` becomes the hand-written
CUDA kernel csrc/fused_ae.cu (its header states the kernel's bound and
design). Differences from the TPU entry, all of layout and none of math:

  * params are the STACKED flax-layout tree (`W* [G, in, out]` in the
    compute dtype, biases `[G, out]` in f32; ops/precision.cast_params
    builds it) and `model_idx` [R] int32 picks each row's model, so the
    evaluator's [N, T] rows, the serving engine's routed bucket and the
    single-global engine (model_idx=None: every row uses model 0) are one
    launch each. The serving engine's `routing="dense"` resolves to this
    same launch: per-row weight fetches make the N-fold dense formulation
    unnecessary.
  * outputs come back unpacked, (latent [R, L], mse [R], znorm [R]), all
    f32; no feature, hidden or latent padding is needed.

`fused_forward_stats_plain` is the same function in plain PyTorch (bf16
emulated as bf16 operands upcast to f32, f32 matmuls, activations rounded
to bf16 between layers: the `_fused_xla` contract, under which bf16 x bf16
products are exact in f32). The wrapper takes it only for tensors on the
CPU; a CUDA tensor launches the kernel or raises. `fused_forward_stats.launches`
counts kernel launches (`.captured` the kernels a CUDA graph recorded).
`encode_rows` is the one launch that encodes every gateway's rows under
its own model (kNN banks, centroid fits).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch

from fedmse_tpu_torch.ops import native
from fedmse_tpu_torch.ops.precision import cast_params

MAX_WIDTH = 128  # D, H <= 128 and L + 2 <= 128: at least what the TPU entry takes
MIN_TILE, MAX_TILE = 8, 64  # rows per tile of the kernel (tile_plan)
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
_LAYERS = (("encoder", "Dense_0"), ("encoder", "Dense_1"),
           ("decoder", "Dense_0"), ("decoder", "Dense_1"))

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def unpack_params(params: Dict[str, Any]) -> Tuple[torch.Tensor, ...]:
    """(W1, b1, W2, b2, W3, b3, W4, b4) of a stacked flax-layout tree."""
    out = []
    for coder, dense in _LAYERS:
        layer = params[coder][dense]
        out += [layer["kernel"], layer["bias"]]
    return tuple(out)


def _check(params: Dict[str, Any], x: torch.Tensor,
           model_idx: Optional[torch.Tensor],
           compute_dtype: torch.dtype) -> Tuple[int, int, int, int]:
    """Validate what the kernel takes; returns (G, D, H, L)."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{compute_dtype}")
    w1, b1, w2, b2, w3, b3, w4, b4 = unpack_params(params)
    if x.dim() != 2:
        raise ValueError(f"x must be [rows, D], got shape {tuple(x.shape)}")
    if w1.dim() != 3:
        raise ValueError("params must be stacked [G, in, out] (flax layout); "
                         f"encoder/Dense_0/kernel has shape {tuple(w1.shape)}")
    g, d, h = w1.shape
    lat = w2.shape[-1]
    if x.shape[1] != d:
        raise ValueError(f"x has {x.shape[1]} features, the model {d}")
    if d > MAX_WIDTH or h > MAX_WIDTH or lat + 2 > MAX_WIDTH:
        raise ValueError(
            f"fused AE kernel takes dim, hidden <= {MAX_WIDTH} and "
            f"latent_dim + 2 <= {MAX_WIDTH}; got dim={d}, hidden={h}, "
            f"latent_dim={lat}")
    want = {"W1": (w1, (g, d, h)), "b1": (b1, (g, h)),
            "W2": (w2, (g, h, lat)), "b2": (b2, (g, lat)),
            "W3": (w3, (g, lat, h)), "b3": (b3, (g, h)),
            "W4": (w4, (g, h, d)), "b4": (b4, (g, d))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        dtype = compute_dtype if name.startswith("W") else torch.float32
        if t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype}, the kernel takes {dtype} "
                             "(ops/precision.cast_params)")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype != compute_dtype:
        raise ValueError(f"x is {x.dtype}, compute_dtype is {compute_dtype}")
    if model_idx is not None:
        if model_idx.dtype != torch.int32 or tuple(model_idx.shape) != (x.shape[0],):
            raise ValueError("model_idx must be int32 [rows], got "
                             f"{model_idx.dtype} {tuple(model_idx.shape)}")
        if model_idx.device != x.device:
            raise ValueError(f"model_idx is on {model_idx.device}, x on "
                             f"{x.device}")
    return g, d, h, lat


def forward_rows(w: Tuple[torch.Tensor, ...], x: torch.Tensor,
                 compute_dtype: torch.dtype
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(latent, recon) of ONE model's weights (W1, b1, ..., W4, b4) over
    rows x, in plain PyTorch with f32 matmuls; activations round to the
    compute dtype between layers (identity in f32)."""
    f32 = torch.float32
    w1, b1, w2, b2, w3, b3, w4, b4 = w

    def cast(t):
        return t.to(compute_dtype).to(f32)

    h1 = cast(torch.relu(x.to(f32) @ w1.to(f32) + b1))
    z = h1 @ w2.to(f32) + b2
    h2 = cast(torch.relu(cast(z) @ w3.to(f32) + b3))
    return z, h2 @ w4.to(f32) + b4


def model_groups(model_idx: Optional[torch.Tensor], n_models: int,
                 rows: int) -> List[Tuple[int, Optional[torch.Tensor]]]:
    """(model, row indices) for each model present in `model_idx` within
    [0, n_models); None stands for all rows of model 0."""
    if model_idx is None:
        return [(0, None)] if rows else []
    return [(m, torch.nonzero(model_idx == m).squeeze(1))
            for m in torch.unique(model_idx).tolist() if 0 <= m < n_models]


def _forward_one(w: Tuple[torch.Tensor, ...], x: torch.Tensor,
                 compute_dtype: torch.dtype) -> Stats:
    z, recon = forward_rows(w, x, compute_dtype)
    mse = torch.square(x.to(torch.float32) - recon).sum(dim=-1) / x.shape[1]
    znorm = torch.sqrt(torch.square(z).sum(dim=-1))
    return z, mse, znorm


def fused_forward_stats_plain(params: Dict[str, Any], x: torch.Tensor,
                              model_idx: Optional[torch.Tensor] = None, *,
                              compute_dtype: torch.dtype = torch.float32
                              ) -> Stats:
    """The kernel's function in plain PyTorch: one group of matmuls per
    model present in `model_idx`. Rows whose model index lies outside
    [0, G) get NaN, as in the kernel. On a CUDA tensor it requires TF32 off
    (torch.backends.cuda.matmul.allow_tf32 = False), or the f32 comparison
    with the kernel would mean nothing."""
    g, _, _, lat = _check(params, x, model_idx, compute_dtype)
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain fused forward on the card needs "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    rows = x.shape[0]
    latent = torch.full((rows, lat), float("nan"), device=x.device)
    mse = torch.full((rows,), float("nan"), device=x.device)
    znorm = torch.full((rows,), float("nan"), device=x.device)
    weights = unpack_params(params)
    for m, sel in model_groups(model_idx, g, rows):
        w = tuple(t[m] for t in weights)
        stats = _forward_one(w, x if sel is None else x[sel], compute_dtype)
        for out, val in zip((latent, mse, znorm), stats):
            if sel is None:
                out.copy_(val)
            else:
                out[sel] = val
    return latent, mse, znorm


def tile_plan(rows: int, sms: int) -> Tuple[int, int]:
    """(rows per tile, CTAs) of one launch over `rows` rows on a card of
    `sms` SMs, from R alone (the kernel reads the model indices and picks
    each tile's path itself). Tiles halve from 64 rows down to 8 until the
    launch has at least one per SM, so a serving bucket spreads over tens of
    CTAs while an evaluation keeps 64-row tiles, whose staged weights serve
    the most rows; at most two CTAs per SM (the f32 path's shared memory at
    64-row tiles), each walking a contiguous run of tiles (mostly of one
    model), so a CTA stages a model's weights once for all of them."""
    tile = MAX_TILE
    while tile > MIN_TILE and -(-rows // tile) < sms:
        tile //= 2
    return tile, max(1, min(-(-rows // tile), 2 * sms))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _library() -> ctypes.CDLL:
    lib = native.load("fused_ae")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_ae_forward.argtypes = ([ptr] * 13 + [ctypes.c_longlong]
                                     + [i32] * 8 + [ptr])
    lib.fused_ae_forward.restype = i32
    lib.fused_ae_error_string.argtypes = [i32]
    lib.fused_ae_error_string.restype = ctypes.c_char_p
    return lib


def fused_forward_stats(params: Dict[str, Any], x: torch.Tensor,
                        model_idx: Optional[torch.Tensor] = None, *,
                        compute_dtype: torch.dtype = torch.float32) -> Stats:
    """(latent [R, L], mse [R], znorm [R]), all f32, in one fused pass.

    params: stacked flax-layout tree, W* [G, in, out] in `compute_dtype`,
    biases [G, out] f32. x: [R, D] in `compute_dtype`. model_idx: int32 [R]
    (None: every row uses model 0); a row whose index lies outside [0, G)
    gets NaN. Raises ValueError on shapes the kernel does not take (D, H >
    128 or L + 2 > 128), wrong dtypes, mixed devices or, on the card,
    non-contiguous tensors. CPU tensors run `fused_forward_stats_plain`;
    CUDA tensors launch csrc/fused_ae.cu once, on their device's current
    stream, over the tiles of `tile_plan`. R = 0 returns empty tensors
    without a launch."""
    g, d, h, lat = _check(params, x, model_idx, compute_dtype)
    if x.device.type == "cpu":
        return fused_forward_stats_plain(params, x, model_idx,
                                         compute_dtype=compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused forward runs on cuda or cpu, got {x.device}")
    rows = x.shape[0]
    latent = torch.empty((rows, lat), dtype=torch.float32, device=x.device)
    mse = torch.empty((rows,), dtype=torch.float32, device=x.device)
    znorm = torch.empty((rows,), dtype=torch.float32, device=x.device)
    if rows == 0:
        return latent, mse, znorm
    weights = unpack_params(params)
    operands = (x,) + ((model_idx,) if model_idx is not None else ()) + weights
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("the fused AE kernel takes contiguous tensors")
    lib = _library()
    index = x.device.index
    tile, ctas = tile_plan(rows, _sm_count(index))
    # the device's current stream in one C call, with no device context
    # entered around the launch (the C entry sets the device if it must)
    rc = lib.fused_ae_forward(
        x.data_ptr(), None if model_idx is None else model_idx.data_ptr(),
        *(t.data_ptr() for t in weights),
        latent.data_ptr(), mse.data_ptr(), znorm.data_ptr(),
        rows, g, d, h, lat, tile, ctas, int(compute_dtype == torch.bfloat16),
        index, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError("fused_ae_forward launch failed: "
                           + lib.fused_ae_error_string(rc).decode())
    native.count_launch(fused_forward_stats)
    return latent, mse, znorm


fused_forward_stats.launches = 0
fused_forward_stats.captured = 0


def client_index(n: int, rows_each: int, device) -> torch.Tensor:
    """The model index of n clients' rows laid out client-major (elementwise
    on the device: no host read, so a CUDA graph can capture it)."""
    return torch.div(torch.arange(n * rows_each, dtype=torch.int32,
                                  device=device), max(rows_each, 1),
                     rounding_mode="floor")


@torch.no_grad()
def encode_rows(model, stacked_params: Dict[str, Any], rows) -> torch.Tensor:
    """Each gateway's rows (batch-major [N, NB, B, D] or flat [N, S, D];
    numpy or tensors) under its own params, in ONE fused launch on the
    params' device -> latents [N, S, L] f32."""
    cdt = model.compute_dtype
    params = cast_params(stacked_params, cdt)
    dev = params["encoder"]["Dense_0"]["kernel"].device
    x = torch.as_tensor(rows).to(dev)
    n, d = x.shape[0], x.shape[-1]
    x = x.reshape(n, -1, d)
    s = x.shape[1]
    latent, _, _ = fused_forward_stats(params, x.reshape(n * s, d).to(cdt),
                                       client_index(n, s, dev),
                                       compute_dtype=cdt)
    return latent.view(n, s, -1)

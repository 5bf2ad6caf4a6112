"""Fused autoencoder train step: loss and every parameter gradient of a
whole cohort's batch in one kernel launch.

`fused_train_grads` is the port of fedmse_tpu/ops/pallas_ae.py
`fused_train_grads`, whose TPU kernel `_train_kernel` becomes the
hand-written CUDA kernel csrc/fused_train.cu (its header states the
kernel's bound and design). The function is exactly the TPU entry's:

    loss = masked_mean(per_sample_mse(x, recon), m)
         + shrink_lambda * masked_mean(safe_norm(z), m)

and its gradient, hand-derived. Differences from the TPU entry, all of
layout and none of math:

  * params are a FLAT [G, P] f32 buffer, one row per client
    (models/flat.ParamLayout), and one call covers G clients: x is
    [G, R, D] in the compute dtype and may be a strided view (the batch
    `cohort_xb[:, b]` of a [G, NB, B, D] tensor needs no copy), mask is
    [G, R] f32. Returns loss [G] and grads [G, P], both f32;
  * no 128-lane packing: the kernel runs at the model's own widths.

The kernel normalizes in its epilogue: it scales the loss partials and
the gradient of the loss times sum(m) by 1 / sum(m) with the reference's
FLUSHED floor (ops/losses.py), so a client whose mask is all zero gets NaN
loss and NaN grads, as the reference gives under XLA. One call on a CUDA
tensor is one launch of one kernel and nothing after it; `cluster_size`
picks the CTAs per client.

`fused_train_grads_plain` is the same function in plain PyTorch with
explicit backward matmuls (the `_fused_train_xla` contract) and the same
bf16 rounding points. The wrapper takes it only for tensors on the CPU; a
CUDA tensor launches the kernel or raises. `fused_train_grads.launches`
counts kernel launches. `FusedTrainLoss` is the port of
`make_fused_train_loss`: a torch.autograd.Function whose backward returns
the kernel's gradients.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from fedmse_tpu_torch.models.flat import ParamLayout
from fedmse_tpu_torch.ops import native
from fedmse_tpu_torch.ops.losses import safe_div

COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
_ERR_TOO_WIDE = 1000  # kErrTooWide in csrc/fused_train.cu
_SMS = 132  # streaming multiprocessors of an H100 SXM
_MAX_CLUSTER = 8  # the portable thread-block cluster size


def cluster_size(clients: int, hidden: int) -> int:
    """CTAs per client of the train kernel: each owns a slice of the
    `hidden` units, so at most min(8, hidden); as many as spread `clients`
    clusters over the card's SMs without a second wave, and 1 once the
    clients alone fill it."""
    return max(1, min(_MAX_CLUSTER, hidden, _SMS // max(clients, 1)))


def _check(params_flat: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
           layout: ParamLayout, compute_dtype: torch.dtype) -> None:
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{compute_dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be [G, R, D], got shape {tuple(x.shape)}")
    g, r, d = x.shape
    if d != layout.dim:
        raise ValueError(f"x has {d} features, the layout {layout.dim}")
    if tuple(params_flat.shape) != (g, layout.size):
        raise ValueError(f"params_flat must be [{g}, {layout.size}], got "
                         f"{tuple(params_flat.shape)}")
    if tuple(mask.shape) != (g, r):
        raise ValueError(f"mask must be [{g}, {r}], got {tuple(mask.shape)}")
    if params_flat.dtype != torch.float32 or mask.dtype != torch.float32:
        raise ValueError("params_flat and mask must be float32")
    if x.dtype != compute_dtype:
        raise ValueError(f"x is {x.dtype}, compute_dtype is {compute_dtype}")
    for name, t in (("params_flat", params_flat), ("mask", mask)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _normalize(partials: torch.Tensor, mask: torch.Tensor, dim: int,
               lam: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss [G], grads [G, P]) from the un-normalized [G, P + 2] partials,
    as the TPU entry: inv_m * (s_mse / D + lam * s_zn) and inv_m * grads.
    The plain path's; the kernel's epilogue does the same operations in the
    same order."""
    msum = mask.sum(dim=1, dtype=torch.float32)
    inv_m = safe_div(torch.ones_like(msum), msum)
    s_mse, s_zn = partials[:, -2], partials[:, -1]
    loss = inv_m * (s_mse / dim + lam * s_zn)
    return loss, inv_m[:, None] * partials[:, :-2]


def _partials_plain(params_flat: torch.Tensor, x: torch.Tensor,
                    mask: torch.Tensor, layout: ParamLayout, lam: float,
                    compute_dtype: torch.dtype) -> torch.Tensor:
    f32 = torch.float32
    g = params_flat.shape[0]

    def cast(t):
        return t.to(compute_dtype).to(f32)

    mats = [params_flat[:, sl].reshape((g,) + shape)
            for sl, (_, _, shape) in zip(layout.slices(), layout.leaves())]
    w1, b1, w2, b2, w3, b3, w4, b4 = [
        cast(t) if t.dim() == 3 else t[:, None, :] for t in mats]
    xf = x.to(f32)
    m = mask[:, :, None]
    t = lambda a: a.transpose(1, 2)  # noqa: E731

    h1 = cast(torch.relu(xf @ w1 + b1))
    z = h1 @ w2 + b2
    zc = cast(z)
    h2 = cast(torch.relu(zc @ w3 + b3))
    recon = h2 @ w4 + b4

    err = xf - recon
    s_mse = (m * torch.square(err)).sum(dim=(1, 2))
    sq = torch.square(z).sum(dim=2, keepdim=True)
    pos = sq > 0
    nz = pos.to(f32)
    zn = torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))) * nz
    s_zn = (m * zn).sum(dim=(1, 2))

    dr = (-2.0 / layout.dim) * (m * err)
    drc = cast(dr)
    db4 = dr.sum(dim=1)
    dw4 = t(h2) @ drc
    zero = torch.zeros((), dtype=f32, device=x.device)
    da3 = torch.where(h2 > 0, drc @ t(w4), zero)
    da3c = cast(da3)
    db3 = da3.sum(dim=1)
    dw3 = t(zc) @ da3c
    inv = nz / torch.where(pos, zn, torch.ones_like(zn))
    dz = da3c @ t(w3) + lam * m * z * inv
    dzc = cast(dz)
    db2 = dz.sum(dim=1)
    dw2 = t(h1) @ dzc
    da1 = torch.where(h1 > 0, dzc @ t(w2), zero)
    da1c = cast(da1)
    db1 = da1.sum(dim=1)
    dw1 = t(xf) @ da1c
    parts = [dw1, db1, dw2, db2, dw3, db3, dw4, db4]
    return torch.cat([p.reshape(g, -1) for p in parts]
                     + [s_mse[:, None], s_zn[:, None]], dim=1)


def fused_train_grads_plain(params_flat: torch.Tensor, x: torch.Tensor,
                            mask: torch.Tensor, *, layout: ParamLayout,
                            shrink_lambda: float = 0.0,
                            compute_dtype: torch.dtype = torch.float32
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: batched matmuls over the G
    clients, bf16 emulated as bf16-rounded values in f32 matmuls. On a CUDA
    tensor it requires TF32 off (torch.backends.cuda.matmul.allow_tf32 =
    False), or the comparison with the kernel would mean nothing."""
    _check(params_flat, x, mask, layout, compute_dtype)
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain fused train step on the card needs "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    lam = float(shrink_lambda)
    partials = _partials_plain(params_flat, x, mask, layout, lam,
                               compute_dtype)
    return _normalize(partials, mask, layout.dim, lam)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = native.load("fused_train")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fused_ae_train.argtypes = [ptr, i64, ptr, i64, ptr, ptr, ptr,
                                   i32, i32, i32, i32, i32, i32,
                                   ctypes.c_float, i32, i32, ptr]
    lib.fused_ae_train.restype = i32
    lib.fused_ae_train_error_string.argtypes = [i32]
    lib.fused_ae_train_error_string.restype = ctypes.c_char_p
    return lib


def fused_train_grads(params_flat: torch.Tensor, x: torch.Tensor,
                      mask: torch.Tensor, *, layout: ParamLayout,
                      shrink_lambda: float = 0.0,
                      compute_dtype: torch.dtype = torch.float32
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss [G], grads [G, P]), both f32, of G clients' batches in one
    fused pass.

    params_flat: [G, P] f32 (models/flat.ParamLayout). x: [G, R, D] in
    `compute_dtype`, rows contiguous (any client stride). mask: [G, R] f32
    row mask, rows contiguous. Under bf16 the kernel rounds the weights to
    bf16 as it loads them. CPU tensors run `fused_train_grads_plain`; CUDA
    tensors launch csrc/fused_train.cu once, on their device's current
    stream, as G clusters of `cluster_size(G, H)` CTAs, and nothing runs
    after it (it raises ValueError for a model too wide for the kernel's
    shared memory). R = 0 or G = 0 launches nothing: every loss and
    gradient is then NaN, as an all-masked client's."""
    _check(params_flat, x, mask, layout, compute_dtype)
    lam = float(shrink_lambda)
    if x.device.type == "cpu":
        partials = _partials_plain(params_flat, x, mask, layout, lam,
                                   compute_dtype)
        return _normalize(partials, mask, layout.dim, lam)
    if x.device.type != "cuda":
        raise ValueError(f"fused train step runs on cuda or cpu, got "
                         f"{x.device}")
    g, r, d = x.shape
    if g == 0 or r == 0:
        nan = float("nan")
        return (torch.full((g,), nan, device=x.device),
                torch.full((g, layout.size), nan, device=x.device))
    if x.stride(2) != 1 or (r > 1 and (x.stride(1) != d
                                       or mask.stride(1) != 1)) \
            or not params_flat.is_contiguous():
        raise ValueError("the fused train kernel takes x and mask with "
                         "contiguous rows and contiguous params_flat")
    lib = _library()
    # the kernel writes every element of both
    loss = torch.empty((g,), dtype=torch.float32, device=x.device)
    grads = torch.empty((g, layout.size), dtype=torch.float32,
                        device=x.device)
    index = x.device.index
    # the device's current stream in one C call (what torch's own compiled
    # kernels use), with no device context entered around the launch
    rc = lib.fused_ae_train(
        x.data_ptr(), x.stride(0), mask.data_ptr(), mask.stride(0),
        params_flat.data_ptr(), loss.data_ptr(), grads.data_ptr(),
        g, r, d, layout.hidden, layout.latent,
        cluster_size(g, layout.hidden), lam,
        int(compute_dtype == torch.bfloat16), index,
        torch._C._cuda_getCurrentRawStream(index))
    if rc == _ERR_TOO_WIDE:
        raise ValueError(f"fused train kernel: {layout} is too wide: "
                         + lib.fused_ae_train_error_string(rc).decode())
    if rc != 0:
        raise RuntimeError("fused_ae_train launch failed: "
                           + lib.fused_ae_train_error_string(rc).decode())
    native.count_launch(fused_train_grads)
    return loss, grads


fused_train_grads.launches = 0
fused_train_grads.captured = 0


class FusedTrainLoss(torch.autograd.Function):
    """Per-client loss [G] whose backward is the fused train kernel (the
    port of make_fused_train_loss). The forward runs `fused_train_grads`
    and keeps its gradients; the backward scales them by each client's
    cotangent and returns no gradient for x or mask (data is never
    differentiated). A fedprox term stays ordinary autograd outside, and
    the gradients add.

        loss = FusedTrainLoss.apply(params_flat, x, mask, layout, lam, cdt)
    """

    @staticmethod
    def forward(ctx, params_flat, x, mask, layout, shrink_lambda,
                compute_dtype):
        loss, grads = fused_train_grads(
            params_flat.detach(), x, mask, layout=layout,
            shrink_lambda=shrink_lambda, compute_dtype=compute_dtype)
        ctx.save_for_backward(grads)
        return loss

    @staticmethod
    def backward(ctx, ct):
        (grads,) = ctx.saved_tensors
        return ct[:, None] * grads, None, None, None, None, None

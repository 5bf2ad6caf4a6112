"""KitNET's forward statistic and train step, each one kernel launch
(csrc/kitnet.cu, whose header states the model's equations, the kernels'
bound and their design).

  * `kitnet_forward_stats(params, x, model_idx)`: per row of x [R, D] under
    its model (a `KitnetParams`: flat params [G, P], their running
    statistics [G, 2k] and the layout): the statistic the federation reads
    where it reads an autoencoder's reconstruction MSE, mean_i (s^_i -
    z_out,i)^2, and the row's loss, both [R] f32;
  * `kitnet_train_grads(params_flat, stats, x, mask, layout=, active=)`:
    per client of S, its batch x [S, R, D] (row mask [S, R]): first the
    client's statistics take the min and max of its members' RMSEs over
    the batch's real rows (in place, where `active` [S] bool holds: a
    client that stopped keeps them), then (loss [S], grads [S, P]), the
    mean over real rows of the summed reconstruction cross-entropies and
    its gradient (NaN for a client whose mask is empty).

The federation calls them through `ops.fused_ae.fused_forward_stats` and
`ops.fused_train.fused_train_grads`, which dispatch on the operand's
layout. Each has a plain twin here (`*_plain`), explicit backward and all,
which the wrapper takes only for CPU tensors; a CUDA tensor launches the
kernel or raises. The wrappers count their launches (`.launches`, and
`.captured` for kernels a CUDA graph recorded: ops/native.count_launch).
KitNET computes in f32 only.
"""

from __future__ import annotations

import ctypes
import functools
from typing import TYPE_CHECKING, List, Optional, Tuple

import torch

from fedmse_tpu_torch.ops import native

if TYPE_CHECKING:  # no import of the models package: it imports the ops
    from fedmse_tpu_torch.models.flat import KitnetLayout

_ERR_TOO_WIDE = 1000  # kErrTooWide in csrc/kitnet.cu
_HEADER = 8


class KitnetParams:
    """KitNET models as the kernels take them (ops/kitnet.py): flat params
    [G, P] f32, their running statistics [G, 2k] f32 and the layout. It
    passes through ops/precision.cast_params as it is (`to` returns it):
    KitNET computes in f32 only."""

    __slots__ = ("flat", "stats", "layout")

    def __init__(self, flat: torch.Tensor, stats: torch.Tensor,
                 layout: "KitnetLayout"):
        self.flat, self.stats, self.layout = flat, stats, layout

    def to(self, *args, **kwargs) -> "KitnetParams":
        return self


def table_rows(layout: KitnetLayout) -> List[int]:
    """The kernels' table of the layout (csrc/kitnet.cu, its header)."""
    k, names = layout.k, layout.autoencoders()
    members, feats, owner = [], [], []
    offsets = {path: off for path, off, _ in layout.leaves()}
    y = 0
    for a, (name, n, h) in enumerate(names[:-1]):
        members += [n, h, len(feats), offsets[(name, "W")], y]
        feats += list(layout.feature_map[a])
        owner += [a] * (n * h + h + n)
        y += h
    _, _, ho = names[-1]
    owner += [k] * (k * ho + ho + k)
    header = [k, layout.dim, y, ho, layout.size, offsets[("output", "W")],
              offsets[("output", "b")], offsets[("output", "c")]]
    return header + members + feats + owner


@functools.lru_cache(maxsize=None)
def device_table(layout: KitnetLayout, device: torch.device
                 ) -> torch.Tensor:
    """The table as an int32 tensor on `device`, made once a layout and
    device (before any graph captures a kernel that reads it)."""
    return torch.tensor(table_rows(layout), dtype=torch.int32,
                        device=device)


def _dims(layout: KitnetLayout) -> Tuple[int, int, int, int, int, int]:
    names = layout.autoencoders()
    return (layout.k, layout.dim, sum(h for _, _, h in names[:-1]),
            names[-1][2], layout.size, layout.stats_width)


# ---- the plain twins ---- #

def _softplus(o: torch.Tensor) -> torch.Tensor:
    return torch.clamp(o, min=0.0) + torch.log1p(torch.exp(-torch.abs(o)))


def _tied(w: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
          u: torch.Tensor):
    """(hidden y, visible pre-activation o, z) of a tied autoencoder with
    W [C, n, h], b [C, h], c [C, n] over rows u [C, R, n]."""
    y = torch.sigmoid(torch.bmm(u, w) + b[:, None])
    o = torch.bmm(y, w.transpose(1, 2)) + c[:, None]
    return y, o, torch.sigmoid(o)


def normalized(s: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    """s^ of RMSEs s [C, R, k] under statistics [C, 2k]: (s - lo) / (hi -
    lo + 1e-16), s itself where hi < lo (nothing seen yet)."""
    k = s.shape[-1]
    lo, hi = stats[:, None, :k], stats[:, None, k:]
    return torch.where(hi >= lo, (s - lo) / (hi - lo + 1e-16), s)


def _members(views, layout: KitnetLayout, x: torch.Tensor):
    """Each ensemble member on rows x [C, R, D]: [(u, y, o, z)], and the
    RMSEs s [C, R, k]."""
    out, rmse = [], []
    for a, feats in enumerate(layout.feature_map):
        leaf = views[f"ensemble_{a}"]
        u = x[:, :, list(feats)]
        y, o, z = _tied(leaf["W"], leaf["b"], leaf["c"], u)
        out.append((u, y, o, z))
        rmse.append(torch.sqrt(torch.square(u - z).mean(dim=-1)))
    return out, torch.stack(rmse, dim=-1)


def _rows(flat: torch.Tensor, stats: torch.Tensor, x: torch.Tensor,
          layout: KitnetLayout):
    """(statistic [C, R], loss [C, R]) of C models over their rows x
    [C, R, D]."""
    views = layout.views(flat)
    members, s = _members(views, layout, x)
    shat = normalized(s, stats)
    out = views["output"]
    _, o, z = _tied(out["W"], out["b"], out["c"], shat)
    loss = sum((_softplus(mo) - mu * mo).sum(dim=-1)
               for mu, _, mo, _ in members)
    loss = loss + (_softplus(o) - shat * o).sum(dim=-1)
    return torch.square(shat - z).mean(dim=-1), loss


def _check_forward(params: KitnetParams, x: torch.Tensor,
                   model_idx: Optional[torch.Tensor]) -> int:
    layout = params.layout
    g = params.flat.shape[0]
    if x.dim() != 2 or x.shape[1] != layout.dim:
        raise ValueError(f"x must be [rows, {layout.dim}], got "
                         f"{tuple(x.shape)}")
    if tuple(params.flat.shape) != (g, layout.size) or \
            tuple(params.stats.shape) != (g, layout.stats_width):
        raise ValueError(f"KitNET params must be [G, {layout.size}] with "
                         f"stats [G, {layout.stats_width}], got "
                         f"{tuple(params.flat.shape)} and "
                         f"{tuple(params.stats.shape)}")
    for name, t in (("x", x), ("params", params.flat),
                    ("stats", params.stats)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype}; KitNET computes in "
                             "float32 only")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if model_idx is not None and (
            model_idx.dtype != torch.int32
            or tuple(model_idx.shape) != (x.shape[0],)
            or model_idx.device != x.device):
        raise ValueError("model_idx must be int32 [rows] on x's device")
    return g


def kitnet_forward_stats_plain(params: KitnetParams, x: torch.Tensor,
                               model_idx: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch, one group of batched
    products per model present in `model_idx` (None: every row model 0).
    Rows whose model lies outside [0, G) get NaN, as in the kernel. On a
    CUDA tensor it requires TF32 off."""
    g = _check_forward(params, x, model_idx)
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain KitNET forward on the card needs "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    rows = x.shape[0]
    stat = torch.full((rows,), float("nan"), device=x.device)
    loss = torch.full((rows,), float("nan"), device=x.device)
    if model_idx is None:
        groups = [(0, None)] if rows else []
    else:
        groups = [(m, torch.nonzero(model_idx == m).squeeze(1))
                  for m in torch.unique(model_idx).tolist() if 0 <= m < g]
    for m, sel in groups:
        xm = x if sel is None else x[sel]
        s, lo = _rows(params.flat[m:m + 1], params.stats[m:m + 1], xm[None],
                      params.layout)
        if sel is None:
            stat.copy_(s[0])
            loss.copy_(lo[0])
        else:
            stat[sel], loss[sel] = s[0], lo[0]
    return stat, loss


def _check_train(params_flat, stats, x, mask, layout: KitnetLayout,
                 active) -> None:
    if x.dim() != 3 or x.shape[2] != layout.dim:
        raise ValueError(f"x must be [S, R, {layout.dim}], got "
                         f"{tuple(x.shape)}")
    s, r, _ = x.shape
    want = (("params_flat", params_flat, (s, layout.size)),
            ("stats", stats, (s, layout.stats_width)),
            ("mask", mask, (s, r)))
    for name, t, shape in want:
        if t is None or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{None if t is None else tuple(t.shape)}")
    for name, t in (("x", x), ("params_flat", params_flat),
                    ("stats", stats), ("mask", mask)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype}; KitNET computes in "
                             "float32 only")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if active is not None and (active.dtype != torch.bool
                               or tuple(active.shape) != (s,)):
        raise ValueError(f"active must be bool [{s}]")


def update_stats_(stats: torch.Tensor, s: torch.Tensor, mask: torch.Tensor,
                  active: Optional[torch.Tensor]) -> None:
    """lo, hi of stats [C, 2k] take the min and max of RMSEs s [C, R, k]
    over the real rows (mask [C, R] > 0; a NaN is passed over), in place,
    where `active` [C] (None: every client)."""
    k = s.shape[-1]
    ok = (mask > 0)[:, :, None] & ~torch.isnan(s)
    lo = torch.minimum(stats[:, :k],
                       torch.where(ok, s, float("inf")).amin(dim=1))
    hi = torch.maximum(stats[:, k:],
                       torch.where(ok, s, float("-inf")).amax(dim=1))
    new = torch.cat([lo, hi], dim=1)
    if active is not None:
        new = torch.where(active[:, None], new, stats)
    stats.copy_(new)


def kitnet_train_grads_plain(params_flat: torch.Tensor, stats: torch.Tensor,
                             x: torch.Tensor, mask: torch.Tensor, *,
                             layout: KitnetLayout,
                             active: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The train kernel's function in plain PyTorch, the backward written
    out: per autoencoder, with e = m (z - u) at its visible units, the
    hidden errors (e W) y (1 - y), dW = u^T dh + e^T y, db and dc their
    sums over rows. On a CUDA tensor it requires TF32 off."""
    _check_train(params_flat, stats, x, mask, layout, active)
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain KitNET train step on the card needs "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    views = layout.views(params_flat)
    members, s = _members(views, layout, x)
    update_stats_(stats, s, mask, active)
    shat = normalized(s, stats)
    out = views["output"]
    m = mask[:, :, None]
    t = lambda a: a.transpose(1, 2)  # noqa: E731
    grads, loss = [], torch.zeros_like(mask)
    for (name, _, _), (u, y, o, z) in zip(
            layout.autoencoders(),
            members + [(shat,) + _tied(out["W"], out["b"], out["c"], shat)]):
        w = views[name]["W"]
        e = m * (z - u)
        dh = torch.bmm(e, w) * (y * (1.0 - y))
        grads += [torch.bmm(t(u), dh) + torch.bmm(t(e), y), dh.sum(dim=1),
                  e.sum(dim=1)]
        loss = loss + (_softplus(o) - u * o).sum(dim=-1)
    inv = 1.0 / mask.sum(dim=1)  # x / 0 where the mask is empty
    flat = torch.cat([g.reshape(g.shape[0], -1) for g in grads], dim=1)
    return inv * (mask * loss).sum(dim=1), inv[:, None] * flat


# ---- the kernels ---- #

@functools.cache
def _library() -> ctypes.CDLL:
    lib = native.load("kitnet")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.kitnet_forward_tile.argtypes = [i32] * 9
    lib.kitnet_forward_tile.restype = i32
    lib.kitnet_forward.argtypes = ([ptr, i64] + [ptr] * 6 + [i32] * 11
                                   + [ptr])
    lib.kitnet_forward.restype = i32
    lib.kitnet_train.argtypes = ([ptr, i64, ptr, i64, ptr, ptr, ptr, i64]
                                 + [ptr] * 3 + [i32] * 10 + [ptr])
    lib.kitnet_train.restype = i32
    lib.kitnet_error_string.argtypes = [i32]
    lib.kitnet_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _raise(lib, rc: int, what: str) -> None:
    message = lib.kitnet_error_string(rc).decode()
    if rc == _ERR_TOO_WIDE:
        raise ValueError(f"{what}: {message}")
    raise RuntimeError(f"{what} launch failed: {message}")


def kitnet_forward_stats(params: KitnetParams, x: torch.Tensor,
                         model_idx: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(statistic [R], loss [R]), f32, of rows x [R, D] f32, row r under
    model model_idx[r] (int32 [R]; None: model 0; outside [0, G): NaN).
    CPU tensors run `kitnet_forward_stats_plain`; CUDA tensors launch
    csrc/kitnet.cu once on their device's current stream (contiguous
    operands, else ValueError). R = 0 launches nothing."""
    _check_forward(params, x, model_idx)
    if x.device.type == "cpu":
        return kitnet_forward_stats_plain(params, x, model_idx)
    if x.device.type != "cuda":
        raise ValueError(f"the KitNET forward runs on cuda or cpu, got "
                         f"{x.device}")
    rows = x.shape[0]
    stat = torch.empty((rows,), dtype=torch.float32, device=x.device)
    loss = torch.empty((rows,), dtype=torch.float32, device=x.device)
    if rows == 0:
        return stat, loss
    operands = (x, params.flat, params.stats) + (
        () if model_idx is None else (model_idx,))
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("the KitNET forward kernel takes contiguous tensors")
    layout = params.layout
    k, d, hs, ho, p, q = _dims(layout)
    table = device_table(layout, x.device)
    table_len = _HEADER + 5 * k + d  # the forward reads no parameter owner
    lib = _library()
    index = x.device.index
    tile = lib.kitnet_forward_tile(rows, _sm_count(index), k, d, hs, ho, p,
                                   q, table_len)
    if tile == 0:
        _raise(lib, _ERR_TOO_WIDE, "KitNET forward")
    rc = lib.kitnet_forward(
        x.data_ptr(), x.stride(0),
        None if model_idx is None else model_idx.data_ptr(),
        params.flat.data_ptr(), params.stats.data_ptr(), table.data_ptr(),
        stat.data_ptr(), loss.data_ptr(), rows, params.flat.shape[0], tile,
        k, d, hs, ho, p, q, table_len, index,
        torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        _raise(lib, rc, "KitNET forward")
    native.count_launch(kitnet_forward_stats)
    return stat, loss


kitnet_forward_stats.launches = 0
kitnet_forward_stats.captured = 0


def kitnet_train_grads(params_flat: torch.Tensor, stats: torch.Tensor,
                       x: torch.Tensor, mask: torch.Tensor, *,
                       layout: KitnetLayout,
                       active: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss [S], grads [S, P]), f32, of S clients' batches x [S, R, D]
    (rows contiguous, any client stride; mask [S, R] f32 likewise), the
    clients' statistics [S, 2k] updated in place first where `active`
    ([S] bool, any stride; None: every client). CPU tensors run
    `kitnet_train_grads_plain`; CUDA tensors launch csrc/kitnet.cu once,
    S CTAs, on their device's current stream, and nothing after it.
    S = 0 or R = 0 launches nothing: every loss and gradient is NaN."""
    _check_train(params_flat, stats, x, mask, layout, active)
    if x.device.type == "cpu":
        return kitnet_train_grads_plain(params_flat, stats, x, mask,
                                        layout=layout, active=active)
    if x.device.type != "cuda":
        raise ValueError(f"the KitNET train step runs on cuda or cpu, got "
                         f"{x.device}")
    s, r, d = x.shape
    if s == 0 or r == 0:
        nan = float("nan")
        return (torch.full((s,), nan, device=x.device),
                torch.full((s, layout.size), nan, device=x.device))
    if x.stride(2) != 1 or (r > 1 and (x.stride(1) != d
                                       or mask.stride(1) != 1)) \
            or not params_flat.is_contiguous() or not stats.is_contiguous():
        raise ValueError("the KitNET train kernel takes x and mask with "
                         "contiguous rows and contiguous params and stats")
    k, _, hs, ho, p, q = _dims(layout)
    table = device_table(layout, x.device)
    lib = _library()
    index = x.device.index
    loss = torch.empty((s,), dtype=torch.float32, device=x.device)
    grads = torch.empty((s, p), dtype=torch.float32, device=x.device)
    rc = lib.kitnet_train(
        x.data_ptr(), x.stride(0), mask.data_ptr(), mask.stride(0),
        params_flat.data_ptr(), stats.data_ptr(),
        None if active is None else active.data_ptr(),
        0 if active is None else active.stride(0), table.data_ptr(),
        loss.data_ptr(), grads.data_ptr(), s, r, k, d, hs, ho, p, q,
        table.shape[0], index, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        _raise(lib, rc, "KitNET train step")
    native.count_launch(kitnet_train_grads)
    return loss, grads


kitnet_train_grads.launches = 0
kitnet_train_grads.captured = 0

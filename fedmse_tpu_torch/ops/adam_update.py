"""The update of one local-training step: the FedProx term, optax's Adam and
the loss sum of a cohort's batch, over stacked [S, P] f32 buffers, one
optimizer state per row.

`adam_update` runs, in place, what follows each fused train step
(federation/local_training.py) and what `federation/optim.adam_step_`
asks for:

    under FedProx (prev given), at the pre-update params:
        loss = loss + prox_mu * sum_j (p - prev)^2
        grads = grads + prox_mu * (2 (p - prev))
    Adam (optim.py's arithmetic) on the rows where step & active
    loss_sum += where(step, loss, 0)    (loss_sum given; always under FedProx)

`step` [S] bool is the batch's real-batch flag (a padded batch takes no
Adam time step and adds nothing to the sum), `active` [S] bool the
early-stop lanes (None: every row); a row where either is false keeps its
params and Adam state, and NaN grads there reach nothing.

`adam_update_plain` is the same function as the op sequence the local
training ran before the kernel, which the CPU tests hold to optax. The
wrapper takes it only for tensors on the CPU; a CUDA tensor launches
csrc/adam_update.cu once, on its device's current stream, or raises. The
kernel gives the plain version's p, mu, nu and count bit for bit, and its
loss sum too without FedProx; under FedProx the sum over P is taken in an
order fixed by P alone (the kernel's header). `adam_update.launches`
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from fedmse_tpu_torch.ops import native
from fedmse_tpu_torch.ops.losses import prox_term

B1, B2, EPS, EPS_ROOT = 0.9, 0.999, 1e-8, 0.0
_COUNT_MAX = np.iinfo(np.int32).max
_ROW_CHUNK = 1024  # parameters a CTA takes, at least (csrc/adam_update.cu)
_MAX_CLUSTER = 8  # the portable thread-block cluster size


def row_ctas(p: int) -> int:
    """CTAs a row of P parameters spreads over: min(8, ceil(P / 1024)),
    from P alone, so a row's sums run in one order in any cohort."""
    return max(1, min(_MAX_CLUSTER, -(-p // _ROW_CHUNK)))


def adam_update_plain(params: torch.Tensor, state: Sequence[torch.Tensor],
                      grads: torch.Tensor, lr: float, step: torch.Tensor, *,
                      active: Optional[torch.Tensor] = None,
                      loss: Optional[torch.Tensor] = None,
                      loss_sum: Optional[torch.Tensor] = None,
                      prev: Optional[torch.Tensor] = None,
                      prox_mu: float = 0.0) -> None:
    """The update in plain PyTorch, in place on params, state (count, mu,
    nu) and loss_sum (see the module docstring)."""
    count0, mu0, nu0 = state
    has = step
    if prev is not None:
        loss = loss + prox_mu * prox_term(params, prev)
        grads = grads + prox_mu * (2.0 * (params - prev))
    if active is not None:
        step = step & active
    mu = (1 - B1) * grads + B1 * mu0
    nu = (1 - B2) * (grads * grads) + B2 * nu0
    count = torch.where(count0 < _COUNT_MAX, count0 + 1, count0)
    cf = count.to(torch.float32)
    bc1 = 1 - torch.pow(torch.full_like(cf, B1), cf)
    bc2 = 1 - torch.pow(torch.full_like(cf, B2), cf)
    mu_hat = mu / bc1[:, None]
    nu_hat = nu / bc2[:, None]
    updates = (-lr) * (mu_hat / (torch.sqrt(nu_hat + EPS_ROOT) + EPS))
    keep = step[:, None]
    torch.where(keep, params + updates, params, out=params)
    torch.where(step, count, count0, out=count0)
    torch.where(keep, mu, mu0, out=mu0)
    torch.where(keep, nu, nu0, out=nu0)
    if loss_sum is not None:
        loss_sum.copy_(loss_sum + torch.where(has, loss, 0.0))


def _check(params, state, grads, step, active, loss, loss_sum,
           prev) -> None:
    if params.dim() != 2:
        raise ValueError(f"params must be [S, P], got {tuple(params.shape)}")
    s, p = params.shape
    count, mu, nu = state
    rows = [("params", params), ("mu", mu), ("nu", nu), ("grads", grads)]
    if prev is not None:
        rows.append(("prev", prev))
    for name, t in rows:
        if tuple(t.shape) != (s, p) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [{s}, {p}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    vecs = [("count", count, torch.int32), ("step", step, torch.bool)]
    if active is not None:
        vecs.append(("active", active, torch.bool))
    if (loss is None) != (loss_sum is None):
        raise ValueError("loss and loss_sum are given together or not at all")
    if prev is not None and loss is None:
        raise ValueError("FedProx (prev) sums its term into loss_sum: give "
                         "loss and loss_sum")
    if loss is not None:
        vecs += [("loss", loss, torch.float32),
                 ("loss_sum", loss_sum, torch.float32)]
    for name, t, dtype in vecs:
        if tuple(t.shape) != (s,) or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} [{s}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    devices = {str(t.device) for _, t in rows} | {
        str(t.device) for _, t, _ in vecs}
    if len(devices) != 1:
        raise ValueError(f"the update's tensors lie on {sorted(devices)}, "
                         "not on one device")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = native.load("adam_update")
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    lib.adam_update.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                ptr, i64, ptr, i64, i32, i32, i32, f32, f32,
                                i32, i32, ptr]
    lib.adam_update.restype = i32
    lib.adam_update_error_string.argtypes = [i32]
    lib.adam_update_error_string.restype = ctypes.c_char_p
    return lib


def adam_update(params: torch.Tensor, state: Sequence[torch.Tensor],
                grads: torch.Tensor, lr: float, step: torch.Tensor, *,
                active: Optional[torch.Tensor] = None,
                loss: Optional[torch.Tensor] = None,
                loss_sum: Optional[torch.Tensor] = None,
                prev: Optional[torch.Tensor] = None,
                prox_mu: float = 0.0) -> None:
    """One step's update, in place on params [S, P], state (count [S]
    int32, mu and nu [S, P] f32) and loss_sum [S] (module docstring).
    grads and prev (FedProx, or None) are [S, P] f32; step and active [S]
    bool, any stride; loss and loss_sum [S] f32, both or neither (both
    under FedProx). CPU tensors run `adam_update_plain`; CUDA tensors
    launch csrc/adam_update.cu once, as S clusters of `row_ctas(P)` CTAs,
    with the [S, P] buffers contiguous (else it raises ValueError), and
    nothing runs after it. S = 0 launches nothing."""
    _check(params, state, grads, step, active, loss, loss_sum, prev)
    kw = dict(active=active, loss=loss, loss_sum=loss_sum, prev=prev,
              prox_mu=prox_mu)
    if params.device.type == "cpu":
        adam_update_plain(params, state, grads, lr, step, **kw)
        return
    if params.device.type != "cuda":
        raise ValueError(f"the update runs on cuda or cpu, got "
                         f"{params.device}")
    count, mu, nu = state
    s, p = params.shape
    if s == 0 or p == 0:
        return
    flat = [params, mu, nu, grads] + ([prev] if prev is not None else [])
    if not all(t.is_contiguous() for t in flat + [count]) or (
            loss is not None and not (loss.is_contiguous()
                                      and loss_sum.is_contiguous())):
        raise ValueError("the update kernel takes contiguous params, "
                         "moments, grads, anchors, count and losses")
    vec = p % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in flat)
    lib = _library()
    index = params.device.index

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = lib.adam_update(
        params.data_ptr(), mu.data_ptr(), nu.data_ptr(), count.data_ptr(),
        grads.data_ptr(), ptr(prev), ptr(loss), ptr(loss_sum),
        step.data_ptr(), step.stride(0), ptr(active),
        0 if active is None else active.stride(0), s, p, row_ctas(p),
        -lr, prox_mu, int(vec), index,
        torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError("adam_update launch failed: "
                           + lib.adam_update_error_string(rc).decode())
    native.count_launch(adam_update)


adam_update.launches = 0
adam_update.captured = 0

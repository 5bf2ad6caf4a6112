"""The local-training step's update (ops/adam_update.py) on the CPU: its
plain version against the op sequence the local training ran before the
update had a kernel (the FedProx term, optim's Adam, the loss sum), bit for
bit; the wrapper's routing, checks and import. The kernel itself is held to
the plain version on the card (tests/test_torch_gpu.py)."""

import numpy as np
import pytest
import torch

from fedmse_tpu_torch.federation.optim import AdamState, adam_step_
from fedmse_tpu_torch.models.flat import ParamLayout
from fedmse_tpu_torch.ops import adam_update as mod
from fedmse_tpu_torch.ops.adam_update import (adam_update, adam_update_plain,
                                              row_ctas)
from fedmse_tpu_torch.ops.fused_train import fused_train_grads
from fedmse_tpu_torch.ops.losses import prox_term

DIMS = (16, 8, 3)
S, ROWS, LR, MU = 6, 12, 1e-3, 0.001
COUNT_MAX = np.iinfo(np.int32).max


def old_sequence(p, opt, grads, loss, loss_sum, has, active, lr, prev, mu):
    """The step as local_training.py wrote it before the update kernel:
    returns the new loss_sum; p and opt in place."""
    if prev is not None:
        loss = loss + mu * prox_term(p, prev)
        grads = grads + mu * (2.0 * (p - prev))
    step = has & active
    m = (1 - 0.9) * grads + 0.9 * opt.mu
    v = (1 - 0.999) * (grads * grads) + 0.999 * opt.nu
    count = torch.where(opt.count < COUNT_MAX, opt.count + 1, opt.count)
    cf = count.to(torch.float32)
    bc1 = 1 - torch.pow(torch.full_like(cf, 0.9), cf)
    bc2 = 1 - torch.pow(torch.full_like(cf, 0.999), cf)
    upd = (-lr) * ((m / bc1[:, None])
                   / (torch.sqrt(v / bc2[:, None] + 0.0) + 1e-8))
    keep = step[:, None]
    torch.where(keep, p + upd, p, out=p)
    torch.where(step, count, opt.count, out=opt.count)
    torch.where(keep, m, opt.mu, out=opt.mu)
    torch.where(keep, v, opt.nu, out=opt.nu)
    return loss_sum + torch.where(has, loss, 0.0)


def inputs(seed, case):
    """A step's inputs: the fused train step's loss and grads of S clients
    on one batch, a trained-looking Adam state and anchors, and the
    has_b / active flags of `case`."""
    gen = torch.Generator().manual_seed(seed)
    layout = ParamLayout(*DIMS)
    p = (torch.rand((S, layout.size), generator=gen) - 0.5) * 0.4
    x = torch.randn((S, ROWS, DIMS[0]), generator=gen)
    m = (torch.rand((S, ROWS), generator=gen) < 0.8).float()
    has = torch.ones(S, dtype=torch.bool)
    active = torch.ones(S, dtype=torch.bool)
    count = torch.randint(0, 50, (S,), generator=gen, dtype=torch.int32)
    if case == "padded":
        has[[1, 4]] = False
        m[[1, 4]] = 0.0  # an all-masked batch: NaN loss and grads
    elif case == "frozen":
        active[[0, 3]] = False
    elif case == "count_max":
        count[[2, 5]] = COUNT_MAX
    elif case == "all_off":
        has[:3] = False
        m[:3] = 0.0
        active[3:] = False
    loss, grads = fused_train_grads(p, x, m, layout=layout,
                                    shrink_lambda=5.0)
    if case == "nan_frozen":
        active[[1, 2]] = False
        grads[[1, 2]] = float("nan")
    opt = AdamState(count,
                    torch.randn((S, layout.size), generator=gen) * 1e-3,
                    torch.rand((S, layout.size), generator=gen) * 1e-6)
    prev = p + torch.randn((S, layout.size), generator=gen) * 1e-2
    loss_sum = torch.rand(S, generator=gen)
    return p, opt, grads, loss, loss_sum, has, active, prev


def bits(t):
    return t.contiguous().view(torch.int32)


CASES = ["plain", "padded", "frozen", "nan_frozen", "count_max", "all_off"]


@pytest.mark.parametrize("fedprox", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_plain_update_is_the_old_sequence_bit_for_bit(case, fedprox):
    p, opt, grads, loss, loss_sum, has, active, prev = inputs(7, case)
    prev = prev if fedprox else None
    want_p, want_opt = p.clone(), opt.clone()
    want_sum = old_sequence(want_p, want_opt, grads, loss, loss_sum.clone(),
                            has, active, LR, prev, MU)
    got_sum = loss_sum.clone()
    adam_update_plain(p, opt, grads, LR, has, active=active, loss=loss,
                      loss_sum=got_sum, prev=prev, prox_mu=MU)
    for got, want in zip((p, opt.mu, opt.nu, opt.count, got_sum),
                         (want_p, want_opt.mu, want_opt.nu, want_opt.count,
                          want_sum)):
        assert torch.equal(bits(got), bits(want))
    assert torch.isfinite(p).all() and torch.isfinite(got_sum).all()


@pytest.mark.parametrize("case", CASES)
def test_rows_that_do_not_step_keep_their_bits(case):
    p, opt, grads, loss, loss_sum, has, active, prev = inputs(8, case)
    before = [t.clone() for t in (p, *opt)]
    adam_update_plain(p, opt, grads, LR, has, active=active, loss=loss,
                      loss_sum=loss_sum, prev=prev, prox_mu=MU)
    still = ~(has & active)
    for got, was in zip((p, *opt), before):
        assert torch.equal(got[still], was[still])
    moved = has & active & (before[1] < COUNT_MAX)
    assert torch.equal(opt.count[moved], before[1][moved] + 1)


def test_adam_step_without_extras_is_the_old_adam():
    """optim.adam_step_ (the sharded update's, no loss, no FedProx) keeps
    the old sequence's bits through the wrapper."""
    p, opt, grads, loss, _, has, active, _ = inputs(9, "frozen")
    step = has & active
    want_p, want_opt = p.clone(), opt.clone()
    old_sequence(want_p, want_opt, grads, loss, torch.zeros(S), step,
                 torch.ones(S, dtype=torch.bool), LR, None, MU)
    adam_step_(p, opt, grads, step, LR)
    for got, want in zip((p, *opt), (want_p, *want_opt)):
        assert torch.equal(bits(got), bits(want))


def test_wrapper_takes_the_plain_version_on_the_cpu(monkeypatch):
    calls = []
    real = mod.adam_update_plain

    def counted(*a, **kw):
        calls.append(kw["prox_mu"])
        return real(*a, **kw)

    monkeypatch.setattr(mod, "adam_update_plain", counted)
    p, opt, grads, loss, loss_sum, has, active, prev = inputs(10, "plain")
    launches = adam_update.launches
    adam_update(p, opt, grads, LR, has, active=active, loss=loss,
                loss_sum=loss_sum, prev=prev, prox_mu=MU)
    assert calls == [MU] and adam_update.launches == launches


def test_module_imports_without_nvcc():
    """Nothing builds at import: the first CUDA tensor builds the kernel."""
    assert mod._library.cache_info().currsize == 0
    assert "adam_update" in mod.native.KERNEL_SOURCES


@pytest.mark.parametrize("p, ctas", [(1, 1), (339, 1), (1024, 1), (1025, 2),
                                     (6764, 7), (8192, 8), (65536, 8)])
def test_row_ctas_come_from_p_alone(p, ctas):
    assert row_ctas(p) == ctas


@pytest.mark.parametrize("fault", ["shape", "dtype", "loss_alone",
                                   "count_shape", "step_dtype",
                                   "prox_without_loss"])
def test_wrapper_rejects_what_the_kernel_does_not_take(fault):
    p, opt, grads, loss, loss_sum, has, active, prev = inputs(11, "plain")
    kw = dict(active=active, loss=loss, loss_sum=loss_sum, prev=prev)
    if fault == "shape":
        grads = grads[:, :-1]
    elif fault == "dtype":
        prev = prev.double()
        kw["prev"] = prev
    elif fault == "loss_alone":
        kw["loss_sum"] = None
    elif fault == "prox_without_loss":
        kw["loss"] = kw["loss_sum"] = None
    elif fault == "count_shape":
        opt = AdamState(opt.count[:-1], opt.mu, opt.nu)
    else:
        has = has.int()
    with pytest.raises(ValueError):
        adam_update(p, opt, grads, LR, has, **kw)

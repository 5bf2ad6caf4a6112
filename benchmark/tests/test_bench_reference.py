"""The plain reference's own arithmetic: its written-out backward pass
against autograd, and the TF32 rounding of the control."""

import pytest
import torch

from benchmark.reference.fedmse import (forward, latent_norm, leaves,
                                        loss_and_grads, row_mse, tf32)

DIMS = (16, 8, 3)


@pytest.mark.parametrize("lam,mu", [(0.0, 0.0), (5.0, 0.0), (0.0, 1e-3),
                                    (5.0, 1e-3)])
def test_backward_is_autograd(lam, mu):
    g = torch.Generator().manual_seed(0)
    p_size = sum(t.numel() for t in leaves(torch.zeros(1, 400), DIMS)[:8])
    flat = torch.randn((3, p_size), generator=g, dtype=torch.float64) * 0.3
    prev = torch.randn((3, p_size), generator=g, dtype=torch.float64) * 0.3
    x = torch.randn((3, 12, DIMS[0]), generator=g, dtype=torch.float64)
    m = (torch.rand((3, 12), generator=g) > 0.3).to(torch.float64)
    loss, grads = loss_and_grads(flat, prev, x, m, DIMS, lam, mu)
    leaf = flat.clone().requires_grad_(True)
    z, recon = forward(leaf, x, DIMS)
    den = m.sum(dim=1).clamp(min=1)
    want = (row_mse(x, recon) * m).sum(dim=1) / den
    want = want + lam * (latent_norm(z) * m).sum(dim=1) / den
    want = want + mu * torch.square(leaf - prev).sum(dim=1)
    (auto,) = torch.autograd.grad(want.sum(), leaf)
    torch.testing.assert_close(loss, want.detach())
    torch.testing.assert_close(grads, auto)


def test_tf32_keeps_ten_mantissa_bits():
    one = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -12,
                        1.0 + 3 * 2.0 ** -12, -2.5])
    assert tf32(one).tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0,
                                  1.0 + 2.0 ** -10, -2.5]

"""The port's fused train step (fedmse_tpu_torch/ops/fused_train.py, the
plain PyTorch twin of csrc/fused_train.cu on the CPU) against the JAX
package's `fused_train_grads` (xla and interpret modes) and flax autodiff
of the model loss: the same seeded numpy inputs through both.

Tolerances: loss 1e-6 relative and grads 1e-5 scale-normalized per leaf
(max |diff| / max |reference|) in f32, where summation order is the only
difference. bf16 against mode="xla" at bf16: both round at the same points,
but a last-bit difference in an f32 sum can round an activation or a
cotangent one bf16 ulp (2**-8 relative) the other way, and that flip
carries through the later products; 2**-6 scale-normalized per leaf (four
ulps) and 2**-8 relative on the loss cover it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fedmse_tpu.models import init_client_params, make_model as jax_make_model
from fedmse_tpu.ops.losses import prox_term as jax_prox_term
from fedmse_tpu.ops.pallas_ae import (fused_train_grads as jax_fused_grads,
                                      make_fused_train_loss)
from fedmse_tpu_torch.models.flat import ParamLayout
from fedmse_tpu_torch.ops.fused_train import (FusedTrainLoss, cluster_size,
                                              fused_train_grads,
                                              fused_train_grads_plain)
from fedmse_tpu_torch.ops.losses import prox_term

torch.set_num_threads(1)

LAM = {"autoencoder": 0.0, "hybrid": 10.0}


def _jax_model(model_type, dims, precision="f32"):
    d, h, lat = dims
    return jax_make_model(model_type, d, h, lat, shrink_lambda=10.0,
                          precision=precision)


def _params(model, seed):
    p = init_client_params(model, jax.random.key(seed))
    return jax.tree.map(np.array, p)


def _flat(layout, trees):
    """[G, P] torch buffer from a list of single-client numpy trees."""
    stacked = jax.tree.map(lambda *t: np.stack(t), *trees)
    return layout.flatten(jax.tree.map(torch.from_numpy, stacked))


def _batch(rows, dim, seed, masked=()):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, dim)).astype(np.float32)
    m = np.ones(rows, np.float32)
    m[list(masked)] = 0.0
    return x, m


def _leaf_err(layout, got, want_tree):
    """Worst per-leaf scale-normalized error of flat grads [P] against a
    single-client JAX grad tree."""
    want = layout.flatten(jax.tree.map(
        lambda t: torch.from_numpy(np.array(t, np.float32))[None],
        want_tree))[0]
    return max(float((got[sl] - want[sl]).abs().max()
                     / max(float(want[sl].abs().max()), 1e-30))
               for sl in layout.slices())


@pytest.mark.parametrize("model_type", ["autoencoder", "hybrid"])
# (37, 9, 3) and (16, 3, 2) split unevenly over the kernel's clusters (and
# H = 3 < 8 shrinks them); 129 rows take more than one of its row tiles
@pytest.mark.parametrize("dims", [(16, 8, 3), (115, 27, 7), (37, 9, 3),
                                  (16, 3, 2)])
@pytest.mark.parametrize("rows", [1, 12, 37, 129])
def test_twin_matches_jax_modes_and_autodiff(model_type, dims, rows):
    lam = LAM[model_type]
    layout = ParamLayout(*dims)
    jm = _jax_model(model_type, dims)
    p = _params(jm, rows)
    masked = (1, 5) if rows > 5 else ()
    x, m = _batch(rows, dims[0], seed=rows, masked=masked)
    if rows > 3:
        # a zero latent: the safe norm's gradient is exactly 0 there
        p["encoder"]["Dense_1"]["bias"] = np.zeros_like(
            p["encoder"]["Dense_1"]["bias"])
        x[3] = 0.0
        p["encoder"]["Dense_0"]["bias"] = np.zeros_like(
            p["encoder"]["Dense_0"]["bias"])
    loss, grads = fused_train_grads(_flat(layout, [p]),
                                    torch.from_numpy(x)[None],
                                    torch.from_numpy(m)[None], layout=layout,
                                    shrink_lambda=lam)

    def ref_loss(params):
        latent, recon = jm.apply({"params": params}, jnp.asarray(x))
        return jm.loss(jnp.asarray(x), latent, recon, jnp.asarray(m))

    refs = {"autodiff": jax.value_and_grad(ref_loss)(p)}
    for mode in ("xla", "interpret"):
        refs[mode] = jax_fused_grads(p, jnp.asarray(x), jnp.asarray(m),
                                     shrink_lambda=lam, mode=mode)
    for name, (ref_l, ref_g) in refs.items():
        np.testing.assert_allclose(float(loss[0]), float(ref_l), rtol=1e-6,
                                   err_msg=name)
        assert _leaf_err(layout, grads[0], ref_g) <= 1e-5, name


def test_cohort_of_clients_equals_separate_calls_and_empty_mask():
    """G > 1 in one call equals G separate JAX calls; a client whose rows
    are all masked gets NaN loss and NaN grads, as the JAX entry gives."""
    dims = (16, 8, 3)
    layout = ParamLayout(*dims)
    jm = _jax_model("hybrid", dims)
    ps = [_params(jm, s) for s in range(3)]
    batches = [_batch(12, 16, seed=10 + s, masked=m)
               for s, m in enumerate([(), (0, 7, 11), tuple(range(12))])]
    x = torch.from_numpy(np.stack([b[0] for b in batches]))
    m = torch.from_numpy(np.stack([b[1] for b in batches]))
    loss, grads = fused_train_grads(_flat(layout, ps), x, m, layout=layout,
                                    shrink_lambda=10.0)
    for g in range(3):
        ref_l, ref_g = jax_fused_grads(ps[g], jnp.asarray(batches[g][0]),
                                       jnp.asarray(batches[g][1]),
                                       shrink_lambda=10.0, mode="xla")
        if g == 2:
            assert np.isnan(float(ref_l)) and torch.isnan(loss[g])
            assert torch.isnan(grads[g]).all()
            assert all(np.isnan(np.asarray(t)).all()
                       for t in jax.tree.leaves(ref_g))
            continue
        np.testing.assert_allclose(float(loss[g]), float(ref_l), rtol=1e-6)
        assert _leaf_err(layout, grads[g], ref_g) <= 1e-5
    # a strided batch view (one batch of a [G, NB, B, D] tensor) is taken
    # as it is
    xb = torch.stack([x, torch.zeros_like(x)], dim=1)
    mb = torch.stack([m, torch.zeros_like(m)], dim=1)
    loss2, grads2 = fused_train_grads(_flat(layout, ps), xb[:, 0], mb[:, 0],
                                      layout=layout, shrink_lambda=10.0)
    torch.testing.assert_close(loss2, loss, equal_nan=True)
    torch.testing.assert_close(grads2, grads, equal_nan=True)


@pytest.mark.parametrize("model_type", ["autoencoder", "hybrid"])
def test_bf16_matches_jax_xla_bf16(model_type):
    dims = (115, 27, 7)
    layout = ParamLayout(*dims)
    jm = _jax_model(model_type, dims, precision="bf16")
    p = _params(jm, 4)
    x, m = _batch(12, 115, seed=4, masked=(2,))
    lam = LAM[model_type]
    loss, grads = fused_train_grads(
        _flat(layout, [p]), torch.from_numpy(x).to(torch.bfloat16)[None],
        torch.from_numpy(m)[None], layout=layout, shrink_lambda=lam,
        compute_dtype=torch.bfloat16)
    ref_l, ref_g = jax_fused_grads(p, jnp.asarray(x), jnp.asarray(m),
                                   shrink_lambda=lam, mode="xla",
                                   compute_dtype=jnp.bfloat16)
    np.testing.assert_allclose(float(loss[0]), float(ref_l), rtol=2.0 ** -8)
    assert _leaf_err(layout, grads[0], ref_g) <= 2.0 ** -6
    assert grads.dtype == torch.float32


@pytest.mark.parametrize("model_type", ["autoencoder", "hybrid"])
def test_autograd_function_with_prox_matches_jax_value_and_grad(model_type):
    """torch.autograd.grad of FusedTrainLoss + mu * prox_term equals JAX
    value_and_grad of make_fused_train_loss + mu * prox_term."""
    dims, mu = (16, 8, 3), 0.01
    layout = ParamLayout(*dims)
    jm = _jax_model(model_type, dims)
    p, g0 = _params(jm, 7), _params(jm, 8)
    x, m = _batch(12, 16, seed=7, masked=(4,))
    floss = make_fused_train_loss(jm, mode="xla")

    def jax_total(params):
        return floss(params, jnp.asarray(x), jnp.asarray(m)) \
            + mu * jax_prox_term(params, g0)

    ref_l, ref_g = jax.value_and_grad(jax_total)(p)
    flat = _flat(layout, [p]).requires_grad_(True)
    anchor = _flat(layout, [g0])
    total = (FusedTrainLoss.apply(flat, torch.from_numpy(x)[None],
                                  torch.from_numpy(m)[None], layout,
                                  LAM[model_type], torch.float32)
             + mu * prox_term(flat, anchor)).sum()
    (grad,) = torch.autograd.grad(total, flat)
    np.testing.assert_allclose(float(total.detach()), float(ref_l), rtol=1e-6)
    assert _leaf_err(layout, grad[0], ref_g) <= 1e-5
    # the prox term alone, flat and as a tree, against the JAX package's
    want = float(jax_prox_term(p, g0))
    np.testing.assert_allclose(float(prox_term(flat.detach(), anchor)[0]),
                               want, rtol=1e-6)
    tree = lambda t: jax.tree.map(torch.from_numpy, t)  # noqa: E731
    np.testing.assert_allclose(float(prox_term(tree(p), tree(g0))), want,
                               rtol=1e-6)


def test_plain_twin_is_the_cpu_path_and_checks_inputs():
    layout = ParamLayout(16, 8, 3)
    flat = torch.randn(2, layout.size, generator=torch.Generator()
                       .manual_seed(0)) * 0.2
    x = torch.randn(2, 5, 16)
    m = torch.ones(2, 5)
    before = fused_train_grads.launches
    a = fused_train_grads(flat, x, m, layout=layout, shrink_lambda=5.0)
    b = fused_train_grads_plain(flat, x, m, layout=layout, shrink_lambda=5.0)
    assert fused_train_grads.launches == before  # the CPU never launches
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
    empty = fused_train_grads(flat, x[:, :0], m[:, :0], layout=layout)
    assert torch.isnan(empty[0]).all() and torch.isnan(empty[1]).all()
    with pytest.raises(ValueError, match="compute_dtype"):
        fused_train_grads(flat, x, m, layout=layout,
                          compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="params_flat"):
        fused_train_grads(flat[:, 1:], x, m, layout=layout)
    with pytest.raises(ValueError, match="mask"):
        fused_train_grads(flat, x, m[:, 1:], layout=layout)


def test_cluster_size_rules():
    """1 <= C <= min(8, H); a small cohort gets the widest clusters (8 CTAs
    per client at the main path's G = 5, H = 27); clusters never ask for a
    second wave of the card's 132 SMs, and shrink to 1 once G fills it."""
    assert cluster_size(5, 27) == 8
    assert cluster_size(1, 3) == 3 and cluster_size(512, 27) == 1
    for g in range(1, 700):
        for h in range(1, 40):
            c = cluster_size(g, h)
            assert 1 <= c <= min(8, h)
            assert c == 1 or g * c <= 132
            assert c == 1 or c == min(8, h, 132 // g)
    assert cluster_size(0, 27) == 8

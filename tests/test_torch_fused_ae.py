"""The port's fused AE forward (fedmse_tpu_torch/ops/fused_ae.py) against
the JAX package's `fused_forward_stats`, run as the JAX suite runs it on
the CPU: the Pallas kernel in interpret mode, and its XLA twin.

On CPU tensors the port's wrapper takes the kernel's plain PyTorch version;
the CUDA kernel itself is held against that version on the card
(tests/test_torch_gpu.py, chip_smoke.py).

Tolerances, scale-normalized (max |port - jax| / max |jax| per output):
  * f32 1e-5: the two sides sum in a different order, nothing else.
  * bf16 2**-6: activations round to bf16 between layers, and a sum that
    differs in its last f32 bit can round an activation to the
    neighbouring bf16 value, one bf16 ulp (2**-8 relative) away; four ulps
    cover such a flip carried through the following layers.
Bitwise equality is not asked: the JAX xla and interpret outputs already
differ in the last ulp at one row.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fedmse_tpu.ops.pallas_ae import fused_forward_stats as jax_fused
from fedmse_tpu_torch.models import params_from_numpy
from fedmse_tpu_torch.ops import fused_ae
from fedmse_tpu_torch.ops.fused_ae import fused_forward_stats

torch.set_num_threads(1)

TOL = {"f32": 1e-5, "bf16": 2.0 ** -6}
TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def jax_params(rng, d, h, lat):
    def dense(i, o):
        return {"kernel": rng.uniform(-1, 1, (i, o)).astype(np.float32)
                / np.sqrt(i),
                "bias": rng.normal(0, 0.1, o).astype(np.float32)}
    return {"encoder": {"Dense_0": dense(d, h), "Dense_1": dense(h, lat)},
            "decoder": {"Dense_0": dense(lat, h), "Dense_1": dense(h, d)}}


def stacked(trees):
    return {c: {n: {k: np.stack([t[c][n][k] for t in trees])
                    for k in ("kernel", "bias")}
                for n in ("Dense_0", "Dense_1")}
            for c in ("encoder", "decoder")}


def assert_scaled(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    if want.size == 0:
        return
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)
    assert err <= tol, f"{what}: scaled error {err:.3e} > {tol:.1e}"


@pytest.mark.parametrize("mode", ["interpret", "xla"])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("n_models", [1, 3])
@pytest.mark.parametrize("rows", [0, 1, 13, 600])
def test_plain_fused_matches_jax(mode, precision, n_models, rows):
    d, h, lat = 115, 27, 7
    rng = np.random.default_rng(rows * 10 + n_models)
    trees = [jax_params(rng, d, h, lat) for _ in range(n_models)]
    x = rng.normal(0, 1.5, (rows, d)).astype(np.float32)
    idx = rng.integers(0, n_models, rows).astype(np.int32)

    cdt = TORCH_DT[precision]
    params = params_from_numpy(stacked(trees), device="cpu", dtype=cdt)
    latent, mse, znorm = fused_forward_stats(
        params, torch.from_numpy(x).to(cdt), torch.from_numpy(idx),
        compute_dtype=cdt)
    assert latent.dtype == mse.dtype == znorm.dtype == torch.float32

    want = [np.zeros((rows, lat)), np.zeros(rows), np.zeros(rows)]
    for g in range(n_models):
        sel = idx == g
        out = jax_fused(trees[g], jnp.asarray(x[sel]), latent_dim=lat,
                        mode=mode, compute_dtype=JAX_DT[precision])
        for w, o in zip(want, out):
            w[sel] = np.asarray(o)
    for name, got, w in zip(("latent", "mse", "znorm"),
                            (latent, mse, znorm), want):
        assert_scaled(got.numpy(), w, TOL[precision],
                      f"{name} {mode} {precision} G={n_models} R={rows}")


def test_odd_widths_and_single_model_default():
    """A small odd topology, and model_idx=None scoring every row under
    model 0 (the single-global engine's launch)."""
    d, h, lat = 13, 5, 3
    rng = np.random.default_rng(7)
    trees = [jax_params(rng, d, h, lat) for _ in range(2)]
    x = rng.normal(size=(37, d)).astype(np.float32)
    params = params_from_numpy(stacked(trees), device="cpu")
    got = fused_forward_stats(params, torch.from_numpy(x))
    want = jax_fused(trees[0], jnp.asarray(x), latent_dim=lat, mode="xla")
    for g, w in zip(got, want):
        assert_scaled(g.numpy(), np.asarray(w), TOL["f32"], "odd widths")


def test_cpu_path_never_launches_and_bad_index_gives_nan():
    rng = np.random.default_rng(1)
    params = params_from_numpy(stacked([jax_params(rng, 16, 8, 3)] * 2),
                               device="cpu")
    before = fused_forward_stats.launches
    x = torch.from_numpy(rng.normal(size=(5, 16)).astype(np.float32))
    idx = torch.tensor([0, 1, 2, -1, 1], dtype=torch.int32)
    latent, mse, znorm = fused_forward_stats(params, x, idx)
    assert fused_forward_stats.launches == before
    assert torch.isnan(mse[[2, 3]]).all() and torch.isnan(znorm[[2, 3]]).all()
    assert torch.isnan(latent[[2, 3]]).all()
    assert torch.isfinite(mse[[0, 1, 4]]).all()
    empty = fused_forward_stats(params, x[:0], idx[:0])
    assert [tuple(t.shape) for t in empty] == [(0, 3), (0,), (0,)]


@pytest.mark.parametrize("widths", [(129, 8, 3), (16, 129, 3), (16, 8, 127)])
def test_oversize_shapes_raise(widths):
    d, h, lat = widths
    rng = np.random.default_rng(2)
    params = params_from_numpy(jax_params(rng, d, h, lat), device="cpu")
    with pytest.raises(ValueError, match="fused AE kernel takes"):
        fused_forward_stats(params, torch.zeros((4, d)))


def test_rejects_wrong_dtypes_and_shapes():
    rng = np.random.default_rng(3)
    params = params_from_numpy(jax_params(rng, 16, 8, 3), device="cpu")
    x = torch.zeros((4, 16))
    with pytest.raises(ValueError, match="the kernel takes"):
        fused_forward_stats(params, x.bfloat16(), compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="model_idx"):
        fused_forward_stats(params, x, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="features"):
        fused_forward_stats(params, torch.zeros((4, 15)))


def test_module_imports_without_cuda_or_nvcc():
    """Nothing builds at import: the library is built by the first CUDA
    tensor that reaches the wrapper."""
    assert fused_ae._library.cache_info().currsize == 0
    assert fused_ae.native.KERNEL_SOURCES == ("fused_ae", "fused_train",
                                              "dist_tiles", "adam_update",
                                              "kitnet")


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("layout", ["client_major", "random"])
def test_plain_fused_matches_jax_at_main_path_layouts(precision, layout):
    """The main path's two layouts of one launch: client-major rows (the
    evaluator's, the vote's, validation's: 3 clients of 45 rows, so client
    boundaries fall inside the kernel's 8- to 128-row tiles) and a routed
    bucket over many models (40 models, 200 rows)."""
    d, h, lat = 115, 27, 7
    n_models, rows = (3, 135) if layout == "client_major" else (40, 200)
    rng = np.random.default_rng(11 + n_models)
    trees = [jax_params(rng, d, h, lat) for _ in range(n_models)]
    x = rng.normal(0, 1.5, (rows, d)).astype(np.float32)
    if layout == "client_major":
        idx = np.repeat(np.arange(n_models), rows // n_models).astype(np.int32)
    else:
        idx = rng.integers(0, n_models, rows).astype(np.int32)
    cdt = TORCH_DT[precision]
    params = params_from_numpy(stacked(trees), device="cpu", dtype=cdt)
    got = fused_forward_stats(params, torch.from_numpy(x).to(cdt),
                              torch.from_numpy(idx), compute_dtype=cdt)
    want = [np.zeros((rows, lat)), np.zeros(rows), np.zeros(rows)]
    for g in range(n_models):
        sel = idx == g
        out = jax_fused(trees[g], jnp.asarray(x[sel]), latent_dim=lat,
                        mode="xla", compute_dtype=JAX_DT[precision])
        for w, o in zip(want, out):
            w[sel] = np.asarray(o)
    for name, g, w in zip(("latent", "mse", "znorm"), got, want):
        assert_scaled(g.numpy(), w, TOL[precision],
                      f"{name} {layout} {precision}")


@pytest.mark.parametrize("rows, tile, ctas", [
    (1, 8, 1), (65, 8, 9), (256, 8, 32), (1024, 8, 128), (5_040, 32, 158),
    (10_000, 64, 157), (35_040, 64, 264), (70_080, 64, 264),
    (200_000, 64, 264)])
def test_tile_plan_rules(rows, tile, ctas):
    """Tiles halve from 64 rows to 8 until the launch has one per SM; at
    most two CTAs per SM, each walking a contiguous run of tiles."""
    assert fused_ae.tile_plan(rows, 132) == (tile, ctas)


def test_tile_plan_covers_every_row_on_any_card():
    for sms in (1, 16, 108, 132):
        for rows in (1, 7, 8, 9, 255, 1000, 4097, 70_080, 1_000_003):
            tile, ctas = fused_ae.tile_plan(rows, sms)
            tiles = -(-rows // tile)
            assert tile in (8, 16, 32, 64)
            assert 1 <= ctas <= min(tiles, 2 * sms)
            # a larger tile only where it still gives one per SM
            assert tile == 8 or tiles >= sms


def test_wrapper_enters_no_device_context():
    """The launch passes the device index and the current raw stream to
    the C entry: no torch.cuda.device context and no stream object per
    call."""
    import inspect
    src = inspect.getsource(fused_ae.fused_forward_stats)
    assert "torch.cuda.device(" not in src
    assert "current_stream" not in src
    assert "_cuda_getCurrentRawStream" in src

"""CUDA kernel tests of the port: they need an NVIDIA card and nvcc and skip
without them. This file imports neither jax nor the JAX package, so on a
machine with a card and no JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances as in chip_smoke.py: scale-normalized 1e-5 in f32 (summation
order only) and 2**-6 in bf16 (a bf16 rounding flip between layers); the
distance kernel 1e-5 in both (its math is f32 for bf16 queries too); a
whole training run on the card against the CPU, 1e-4 per leaf and 2e-3
AUC (summation order compounded over the run's Adam steps).
"""

import numpy as np
import pytest
import torch

from fedmse_tpu_torch.data import stack_clients, synthetic_clients
from fedmse_tpu_torch.evaluation import make_evaluate_all
from fedmse_tpu_torch.models import init_stacked_params, make_model
from fedmse_tpu_torch.models.flat import ParamLayout
from fedmse_tpu_torch.ops.fused_ae import (fused_forward_stats,
                                           fused_forward_stats_plain)
from fedmse_tpu_torch.ops.fused_train import (fused_train_grads,
                                              fused_train_grads_plain)
from fedmse_tpu_torch.ops.precision import cast_params
from fedmse_tpu_torch.serving import ServingEngine

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _params(g, d, h, lat, cdt, device, seed=0):
    gen = torch.Generator().manual_seed(seed)

    def dense(i, o):
        return {"kernel": (torch.rand((g, i, o), generator=gen) * 2 - 1)
                / i ** 0.5, "bias": torch.randn((g, o), generator=gen) * 0.1}
    tree = {"encoder": {"Dense_0": dense(d, h), "Dense_1": dense(h, lat)},
            "decoder": {"Dense_0": dense(lat, h), "Dense_1": dense(h, d)}}
    return {c: {n: {k: v.to(device) for k, v in layer.items()}
                for n, layer in coder.items()}
            for c, coder in cast_params(tree, cdt).items()}


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 115, 27, 7, 1), (5, 115, 27, 7, 333),
                                   (3, 13, 5, 3, 70), (2, 128, 128, 126, 65)])
def test_kernel_matches_plain_and_counts(cuda, cdt, shape):
    g, d, h, lat, rows = shape
    params = _params(g, d, h, lat, cdt, cuda)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((rows, d), generator=gen).to(cuda, cdt)
    idx = torch.randint(0, g, (rows,), generator=gen,
                        dtype=torch.int32).to(cuda)
    before = fused_forward_stats.launches
    got = fused_forward_stats(params, x, idx, compute_dtype=cdt)
    assert fused_forward_stats.launches == before + 1
    want = fused_forward_stats_plain(params, x, idx, compute_dtype=cdt)
    for a, b in zip(got, want):
        err = (a - b).abs().max() / b.abs().max().clamp_min(1e-30)
        assert err <= TOL[cdt]


def test_kernel_edges(cuda):
    params = _params(2, 16, 8, 3, torch.float32, cuda)
    x = torch.randn((4, 16), device=cuda)
    before = fused_forward_stats.launches
    empty = fused_forward_stats(params, x[:0])
    assert [tuple(t.shape) for t in empty] == [(0, 3), (0,), (0,)]
    assert fused_forward_stats.launches == before
    idx = torch.tensor([0, 1, 2, -1], dtype=torch.int32, device=cuda)
    _, mse, _ = fused_forward_stats(params, x, idx)
    assert torch.isnan(mse[2:]).all() and torch.isfinite(mse[:2]).all()
    with pytest.raises(ValueError, match="contiguous"):
        fused_forward_stats(params, torch.randn((16, 4), device=cuda).T)


def _grid_params(g, d, h, lat, cdt, device, seed=0):
    """Weights and biases in Z/16, |v| <= 1/4: with x in Z/4 the forward is
    exact up to its ReLU gates in f32, so two summation orders gate alike."""
    gen = torch.Generator().manual_seed(seed)

    def grid(shape):
        return torch.randint(-4, 5, shape, generator=gen) / 16.0

    tree = {"encoder": {"Dense_0": {"kernel": grid((g, d, h)),
                                    "bias": grid((g, h))},
                        "Dense_1": {"kernel": grid((g, h, lat)),
                                    "bias": grid((g, lat))}},
            "decoder": {"Dense_0": {"kernel": grid((g, lat, h)),
                                    "bias": grid((g, h))},
                        "Dense_1": {"kernel": grid((g, h, d)),
                                    "bias": grid((g, d))}}}
    return {c: {n: {k: v.to(device) for k, v in layer.items()}
                for n, layer in coder.items()}
            for c, coder in cast_params(tree, cdt).items()}


def _forward_inputs(layout, cdt, device, seed=5):
    """(params, x, model_idx) of one forward launch. layout: (kind, G,
    rows, D, H, L); kind 'client_major' (G clients' rows in order, as every
    launch outside serving: boundaries fall mid-tile when rows per client
    are not a multiple of the tile), 'random' (a routed serving bucket) or
    'none' (every row model 0). f32 runs on dyadic grids, bf16 on floats."""
    kind, g, rows, d, h, lat = layout
    gen = torch.Generator().manual_seed(seed)
    if cdt == torch.float32:
        params = _grid_params(g, d, h, lat, cdt, device, seed)
        x = torch.randint(-6, 7, (rows, d), generator=gen) / 4.0
    else:
        params = _params(g, d, h, lat, cdt, device, seed)
        x = torch.randn((rows, d), generator=gen) * 1.5
    idx = None
    if kind == "client_major":
        idx = torch.arange(g, dtype=torch.int32).repeat_interleave(
            -(-rows // g))[:rows]
    elif kind == "random":
        idx = torch.randint(0, g, (rows,), generator=gen, dtype=torch.int32)
    return (params, x.to(device, cdt),
            None if idx is None else idx.to(device))


# (kind, G, R, D, H, L): the evaluation (70,080 rows: 64-row tiles, client
# boundaries every 7,008 rows, mid-tile; a partial last tile), dev scoring,
# the vote (10 x 1,000: 64-row tiles, boundaries mid-tile), validation (5 x
# 1,008), a single-global bucket, the routed serving buckets, a 1,001-row
# client layout, odd and the widest accepted widths
FORWARD_LAYOUTS = [
    ("client_major", 10, 70_080, 115, 27, 7),
    ("client_major", 5, 35_040, 115, 27, 7),
    ("client_major", 10, 10_000, 115, 27, 7),
    ("client_major", 5, 5_040, 115, 27, 7),
    ("client_major", 3, 3_003, 115, 27, 7),
    ("none", 1, 1_000, 115, 27, 7),
    ("random", 10, 256, 115, 27, 7),
    ("random", 512, 1024, 115, 27, 7),
    ("client_major", 4, 999, 13, 5, 3),
    ("random", 3, 77, 13, 5, 3),
    ("client_major", 2, 4_100, 128, 128, 126),
    ("random", 2, 65, 128, 128, 126),
]


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", FORWARD_LAYOUTS)
def test_forward_kernel_tiles_match_plain(cuda, cdt, layout):
    """Uniform tiles (staged weights: FFMA in f32, mma.sync in bf16), mixed
    tiles (warp per row) and tiles across a model boundary, against the
    plain version; one launch per call; a second call equal bit for bit."""
    params, x, idx = _forward_inputs(layout, cdt, cuda)
    before = fused_forward_stats.launches
    got = fused_forward_stats(params, x, idx, compute_dtype=cdt)
    again = fused_forward_stats(params, x, idx, compute_dtype=cdt)
    assert fused_forward_stats.launches == before + 2
    want = fused_forward_stats_plain(params, x, idx, compute_dtype=cdt)
    for a, a2, b in zip(got, again, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert torch.isfinite(a).all()
        assert torch.equal(a.view(torch.int32), a2.view(torch.int32))
        err = (a - b).abs().max() / b.abs().max().clamp_min(1e-30)
        assert err <= TOL[cdt], (layout, err)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", [FORWARD_LAYOUTS[0], FORWARD_LAYOUTS[3],
                                    FORWARD_LAYOUTS[6], FORWARD_LAYOUTS[7]])
def test_forward_kernel_is_one_kernel_per_call(cuda, cdt, layout):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    params, x, idx = _forward_inputs(layout, cdt, cuda)
    call = lambda: fused_forward_stats(params, x, idx,  # noqa: E731
                                       compute_dtype=cdt)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and "fused_ae_forward_kernel" in kernels[0], \
        kernels


@pytest.mark.parametrize("rows", [1_000, 10_000, 70_080])
def test_forward_kernel_f32_paths_agree_bitwise(cuda, rows):
    """A row's f32 outputs do not depend on the kind of tile it lands in:
    client-major rows (uniform tiles, staged weights) and the same rows in
    a routed order (mixed tiles, warp per row) give the same bits, so a
    served score equals the evaluator's."""
    g = 10
    params = _params(g, 115, 27, 7, torch.float32, cuda, seed=9)
    gen = torch.Generator().manual_seed(9)
    x = torch.randn((rows, 115), generator=gen).to(cuda)
    idx = torch.arange(g, dtype=torch.int32).repeat_interleave(
        -(-rows // g))[:rows].to(cuda)
    perm = torch.randperm(rows, generator=gen).to(cuda)
    grouped = fused_forward_stats(params, x, idx)
    routed = fused_forward_stats(params, x[perm].contiguous(),
                                 idx[perm].contiguous())
    for a, b in zip(grouped, routed):
        assert torch.equal(a[perm].view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("tile", [0, 4, 24, 128])
def test_forward_entry_takes_only_the_plans_tiles(cuda, tile):
    """The C entry refuses a tile size that tile_plan never gives (it gives
    8, 16, 32 or 64 rows) before it touches a pointer."""
    from fedmse_tpu_torch.ops import fused_ae
    rc = fused_ae._library().fused_ae_forward(
        *([None] * 13), 256, 10, 115, 27, 7, tile, 32, 0, cuda.index, None)
    assert fused_ae._library().fused_ae_error_string(rc) \
        == b"invalid argument"


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["client_major", "random"])
def test_forward_kernel_bad_index_gives_nan(cuda, cdt, kind):
    """NaN in all three outputs for an index outside [0, G): a whole
    client's rows (uniform tiles of a bad model), scattered rows inside
    otherwise uniform tiles, and rows of a routed bucket; every other row
    as the plain version."""
    layout = (kind, 6, 6_000, 115, 27, 7)
    params, x, idx = _forward_inputs(layout, cdt, cuda)
    bad = torch.zeros(x.shape[0], dtype=torch.bool, device=cuda)
    if kind == "client_major":
        bad[3_000:4_000] = True          # client 3, whole tiles
    bad[torch.arange(17, 6_000, 613, device=cuda)] = True
    idx = torch.where(bad, torch.where(torch.arange(
        x.shape[0], device=cuda) % 2 == 0, -1, 6), idx).to(torch.int32)
    got = fused_forward_stats(params, x, idx, compute_dtype=cdt)
    want = fused_forward_stats_plain(params, x, idx, compute_dtype=cdt)
    for a, b in zip(got, want):
        rows_bad = a[bad]
        assert torch.isnan(rows_bad).all() and torch.isnan(b[bad]).all()
        a, b = a[~bad], b[~bad]
        assert torch.isfinite(a).all()
        err = (a - b).abs().max() / b.abs().max().clamp_min(1e-30)
        assert err <= TOL[cdt]


@pytest.mark.parametrize("model_type", ["autoencoder", "hybrid"])
def test_evaluation_and_serving_on_card_match_cpu(cuda, model_type):
    clients = synthetic_clients(n_clients=3, dim=20, n_normal=200,
                                n_abnormal=50, seed=2)
    out = {}
    for device in ("cpu", cuda):
        model = make_model(model_type, 20, 9, 4, device=device)
        params = init_stacked_params(model, 3,
                                     torch.Generator().manual_seed(3),
                                     device=device)
        data = stack_clients(clients, np.zeros((1, 20), np.float32), 12,
                             device=device)
        scores = make_evaluate_all(model, model_type, metric="scores")(
            params, data.test_x, data.test_m, data.test_y, data.train_xb,
            data.train_mb).cpu()
        engine = ServingEngine.from_federation(
            model, model_type, params, data.train_xb, data.train_mb,
            max_bucket=64, device=device)
        rows = data.test_x[1, :100].cpu().numpy()
        out[str(device)] = (scores, engine.score(rows, 1))
    (s_cpu, e_cpu), (s_gpu, e_gpu) = out["cpu"], out[str(cuda)]
    torch.testing.assert_close(s_gpu, s_cpu, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(e_gpu, e_cpu, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(e_gpu, s_gpu[1, :100].numpy(), rtol=1e-5,
                               atol=1e-5)


def _flat_params(layout, g, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    flat = torch.rand((g, layout.size), generator=gen) * 0.6 - 0.3
    for sl, (path, _, _) in zip(layout.slices(), layout.leaves()):
        if path[-1] == "bias":  # non-zero biases exercise every add
            flat[:, sl] = torch.randn((g, sl.stop - sl.start),
                                      generator=gen) * 0.1
    return flat.to(device)


# (G, D, H, L, R): uneven hidden slices (27 or 9 units over 8 CTAs), H < 8
# (3 units: clusters of 3), 129 and 1,008 rows (row tiles walked inside one
# launch), G = 133 and 512 (one CTA per client), and (128, 128, 120), whose
# parameters and gradient overflow one CTA's shared memory but whose slices
# fit
TRAIN_SHAPES = [(1, 115, 27, 7, 12), (5, 115, 27, 7, 12), (3, 37, 9, 3, 200),
                (512, 115, 27, 7, 12), (2, 16, 8, 3, 1), (5, 37, 9, 3, 12),
                (5, 16, 3, 2, 12), (2, 115, 27, 7, 129), (1, 16, 3, 2, 129),
                (1, 115, 27, 7, 1008), (133, 115, 27, 7, 12),
                (1, 128, 128, 120, 4)]


def _train_inputs(shape, cdt, device):
    g, d, h, lat, rows = shape
    layout = ParamLayout(d, h, lat)
    flat = _flat_params(layout, g, device)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((g, rows, d), generator=gen).to(device, cdt)
    mask = (torch.rand((g, rows), generator=gen) < 0.8).float().to(device)
    if g > 1:
        mask[-1] = 0.0  # an all-masked client: NaN, as in the reference
    return layout, flat, x, mask


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lam", [0.0, 10.0])
@pytest.mark.parametrize("shape", TRAIN_SHAPES)
def test_train_kernel_matches_plain_and_counts(cuda, cdt, lam, shape):
    layout, flat, x, mask = _train_inputs(shape, cdt, cuda)
    before = fused_train_grads.launches
    loss, grads = fused_train_grads(flat, x, mask, layout=layout,
                                    shrink_lambda=lam, compute_dtype=cdt)
    assert fused_train_grads.launches == before + 1
    want_l, want_g = fused_train_grads_plain(flat, x, mask, layout=layout,
                                             shrink_lambda=lam,
                                             compute_dtype=cdt)
    live = mask.sum(dim=1) > 0
    assert torch.isnan(loss[~live]).all() and torch.isnan(grads[~live]).all()
    for a, b in ((loss[live], want_l[live]), (grads[live], want_g[live])):
        err = (a - b).abs().max() / b.abs().max().clamp_min(1e-30)
        assert err <= TOL[cdt]


def test_train_kernel_edges(cuda):
    layout = ParamLayout(16, 8, 3)
    flat = _flat_params(layout, 3, cuda)
    x = torch.randn((3, 0, 16), device=cuda)
    before = fused_train_grads.launches
    loss, grads = fused_train_grads(flat, x, torch.zeros((3, 0),
                                                         device=cuda),
                                    layout=layout)
    assert fused_train_grads.launches == before
    assert torch.isnan(loss).all() and grads.shape == (3, layout.size)
    # at H = 8, L = 4 a CTA holds one hidden unit; its slices and a one-row
    # tile take about 4 (10 D + 150) bytes, beyond the card's 227 KB from
    # D ~ 5,800
    wide = ParamLayout(8192, 8, 4)
    with pytest.raises(ValueError, match="too wide"):
        fused_train_grads(torch.zeros((1, wide.size), device=cuda),
                          torch.zeros((1, 4, 8192), device=cuda),
                          torch.ones((1, 4), device=cuda), layout=wide)
    assert fused_train_grads.launches == before


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(5, 115, 27, 7, 12), (2, 115, 27, 7, 129),
                                   (5, 16, 3, 2, 12), (512, 115, 27, 7, 12)])
def test_train_kernel_is_bitwise_repeatable(cuda, cdt, shape):
    """No atomics and fixed sum orders: the same inputs give the same bits."""
    layout, flat, x, mask = _train_inputs(shape, cdt, cuda)
    kw = dict(layout=layout, shrink_lambda=10.0, compute_dtype=cdt)
    first = fused_train_grads(flat, x, mask, **kw)
    for _ in range(3):
        again = fused_train_grads(flat, x, mask, **kw)
        for a, b in zip(first, again):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("shape", [(5, 115, 27, 7, 12), (1, 115, 27, 7, 1008),
                                   (512, 115, 27, 7, 12)])
def test_train_kernel_is_one_kernel_per_call(cuda, shape):
    """One call runs exactly one CUDA kernel, whatever R: no second pass
    and no torch op after the launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    layout, flat, x, mask = _train_inputs(shape, torch.float32, cuda)
    call = lambda: fused_train_grads(flat, x, mask, layout=layout,  # noqa: E731
                                     shrink_lambda=10.0)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and "fused_ae_train_kernel" in kernels[0], \
        kernels


@pytest.mark.parametrize("update_type", ["mse_avg", "fedprox"])
def test_run_combination_on_card_matches_cpu(cuda, update_type):
    """One training combination on the card and on the CPU twins from one
    init: params 1e-4 scale-normalized per leaf after the run, AUC 2e-3."""
    from fedmse_tpu_torch.config import ExperimentConfig
    from fedmse_tpu_torch.federation import init_client_states
    from fedmse_tpu_torch.main import run_combination
    cfg = ExperimentConfig(dim_features=16, hidden_neus=8, latent_dim=3,
                           network_size=4, num_rounds=2, epochs=3)
    clients = synthetic_clients(n_clients=4, dim=16, n_normal=240,
                                n_abnormal=120, seed=0)
    dev_x = np.concatenate([c.dev_raw for c in clients])[:200].astype(
        np.float32)
    init = init_client_states(make_model("hybrid", 16, 8, 3, device="cpu"),
                              4, torch.Generator().manual_seed(1),
                              device="cpu")
    outs = {}
    for device in ("cpu", cuda):
        data = stack_clients(clients, dev_x, 12, device=device)
        states = init.to(device)
        before = fused_train_grads.launches
        out = run_combination(cfg, data, 4, "hybrid", update_type, 0,
                              states=states)
        launched = fused_train_grads.launches - before
        outs[str(device)] = (out, launched)
    (cpu, n_cpu), (gpu, n_gpu) = outs["cpu"], outs[str(cuda)]
    assert n_cpu == 0 and n_gpu > 0
    layout = ParamLayout(16, 8, 3)
    a = gpu["engine"].states.params.cpu()
    b = cpu["engine"].states.params
    for sl in layout.slices():
        assert (a[:, sl] - b[:, sl]).abs().max() <= 1e-4 * b[:, sl].abs().max()
    np.testing.assert_allclose(gpu["final_metrics"], cpu["final_metrics"],
                               atol=2e-3)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gw_kind", ["none", "client_major", "random"])
@pytest.mark.parametrize("shape", [(1, 1, 1, 7), (10, 1000, 512, 7),
                                   (512, 1024, 512, 7), (3, 77, 100, 3),
                                   (4, 300, 1024, 128)])
def test_dist_kernel_matches_plain_and_counts(cuda, cdt, gw_kind, shape):
    from fedmse_tpu_torch.knn.score import dist_tiles, dist_tiles_plain
    n, t, b, lat = shape
    gen = torch.Generator().manual_seed(4)
    q = torch.randn((t, lat), generator=gen).to(cuda, cdt)
    banks = torch.randn((n, b, lat), generator=gen).to(cuda)
    gw = {"none": None,
          "client_major": torch.arange(n, dtype=torch.int32).repeat_interleave(
              -(-t // n))[:t].to(cuda),
          "random": torch.randint(0, n, (t,), generator=gen,
                                  dtype=torch.int32).to(cuda)}[gw_kind]
    before = dist_tiles.launches
    got = dist_tiles(q, banks, gw)
    assert dist_tiles.launches == before + 1
    want = dist_tiles_plain(q, banks, gw)
    assert got.shape == (t, b) and got.dtype == torch.float32
    err = (got - want).abs().max() / want.abs().max().clamp_min(1e-30)
    assert err <= 1e-5


def test_dist_kernel_edges(cuda):
    from fedmse_tpu_torch.knn.score import dist_tiles
    banks = torch.randn((2, 16, 7), device=cuda)
    q = torch.randn((5, 7), device=cuda)
    before = dist_tiles.launches
    assert dist_tiles(q[:0], banks).shape == (0, 16)
    assert dist_tiles.launches == before
    gw = torch.tensor([0, 1, 2, -1, 1], dtype=torch.int32, device=cuda)
    out = dist_tiles(q, banks, gw)
    assert torch.isnan(out[2:4]).all() and torch.isfinite(out[[0, 1, 4]]).all()
    assert (out[[0, 1, 4]] >= 0).all()
    with pytest.raises(ValueError, match="latent_dim"):
        dist_tiles(torch.zeros((2, 129), device=cuda),
                   torch.zeros((1, 4, 129), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        dist_tiles(torch.randn((7, 5), device=cuda).T, banks)


@pytest.mark.parametrize("topk", ["exact", "approx"])
def test_knn_evaluation_and_serving_on_card_match_cpu(cuda, topk):
    from fedmse_tpu_torch.knn.score import dist_tiles
    clients = synthetic_clients(n_clients=3, dim=20, n_normal=400,
                                n_abnormal=50, seed=2)
    out = {}
    for device in ("cpu", cuda):
        model = make_model("hybrid", 20, 9, 4, device=device)
        params = init_stacked_params(model, 3,
                                     torch.Generator().manual_seed(3),
                                     device=device)
        data = stack_clients(clients, np.zeros((1, 20), np.float32), 12,
                             device=device)
        kw = dict(score_kind="knn", knn_bank_size=64, knn_k=8,
                  knn_topk=topk)
        before = dist_tiles.launches
        scores = make_evaluate_all(model, "hybrid", metric="scores", **kw)(
            params, data.test_x, data.test_m, data.test_y, data.train_xb,
            data.train_mb).cpu()
        launched = dist_tiles.launches - before
        engine = ServingEngine.from_federation(
            model, "hybrid", params, data.train_xb, data.train_mb,
            max_bucket=64, device=device, **kw)
        rows = data.test_x[1, :100].cpu().numpy()
        out[str(device)] = (scores, engine.score(rows, 1), launched,
                            engine.banks.latents.cpu())
    (s_cpu, e_cpu, n_cpu, b_cpu) = out["cpu"]
    (s_gpu, e_gpu, n_gpu, b_gpu) = out[str(cuda)]
    assert n_cpu == 0 and n_gpu == 1
    # the bank draw is made on the CPU: the same rows on both, up to the
    # latents' summation order
    torch.testing.assert_close(b_gpu, b_cpu, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s_gpu, s_cpu, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(e_gpu, e_cpu, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(e_gpu, s_gpu[1, :100].numpy(), rtol=1e-5,
                               atol=1e-5)

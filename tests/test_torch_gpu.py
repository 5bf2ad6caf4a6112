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


def _dist_case(n, t, b, lat, cdt, gw_kind, device, seed=4):
    gen = torch.Generator().manual_seed(seed)
    q = (torch.randn((t, lat), generator=gen) * 1.5).to(device, cdt)
    banks = torch.randn((n, b, lat), generator=gen).to(device)
    gw = {"none": None,
          "client_major": torch.arange(n, dtype=torch.int32).repeat_interleave(
              -(-t // n))[:t],
          "random": torch.randint(0, n, (t,), generator=gen,
                                  dtype=torch.int32)}[gw_kind]
    return q, banks, None if gw is None else gw.to(device)


def _dist_err(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)
            ).item()


# B x L x T around the plan's edges: 1, 3, 100 and 1,024 slots (one warp,
# a ragged group, a partial warp, the whole CTA), L = 1, 7 (registers), 16
# and 128 (streamed), rows around a warp's 32-row batch and an 8-row pass
DIST_GRID = [(b, lat, t) for b in (1, 3, 100, 1024) for lat in (1, 7, 16, 128)
             for t in (1, 63, 64, 65) + ((30_000,) if lat <= 7 else ())]


@pytest.mark.parametrize("case", range(len(DIST_GRID)))
def test_dist_kernel_grid_matches_plain(cuda, case):
    from fedmse_tpu_torch.knn.score import dist_tiles, dist_tiles_plain
    b, lat, t = DIST_GRID[case]
    cdt = (torch.float32, torch.bfloat16)[case % 2]
    gw_kind = ("random", "client_major", "none")[case % 3]
    q, banks, gw = _dist_case(5, t, b, lat, cdt, gw_kind, cuda, seed=case)
    got = dist_tiles(q, banks, gw)
    want = dist_tiles_plain(q, banks, gw)
    assert got.shape == (t, b) and torch.isfinite(got).all()
    assert _dist_err(got, want) <= 1e-5


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(10, 30_000, 512, 7), (512, 1024, 512, 7),
                                   (3, 77, 100, 3), (4, 300, 1024, 128)])
def test_dist_kernel_is_bitwise_repeatable(cuda, cdt, shape):
    from fedmse_tpu_torch.knn.score import dist_tiles
    n, t, b, lat = shape
    q, banks, gw = _dist_case(n, t, b, lat, cdt, "random", cuda)
    first = dist_tiles(q, banks, gw)
    assert torch.equal(dist_tiles(q, banks, gw).view(torch.int32),
                       first.view(torch.int32))


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(10, 30_000, 512, 7), (10, 256, 512, 7),
                                   (512, 1024, 512, 7), (4, 300, 1024, 128)])
def test_dist_kernel_is_one_kernel_per_call(cuda, cdt, shape):
    """One CUDA kernel per call in either dtype: bf16 queries are read and
    upcast by the kernel, with no conversion launched before it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fedmse_tpu_torch.knn.score import dist_tiles
    n, t, b, lat = shape
    q, banks, gw = _dist_case(n, t, b, lat, cdt, "random", cuda)
    dist_tiles(q, banks, gw)
    torch.cuda.synchronize()
    for _ in range(3):  # a window the profiler dropped is taken again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            dist_tiles(q, banks, gw)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        if kernels:
            break
    assert len(kernels) == 1 and "dist_tiles" in kernels[0], kernels


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(10, 30_000, 512, 7), (10, 1000, 100, 7),
                                   (4, 300, 1024, 128), (3, 500, 8, 3)])
def test_dist_kernel_paths_agree_bitwise(cuda, cdt, shape):
    """A row's distances are the same bits whichever tile computes them:
    client-major rows (a bank kept across rows), the same rows permuted
    (routed: a bank loaded per row) and a misaligned copy of the banks
    (scalar loads and stores) all give the evaluator's bits."""
    from fedmse_tpu_torch.knn.score import dist_tiles, dist_tiles_plain
    n, t, b, lat = shape
    q, banks, gw = _dist_case(n, t, b, lat, cdt, "client_major", cuda)
    grouped = dist_tiles(q, banks, gw)
    perm = torch.randperm(t, generator=torch.Generator().manual_seed(1)
                          ).to(cuda)
    routed = dist_tiles(q[perm].contiguous(), banks, gw[perm].contiguous())
    assert torch.equal(routed.view(torch.int32),
                       grouped[perm].view(torch.int32))
    flat = torch.empty(banks.numel() + 1, device=cuda)
    flat[1:] = banks.reshape(-1)
    shifted = flat[1:].view(banks.shape)  # 4 bytes past a 16-byte boundary
    assert shifted.data_ptr() % 16 != 0
    assert torch.equal(dist_tiles(q, shifted, gw).view(torch.int32),
                       grouped.view(torch.int32))
    assert _dist_err(grouped, dist_tiles_plain(q, banks, gw)) <= 1e-5


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_dist_kernel_some_gateways_unused(cuda, cdt):
    """20 banks of which a bucket routes to three, plus rows whose index
    lies outside [0, 20): those rows are NaN, every other row as the plain
    version, and unused banks change nothing."""
    from fedmse_tpu_torch.knn.score import dist_tiles, dist_tiles_plain
    gen = torch.Generator().manual_seed(7)
    q = torch.randn((1024, 7), generator=gen).to(cuda, cdt)
    banks = torch.randn((20, 512, 7), generator=gen).to(cuda)
    used = torch.tensor([3, 7, 19], dtype=torch.int32)
    gw = used[torch.randint(0, 3, (1024,), generator=gen)]
    gw[::97] = torch.tensor([-1, 20], dtype=torch.int32).repeat(6)[:11]
    gw = gw.to(cuda)
    got = dist_tiles(q, banks, gw)
    bad = (gw < 0) | (gw >= 20)
    assert torch.isnan(got[bad]).all() and torch.isfinite(got[~bad]).all()
    want = dist_tiles_plain(q, banks, gw)
    assert _dist_err(got[~bad], want[~bad]) <= 1e-5
    other = banks.clone()
    other[[0, 1, 2, 4, 5]] = 1e6  # banks no row routes to
    assert torch.equal(dist_tiles(q, other, gw).view(torch.int32),
                       got.view(torch.int32))


@pytest.mark.parametrize("change", ["groups", "ctas", "ctas_zero",
                                    "streaming", "q_bf16", "device"])
def test_dist_entry_refuses_plans_dist_plan_would_not_give(cuda, change):
    """The C entry takes only dist_plan's plan for (rows, B, L) on this
    card, and refuses any other before it touches a pointer."""
    from fedmse_tpu_torch.knn import score
    rows, b, lat = 30_000, 512, 7
    groups, ctas, streaming = score.dist_plan(
        rows, b, lat, score._sm_count(cuda.index))
    args = dict(groups=groups, ctas=ctas, streaming=int(streaming),
                q_bf16=0, device=cuda.index)
    args.update({"groups": dict(groups=groups * 2),
                 "ctas": dict(ctas=ctas - 1), "ctas_zero": dict(ctas=0),
                 "streaming": dict(streaming=1 - int(streaming)),
                 "q_bf16": dict(q_bf16=2), "device": dict(device=64)}[change])
    lib = score._library()
    rc = lib.dist_tiles(None, None, None, None, rows, 10, b, lat,
                        args["q_bf16"], args["groups"], args["ctas"],
                        args["streaming"], args["device"], None)
    assert lib.dist_tiles_error_string(rc) == b"invalid argument"


# ---- CUDA graphs: the kernels and the fused round captured and replayed ----

def _bits(t):
    """A tensor's bits, for bitwise comparisons (NaN included)."""
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


def _captured(fn, outs):
    """fn() writing `outs` in place, wrapped as a CapturedBody."""
    from fedmse_tpu_torch.ops.graphs import CapturedBody
    return CapturedBody(fn, outs[0].device, "test")


@pytest.mark.parametrize("kernel", ["fused_ae_forward", "fused_ae_train",
                                    "dist_tiles"])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_wrapper_captured_alone_replays_its_call(cuda, kernel, cdt):
    """Each wrapper captured alone in a CUDA graph: the replay gives a
    direct call's bits, the capture counts in `captured` and not in
    `launches`, and every replay adds one launch."""
    from fedmse_tpu_torch.knn.score import dist_tiles
    from fedmse_tpu_torch.ops.graphs import WRAPPERS
    wrapper = WRAPPERS[kernel]
    if kernel == "fused_ae_forward":
        params = _params(10, 115, 27, 7, cdt, cuda)
        x = torch.randn((10 * 1000, 115), device=cuda).to(cdt)
        idx = torch.randint(0, 10, (10 * 1000,), dtype=torch.int32,
                            device=cuda)

        def call():
            return fused_forward_stats(params, x, idx, compute_dtype=cdt)
    elif kernel == "fused_ae_train":
        layout, flat, x, mask = _train_inputs((5, 115, 27, 7, 12), cdt, cuda)

        def call():
            return fused_train_grads(flat, x, mask, layout=layout,
                                     shrink_lambda=5.0, compute_dtype=cdt)
    else:
        q = torch.randn((10 * 300, 7), device=cuda).to(cdt)
        banks = torch.randn((10, 512, 7), device=cuda)
        gw = torch.randint(0, 10, (10 * 300,), dtype=torch.int32,
                           device=cuda)

        def call():
            return (dist_tiles(q, banks, gw),)
    want = [t.clone() for t in call()]
    outs = [torch.empty_like(t) for t in want]

    def body():
        for o, t in zip(outs, call()):
            o.copy_(t)

    graphed = _captured(body, outs)
    launches, captured = wrapper.launches, wrapper.captured
    graphed()  # the warm-up (a launch) and the capture (none)
    assert wrapper.launches == launches + 1
    assert wrapper.captured == captured + 1
    assert graphed.kernels == {kernel: 1}
    for o in outs:
        o.zero_()
    for _ in range(3):
        graphed()
    torch.cuda.synchronize()
    assert wrapper.launches == launches + 4 and graphed.replays == 3
    for o, w in zip(outs, want):
        assert torch.equal(_bits(o), _bits(w))


@pytest.mark.parametrize("g", [5, 512])
def test_train_cluster_launch_replays_bitwise(cuda, g):
    """The train kernel's thread-block-cluster launch keeps its cluster
    under capture: the replayed grads are a direct call's bits, at the
    main path's 8 CTAs per client (G = 5) and 1 (G = 512)."""
    from fedmse_tpu_torch.ops.fused_train import cluster_size
    layout, flat, x, mask = _train_inputs((g, 115, 27, 7, 12),
                                          torch.float32, cuda)
    assert cluster_size(g, 27) == (8 if g == 5 else 1)
    want = fused_train_grads(flat, x, mask, layout=layout, shrink_lambda=5.0)
    loss, grads = torch.empty_like(want[0]), torch.empty_like(want[1])

    def body():
        a, b = fused_train_grads(flat, x, mask, layout=layout,
                                 shrink_lambda=5.0)
        loss.copy_(a)
        grads.copy_(b)

    graphed = _captured(body, [loss])
    graphed()
    loss.zero_()
    grads.zero_()
    graphed()
    torch.cuda.synchronize()
    assert torch.equal(_bits(loss), _bits(want[0]))
    assert torch.equal(_bits(grads), _bits(want[1]))


def _paper_federation(device, n_normal=1_200, n_abnormal=300):
    clients = synthetic_clients(n_clients=10, dim=115, n_normal=n_normal,
                                n_abnormal=n_abnormal, seed=0)
    dev_x = np.concatenate([c.dev_raw for c in clients])[:2000].astype(
        np.float32)
    return clients, dev_x


def _cohort_snapshot(co):
    import dataclasses as dc
    from fedmse_tpu_torch.federation.optim import AdamState
    snap = {}
    for f in dc.fields(co):
        v = getattr(co, f.name)
        snap[f.name] = (AdamState(*(t.clone() for t in v))
                        if isinstance(v, AdamState) else v.clone())
    return snap


def _cohort_restore(co, snap):
    for name, v in snap.items():
        getattr(co, name).copy_(v)


@pytest.mark.parametrize("update_type", ["mse_avg", "fedprox"])
def test_epoch_graph_replays_bitwise(cuda, update_type):
    """One cohort epoch at the paper's width: the eager warm-up, a replay
    and a second replay from the same state give the same bits."""
    from fedmse_tpu_torch.federation.local_training import LocalTrainer
    from fedmse_tpu_torch.federation.state import init_client_states
    clients, dev_x = _paper_federation(cuda)
    data = stack_clients(clients, dev_x, 12, device=cuda)
    model = make_model("hybrid", 115, 27, 7, 5.0, device=cuda)
    states = init_client_states(model, 10, torch.Generator().manual_seed(3),
                                device=cuda)
    trainer = LocalTrainer(model, epochs=3, patience=1,
                           fedprox=update_type == "fedprox", mu=0.001,
                           lr=1e-3)
    idx = torch.tensor([1, 3, 4, 7, 8], device=cuda)
    co = trainer.cohort(idx, states.params, data.train_xb, data.train_mb,
                        data.valid_xb, data.valid_mb)
    trainer.begin(co, states.params, states.opt_state, states.prev_global,
                  data.train_xb, data.train_mb, data.valid_xb, data.valid_mb)
    start = _cohort_snapshot(co)
    graphed = _captured(lambda: trainer.epoch(co), [co.p])
    runs = []
    for _ in range(3):  # eager warm-up, replay, replay
        _cohort_restore(co, start)
        graphed()
        torch.cuda.synchronize()
        runs.append(_cohort_snapshot(co))
    assert graphed.replays == 2 and graphed.kernels["fused_ae_train"] == \
        data.train_xb.shape[1]
    for name in ("p", "best", "min_v", "tracking", "worse", "go", "epoch"):
        for other in runs[1:]:
            assert torch.equal(_bits(other[name].float()),
                               _bits(runs[0][name].float())), name
    for a, b in zip(runs[0]["opt"], runs[2]["opt"]):
        assert torch.equal(_bits(a.float()), _bits(b.float()))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_fused_round_matches_per_phase_round_on_card(cuda, precision):
    """The fused round (CUDA graphs) against the per-phase round at the
    paper's width, from one state and cohort, tie-break off: the same
    aggregator and verification rows, and params, opt state, AUC, scores
    and weights within 1e-6 scale-normalized (the same kernels in the same
    order: expected bit-equal). A second fused round from the same state
    replays the captured graphs and gives the first's bits."""
    from fedmse_tpu_torch.config import CompatConfig, ExperimentConfig
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.ops.precision import get_policy
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    cfg = ExperimentConfig(epochs=2, precision=precision,
                           compat=CompatConfig(vote_tie_break=False))
    clients, dev_x = _paper_federation(cuda)
    data = stack_clients(clients, dev_x, 12, device=cuda,
                         dtype=get_policy(precision).compute_dtype)

    def engine(fused):
        model = make_model("hybrid", 115, 27, 7, cfg.shrink_lambda,
                           precision=precision, device=cuda)
        return RoundEngine(model, cfg, data, n_real=10,
                           rngs=ExperimentRngs(run=0), model_type="hybrid",
                           update_type="mse_avg", fused=fused)
    per, fus = engine(False), engine(True)
    selected = per.select_clients()
    start = fus.states.clone()
    want = per.run_round(0, selected=selected)
    got = [fus.run_round(0, selected=selected)]
    after = fus.states.clone()
    fus.states = start
    fus.host.aggregation_count[:] = 0
    fus.host.votes_received[:] = 0
    got.append(fus.run_round(0, selected=selected))
    torch.cuda.synchronize()
    assert fus.fused_round().epoch.replays >= 1
    for g in got:
        assert g.aggregator == want.aggregator
        assert g.verification_results == want.verification_results

    def err(a, b):
        """Scale-normalized max difference; NaN (an unselected client's
        min_valid and curve) must sit at the same places."""
        a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        a, b = torch.nan_to_num(a), torch.nan_to_num(b)
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
    layout = ParamLayout(115, 27, 7)
    for sl in layout.slices():
        assert err(after.params[:, sl].cpu(),
                   per.states.params[:, sl].cpu()) <= 1e-6
    for a, b in zip(after.opt_state, per.states.opt_state):
        assert err(a.cpu(), b.cpu()) <= 1e-6
    for field in ("client_metrics", "mse_scores", "agg_weights",
                  "min_valid", "tracking"):
        assert err(getattr(got[0], field), getattr(want, field)) <= 1e-6
    assert torch.equal(_bits(fus.states.params), _bits(after.params))
    np.testing.assert_array_equal(got[1].client_metrics,
                                  got[0].client_metrics)


def test_cli_default_runs_the_fused_schedule_on_card(cuda, tmp_path):
    """`python -m fedmse_tpu_torch.main` with the default config runs on
    the card through the fused, pipelined schedule: its epoch graph is
    captured and replayed, and the sweep writes finite metrics."""
    import json
    from fedmse_tpu_torch.config import DatasetConfig
    from fedmse_tpu_torch.main import main
    rng = np.random.default_rng(0)
    shards = tmp_path / "shards"
    for k in range(1, 5):
        for split, n, shift in (("normal", 300, 0.0), ("abnormal", 60, 4.0),
                                ("test_normal", 30, 0.0)):
            d = shards / f"Client-{k}" / split
            d.mkdir(parents=True)
            np.savetxt(d / "data.csv", rng.normal(shift, 1.0, (n, 115)),
                       delimiter=",")
    cfg_path = tmp_path / "dataset.json"
    cfg_path.write_text(json.dumps(
        DatasetConfig.for_client_dirs(str(shards), 4).to_json()))
    captured, launched = fused_train_grads.captured, fused_train_grads.launches
    out = main(["--dataset-config", str(cfg_path), "--network-size", "4",
                "--model-types", "hybrid", "--update-types", "mse_avg",
                "--num-rounds", "2", "--checkpoint-dir",
                str(tmp_path / "ckpt")])
    per_epoch = fused_train_grads.captured - captured  # one epoch graph
    assert per_epoch > 0
    # the eager warm-up epoch, then replays of the captured one
    assert fused_train_grads.launches - launched > per_epoch
    finals = out["results"]["hybrid/mse_avg/run0"]["final_metrics"]
    assert len(finals) == 4 and np.isfinite(finals).all()


@pytest.mark.parametrize("chunk", [2, 3])
def test_pipelined_early_stop_on_card_matches_per_phase(cuda, chunk):
    """The pipelined driver on the card, with a global early stop at round
    index 2: before its chunk's last round (chunk 2: the snapshot is
    copied back into the captured buffers and the prefix replayed) or at
    it (chunk 3: the in-flight successor's entry snapshot). Its final
    states are the per-phase driver's bits on the card."""
    from fedmse_tpu_torch.config import CompatConfig, ExperimentConfig
    from fedmse_tpu_torch.main import GlobalEarlyStop, run_combination
    cfg = ExperimentConfig(dim_features=12, hidden_neus=8, latent_dim=3,
                           network_size=4, epochs=2, batch_size=8,
                           num_rounds=8, fused_schedule_chunk=chunk,
                           compat=CompatConfig(vote_tie_break=False))
    clients = synthetic_clients(n_clients=4, dim=12, n_normal=120,
                                n_abnormal=60, seed=0)
    dev_x = np.concatenate([c.dev_raw for c in clients])[:100].astype(
        np.float32)
    data = stack_clients(clients, dev_x, 8, device=cuda)
    outs = [run_combination(c, data, 4, "autoencoder", "avg", 0,
                            early_stop=GlobalEarlyStop())
            for c in (cfg, cfg.replace(fused_rounds=False))]
    (fused, per) = outs
    assert fused["rounds_run"] == per["rounds_run"] == 3
    assert fused["aggregation_count"] == per["aggregation_count"]
    a, b = fused["engine"].states, per["engine"].states
    for name in ("params", "prev_global", "hist_params", "rejected"):
        assert torch.equal(_bits(getattr(a, name)), _bits(getattr(b, name)))
    for x, y in zip(a.opt_state, b.opt_state):
        assert torch.equal(_bits(x), _bits(y))

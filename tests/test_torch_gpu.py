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


def _assert_one_kernel(call, name, wrapper):
    """One call() runs exactly one CUDA kernel, the wrapper's `name`, by
    torch.profiler's device events (after a warm-up call). On some H100
    machines the profiler drops whole windows' device events (the same
    tests of the parent commit fail there on an empty list): a window with
    no device event is taken again, up to three times, and if every window
    is empty the call is captured alone in a CUDA graph instead, which must
    hold exactly one node, the one launch the wrapper counted under
    capture (a second kernel, a memset or a copy would be a node too)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fedmse_tpu_torch.ops.graphs import _new_graph, graph_nodes
    call()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        if kernels:
            assert len(kernels) == 1 and name in kernels[0], kernels
            return
    import gc
    graph, kept = _new_graph()
    assert kept, "this torch cannot keep a captured graph to count its nodes"
    captured = wrapper.captured
    gc.disable()  # a dead engine's graphs freed mid-capture would void it
    try:
        with torch.cuda.graph(graph):
            call()
    finally:
        gc.enable()
    assert wrapper.captured == captured + 1
    assert graph_nodes(graph) == 1


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", [FORWARD_LAYOUTS[0], FORWARD_LAYOUTS[3],
                                    FORWARD_LAYOUTS[6], FORWARD_LAYOUTS[7]])
def test_forward_kernel_is_one_kernel_per_call(cuda, cdt, layout):
    params, x, idx = _forward_inputs(layout, cdt, cuda)
    _assert_one_kernel(lambda: fused_forward_stats(params, x, idx,
                                                   compute_dtype=cdt),
                       "fused_ae_forward_kernel", fused_forward_stats)


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
    layout, flat, x, mask = _train_inputs(shape, torch.float32, cuda)
    _assert_one_kernel(lambda: fused_train_grads(flat, x, mask, layout=layout,
                                                 shrink_lambda=10.0),
                       "fused_ae_train_kernel", fused_train_grads)


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
    from fedmse_tpu_torch.knn.score import dist_tiles
    n, t, b, lat = shape
    q, banks, gw = _dist_case(n, t, b, lat, cdt, "random", cuda)
    _assert_one_kernel(lambda: dist_tiles(q, banks, gw), "dist_tiles",
                       dist_tiles)


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


def _fault_hooks(attack_kind="scale", attack_start=1):
    """The driver's fault path: an attack, chaos and elastic membership."""
    from fedmse_tpu_torch.chaos import ChaosSpec
    from fedmse_tpu_torch.federation.attack import AttackSpec, make_poison_fn
    from fedmse_tpu_torch.federation.elastic import ElasticSpec
    return dict(poison_fn=make_poison_fn(AttackSpec(
        kind=attack_kind, start_round=attack_start)),
        chaos=ChaosSpec(dropout_p=0.2, straggler_p=0.1, crash_p=0.3,
                        broadcast_loss_p=0.1),
        elastic=ElasticSpec(leave_p=0.1, join_p=0.3, preempt_p=0.05))


def test_null_fault_hooks_are_the_clean_round_on_card(cuda):
    """Every fault hook built in with null specs (an attack that never
    fires, a zero-probability ChaosSpec, a null ElasticSpec) against the
    clean fused round at the paper's width, from one init: two rounds (a
    capture, then a replay), the same bits. The leave graph launches the
    forward as often (the crash re-election reuses the vote's scores), and
    each body is captured once."""
    from fedmse_tpu_torch.chaos import ChaosSpec
    from fedmse_tpu_torch.config import ExperimentConfig
    from fedmse_tpu_torch.federation import RoundEngine, init_client_states
    from fedmse_tpu_torch.federation.attack import AttackSpec, make_poison_fn
    from fedmse_tpu_torch.federation.elastic import ElasticSpec
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    cfg = ExperimentConfig(epochs=2)
    clients, dev_x = _paper_federation(cuda)
    data = stack_clients(clients, dev_x, 12, device=cuda)
    model = make_model("hybrid", 115, 27, 7, cfg.shrink_lambda, device=cuda)
    init = init_client_states(model, 10, torch.Generator().manual_seed(6),
                              device=cuda)
    null = dict(poison_fn=make_poison_fn(AttackSpec(
        kind="noise", start_round=10 ** 6)), chaos=ChaosSpec(),
        elastic=ElasticSpec())
    engines = [RoundEngine(model, cfg, data, n_real=10,
                           rngs=ExperimentRngs(run=0), model_type="hybrid",
                           update_type="mse_avg", states=init, fused=True,
                           **kw) for kw in ({}, null)]
    runs = [e.run_rounds(0, 2) for e in engines]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert a.aggregator == b.aggregator
        assert a.verification_results == b.verification_results
        for f in ("client_metrics", "min_valid", "tracking"):
            assert torch.equal(_bits(torch.as_tensor(getattr(a, f))),
                               _bits(torch.as_tensor(getattr(b, f)))), f
    a, b = engines[0].states, engines[1].states
    for name in ("params", "prev_global", "hist_params", "rejected"):
        assert torch.equal(_bits(getattr(a, name)), _bits(getattr(b, name)))
    for x, y in zip(a.opt_state, b.opt_state):
        assert torch.equal(_bits(x), _bits(y))
    clean, hooked = (e.fused_round() for e in engines)
    assert hooked.leave.kernels == clean.leave.kernels
    assert hooked.enter.replays == hooked.leave.replays == 1
    assert hooked.leave.nodes > clean.leave.nodes


def test_fault_round_on_card_matches_cpu(cuda):
    """The fault path's first round at the paper's width, one epoch, the
    attack on from round 0, on the card and on the CPU from one init with
    the same masks: the same aggregator, crashed aggregator, effective
    cohort, members and generations; params within 1e-4 per leaf."""
    from fedmse_tpu_torch.config import ExperimentConfig
    from fedmse_tpu_torch.federation import RoundEngine, init_client_states
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    cfg = ExperimentConfig(epochs=1)
    clients, dev_x = _paper_federation(cuda)
    init = init_client_states(make_model("hybrid", 115, 27, 7, device="cpu"),
                              10, torch.Generator().manual_seed(7),
                              device="cpu")
    runs = []
    for where in (cuda, torch.device("cpu")):
        eng = RoundEngine(
            make_model("hybrid", 115, 27, 7, cfg.shrink_lambda,
                       device=where), cfg,
            stack_clients(clients, dev_x, 12, device=where), n_real=10,
            rngs=ExperimentRngs(run=0), model_type="hybrid",
            update_type="mse_avg", states=init.to(where), fused=True,
            **_fault_hooks(attack_start=0))
        runs.append((eng.run_rounds(0, 1), eng.states.params.cpu()))
    (card_res, card), (cpu_res, cpu) = runs
    for a, b in zip(card_res, cpu_res):
        for f in ("aggregator", "crashed_aggregator", "effective",
                  "members"):
            assert getattr(a, f) == getattr(b, f), f
        np.testing.assert_array_equal(a.generations, b.generations)
    layout = ParamLayout(115, 27, 7)
    for sl in layout.slices():
        err = (card[:, sl] - cpu[:, sl]).abs().max() / cpu[:, sl].abs().max()
        assert float(err) <= 1e-4


def test_resumed_fault_run_on_card_is_the_uninterrupted_run(cuda,
                                                            tmp_path):
    """2 rounds of the fault path with a snapshot, resumed to 3 in a fresh
    engine (new graphs, the restored state copied into their buffers),
    against 3 rounds uninterrupted: the same bits."""
    from fedmse_tpu_torch.checkpointing import CheckpointManager
    from fedmse_tpu_torch.config import CompatConfig, ExperimentConfig
    from fedmse_tpu_torch.main import run_combination
    from fedmse_tpu_torch.chaos import ChaosSpec
    from fedmse_tpu_torch.federation.attack import AttackSpec
    from fedmse_tpu_torch.federation.elastic import ElasticSpec
    cfg = ExperimentConfig(dim_features=12, hidden_neus=8, latent_dim=3,
                           network_size=4, epochs=2, batch_size=8,
                           fused_schedule_chunk=2, num_participants=0.75,
                           compat=CompatConfig(vote_tie_break=True))
    clients = synthetic_clients(n_clients=4, dim=12, n_normal=120,
                                n_abnormal=60, seed=0)
    dev_x = np.concatenate([c.dev_raw for c in clients])[:100].astype(
        np.float32)
    data = stack_clients(clients, dev_x, 8, device=cuda)
    faults = dict(attack=AttackSpec(kind="noise", strength=0.2,
                                    start_round=1),
                  chaos=ChaosSpec(dropout_p=0.2, crash_p=0.5,
                                  broadcast_loss_p=0.1),
                  elastic=ElasticSpec(leave_p=0.2, join_p=0.5))
    mgr = CheckpointManager(str(tmp_path))

    def run(rounds, resume):
        return run_combination(cfg.replace(num_rounds=rounds), data, 4,
                               "hybrid", "mse_avg", 0, resume=resume,
                               **faults)
    whole = run(3, None)
    assert run(2, mgr)["rounds_run"] == 2
    rest = run(3, mgr)
    assert rest["rounds_run"] == 1
    got, want = rest["engine"].states, whole["engine"].states
    for name in ("params", "prev_global", "hist_params", "rejected"):
        assert torch.equal(_bits(getattr(got, name)),
                           _bits(getattr(want, name))), name
    for x, y in zip(got.opt_state, want.opt_state):
        assert torch.equal(_bits(x), _bits(y))


def _typed_federation(device, n_clients=16, n_normal=1_200, n_abnormal=300):
    from fedmse_tpu_torch.data import synthetic_typed_clients
    clients = synthetic_typed_clients(n_clients=n_clients, types=4, dim=115,
                                      n_normal=n_normal,
                                      n_abnormal=n_abnormal, seed=11)
    dev_x = np.concatenate([c.dev_raw for c in clients])[:2000].astype(
        np.float32)
    return clients, dev_x


@pytest.mark.parametrize("hardened", [False, True])
def test_routed_verification_launch_is_the_uniform_launch_bitwise(cuda,
                                                                  hardened):
    """Clustered verification: the per-client broadcast [N, P] is one
    routed forward launch (N broadcasts, and under the hardened rule the N
    own models too: 2N models by row index). With every broadcast the same
    model, its rows are the uniform single-model launch's bits in f32
    (mixed and single-model tiles sum alike), and the verifier loads the
    same params as with the shared [P] broadcast."""
    from fedmse_tpu_torch.federation.state import fresh_states
    from fedmse_tpu_torch.federation.verification import make_verify_fn
    n, v = 16, 1000
    layout = ParamLayout(115, 27, 7)
    gen = torch.Generator().manual_seed(12)
    own = (torch.randn((n, layout.size), generator=gen) * 0.1).to(cuda)
    agg = (torch.randn((layout.size,), generator=gen) * 0.1).to(cuda)
    x = torch.randn((v, 115), generator=gen).to(cuda)
    ids = torch.arange(n, device=cuda, dtype=torch.int32)
    route = torch.cat([ids, ids + n])[:, None].repeat(1, v).view(-1)
    routed = fused_forward_stats(layout.tree(torch.cat(
        [agg.expand(n, -1), own])), x.repeat(2 * n, 1), route)
    uniform = fused_forward_stats(layout.tree(agg[None]), x)
    for r, u in zip(routed, uniform):
        head = r[: n * v].view((n, v) + tuple(u.shape[1:]))
        assert torch.equal(_bits(head), _bits(u[None].expand_as(head)))
    model = make_model("autoencoder", 115, 27, 7, device=cuda)
    verify = make_verify_fn(model, hardened=hardened)
    states = fresh_states(own.clone())
    states.hist_seen.fill_(True)
    states.hist_perf.fill_(0.5)
    onehot = torch.zeros(n, device=cuda)
    onehot[3] = 1.0
    mask = torch.ones(n, device=cuda)
    m = torch.ones(v, device=cuda)
    shared = verify(states, agg, x, m, onehot, mask)
    per_client = verify(states, agg.expand(n, -1).contiguous(), x, m,
                        onehot, mask)
    assert torch.equal(_bits(per_client.states.params),
                       _bits(shared.states.params))
    assert torch.equal(per_client.accepted, shared.accepted)
    assert float((per_client.perf_change - shared.perf_change).abs().max()) \
        <= 1e-6


def test_k1_cluster_graphs_are_the_clean_graphs_on_card(cuda):
    """ClusterSpec(k=1) builds nothing: two rounds (a capture, a replay)
    bit-equal to an engine without a spec, and every graph with the same
    nodes and kernels per replay."""
    from fedmse_tpu_torch.cluster import ClusterSpec
    from fedmse_tpu_torch.config import ExperimentConfig
    from fedmse_tpu_torch.federation import RoundEngine, init_client_states
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    cfg = ExperimentConfig(epochs=2)
    clients, dev_x = _typed_federation(cuda)
    data = stack_clients(clients, dev_x, 12, device=cuda)
    model = make_model("autoencoder", 115, 27, 7, device=cuda)
    init = init_client_states(model, 16, torch.Generator().manual_seed(8),
                              device=cuda)
    engines = [RoundEngine(model, cfg, data, n_real=16,
                           rngs=ExperimentRngs(run=0),
                           model_type="autoencoder", update_type="mse_avg",
                           states=init, fused=True, **kw)
               for kw in ({}, dict(cluster=ClusterSpec(k=1)))]
    runs = [e.run_rounds(0, 2) for e in engines]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert a.aggregator == b.aggregator
        for f in ("client_metrics", "min_valid", "tracking"):
            assert torch.equal(_bits(torch.as_tensor(getattr(a, f))),
                               _bits(torch.as_tensor(getattr(b, f)))), f
    for name in ("params", "prev_global", "hist_params", "rejected"):
        assert torch.equal(_bits(getattr(engines[0].states, name)),
                           _bits(getattr(engines[1].states, name)))
    clean, null = (e.fused_round() for e in engines)
    assert not null.clustered
    for body in ("enter", "epoch", "leave"):
        a, b = getattr(clean, body), getattr(null, body)
        assert (a.nodes, a.kernels) == (b.nodes, b.kernels), body


@pytest.mark.parametrize("personalize", [False, True])
def test_clustered_round_on_card_matches_cpu(cuda, personalize):
    """One clustered round (K = 4, one assignment) at the paper's width, one
    epoch, on the card and on the CPU from one init: the same aggregator
    and verification rows, params within 1e-4 per leaf; and the card's fit
    of the assignment from the init equals the CPU's."""
    from fedmse_tpu_torch.cluster import ClusterSpec
    from fedmse_tpu_torch.config import ExperimentConfig
    from fedmse_tpu_torch.federation import RoundEngine, init_client_states
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    cfg = ExperimentConfig(epochs=1)
    clients, dev_x = _typed_federation(cuda)
    init = init_client_states(make_model("autoencoder", 115, 27, 7,
                                         device="cpu"),
                              16, torch.Generator().manual_seed(9),
                              device="cpu")
    spec = ClusterSpec(k=4, personalize=personalize)
    fits, runs = [], []
    for where in (cuda, torch.device("cpu")):
        data = stack_clients(clients, dev_x, 12, device=where)
        model = make_model("autoencoder", 115, 27, 7, device=where)
        fitter = RoundEngine(model, cfg, data, n_real=16,
                             rngs=ExperimentRngs(run=0),
                             model_type="autoencoder",
                             update_type="mse_avg", states=init.to(where),
                             fused=True, cluster=spec)
        fitter._ensure_cluster_fit(0)
        fits.append(fitter.cluster_assignment)
        eng = RoundEngine(model, cfg, data, n_real=16,
                          rngs=ExperimentRngs(run=0),
                          model_type="autoencoder", update_type="mse_avg",
                          states=init.to(where), fused=True, cluster=spec,
                          cluster_assignment=np.arange(16) % 4)
        runs.append((eng.run_rounds(0, 1)[0], eng.states.params.cpu()))
    assert np.array_equal(fits[0], fits[1])
    (card_res, card), (cpu_res, cpu) = runs
    assert card_res.aggregator == cpu_res.aggregator
    assert card_res.verification_results == cpu_res.verification_results
    for sl in ParamLayout(115, 27, 7).slices():
        err = (card[:, sl] - cpu[:, sl]).abs().max() / cpu[:, sl].abs().max()
        assert float(err) <= 1e-4


def test_capture_survives_a_dead_engines_graphs(cuda):
    """A dead engine's graphs sit in reference cycles; were the collector to
    free them while a new engine captures, the capture would be
    invalidated. CapturedBody holds the collector off during a capture:
    with a collection due at every allocation, a second engine still
    captures and runs."""
    import gc
    from fedmse_tpu_torch.config import ExperimentConfig
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    cfg = ExperimentConfig(dim_features=12, hidden_neus=8, latent_dim=3,
                           network_size=4, epochs=2, batch_size=8)
    clients = synthetic_clients(n_clients=4, dim=12, n_normal=120,
                                n_abnormal=60, seed=0)
    dev_x = np.concatenate([c.dev_raw for c in clients])[:100].astype(
        np.float32)
    data = stack_clients(clients, dev_x, 8, device=cuda)

    def engine():
        return RoundEngine(make_model("hybrid", 12, 8, 3, device=cuda), cfg,
                           data, n_real=4, rngs=ExperimentRngs(run=0),
                           model_type="hybrid", update_type="mse_avg",
                           fused=True)
    dead = engine()
    dead.run_round_fused(0)
    del dead  # its graphs now wait in a cycle for the collector
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        res = engine().run_round_fused(0)
    finally:
        gc.set_threshold(*thresholds)
    torch.cuda.synchronize()
    assert np.isfinite(res.client_metrics).all()


@pytest.mark.parametrize("runs", [3, 8])
def test_batched_train_launch_gives_each_run_its_bits(cuda, runs):
    """The batched round's train step: R runs' cohorts of 5 in one launch
    with one run's CTAs per client (8) are, run by run, the bits of that
    run's own G = 5 launch, and within tolerance of the plain version."""
    from fedmse_tpu_torch.ops.fused_train import cluster_size
    layout = ParamLayout(115, 27, 7)
    gen = torch.Generator().manual_seed(11)
    g = 5 * runs
    flat = (torch.randint(-8, 9, (g, layout.size), generator=gen) / 64.0
            ).to(cuda)
    x = (torch.randint(-6, 7, (g, 12, 115), generator=gen) / 4.0).to(cuda)
    m = torch.ones((g, 12), device=cuda)
    kw = dict(layout=layout, shrink_lambda=10.0)
    before = fused_train_grads.launches
    got = fused_train_grads(flat, x, m, ctas=cluster_size(5, 27), **kw)
    assert fused_train_grads.launches == before + 1
    for r in range(runs):
        rows = slice(5 * r, 5 * r + 5)
        alone = fused_train_grads(flat[rows], x[rows], m[rows], **kw)
        assert all(torch.equal(a[rows], b) for a, b in zip(got, alone))
    for a, b in zip(got, fused_train_grads_plain(flat, x, m, **kw)):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-5
    with pytest.raises(ValueError, match="ctas"):
        fused_train_grads(flat, x, m, ctas=9, **kw)


def test_batched_runs_on_card_match_the_runs_alone(cuda):
    """Three runs batched (graphs captured, then replayed in a second
    chunk) against the same three runs alone on the card at width 16: the
    same selections and aggregators, states within 1e-5 scale-normalized;
    and the batched round on the CPU within 1e-4 of the card's."""
    from fedmse_tpu_torch.config import ExperimentConfig
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.federation.batched import BatchedRunEngine
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    cfg = ExperimentConfig(dim_features=16, hidden_neus=8, latent_dim=3,
                           network_size=6, epochs=2, num_runs=3)
    clients = synthetic_clients(n_clients=6, dim=16, n_normal=240,
                                n_abnormal=120, seed=0)
    dev_x = np.concatenate([c.dev_raw for c in clients])[:200].astype(
        np.float32)
    params = {}
    for where in (cuda, torch.device("cpu")):
        data = stack_clients(clients, dev_x, 12, device=where)
        model = make_model("hybrid", 16, 8, 3, device=where)
        bat = BatchedRunEngine(model, cfg, data, 6, 3, "hybrid", "mse_avg")
        outs = [bat.run_schedule_chunk(s, 2, np.ones(3, bool))
                for s in (0, 2)]
        params[where.type] = bat.states.params.cpu()
        if where.type != "cuda":
            continue
        layout = ParamLayout(16, 8, 3)
        for r in range(3):
            eng = RoundEngine(model, cfg, data, n_real=6,
                              rngs=ExperimentRngs(run=r),
                              model_type="hybrid", update_type="mse_avg",
                              fused=True)
            alone = eng.run_rounds(0, 2) + eng.run_rounds(2, 2)
            got = [bat.process_round(r, 2 * c + i, sched[i][r], o, i)
                   for c, (o, sched, _) in enumerate(outs)
                   for i in range(2)]
            assert [x.aggregator for x in got] == \
                [x.aggregator for x in alone]
            mine = bat.states.params.chunk(3)[r].cpu()
            want = eng.states.params.cpu()
            for sl in layout.slices():
                err = (mine[:, sl] - want[:, sl]).abs().max() \
                    / want[:, sl].abs().max()
                assert float(err) <= 1e-5
    for sl in ParamLayout(16, 8, 3).slices():
        err = (params["cuda"][:, sl] - params["cpu"][:, sl]).abs().max() \
            / params["cpu"][:, sl].abs().max()
        assert float(err) <= 1e-4


def test_null_redteam_is_the_clean_round_on_card(cuda):
    """RedteamSpec() builds nothing: two rounds (a capture, a replay)
    bit-equal to an engine without a spec, the same nodes and kernels per
    replay; a red round (a noise poison with lying votes) on the card
    within 1e-4 of the CPU's."""
    from fedmse_tpu_torch.config import ExperimentConfig
    from fedmse_tpu_torch.federation import RoundEngine, init_client_states
    from fedmse_tpu_torch.redteam import RedteamSpec
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    cfg = ExperimentConfig(dim_features=16, hidden_neus=8, latent_dim=3,
                           network_size=6, epochs=2)
    clients = synthetic_clients(n_clients=6, dim=16, n_normal=240,
                                n_abnormal=120, seed=0)
    dev_x = np.concatenate([c.dev_raw for c in clients])[:200].astype(
        np.float32)
    init = init_client_states(make_model("hybrid", 16, 8, 3, device="cpu"),
                              6, torch.Generator().manual_seed(3),
                              device="cpu")

    def engine(where, spec):
        return RoundEngine(make_model("hybrid", 16, 8, 3, device=where), cfg,
                           stack_clients(clients, dev_x, 12, device=where),
                           n_real=6, rngs=ExperimentRngs(run=0),
                           model_type="hybrid", update_type="mse_avg",
                           states=init.to(where), fused=True, redteam=spec)
    engines = [engine(cuda, s) for s in (None, RedteamSpec())]
    runs = [e.run_rounds(0, 2) for e in engines]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert a.aggregator == b.aggregator
    for name in ("params", "prev_global", "hist_params", "rejected"):
        assert torch.equal(_bits(getattr(engines[0].states, name)),
                           _bits(getattr(engines[1].states, name)))
    clean, null = (e.fused_round() for e in engines)
    for body in ("enter", "epoch", "leave"):
        a, b = getattr(clean, body), getattr(null, body)
        assert (a.nodes, a.kernels) == (b.nodes, b.kernels), body
    spec = RedteamSpec(kind="cluster_poison", adversaries=(1, 4),
                       poison="noise", strength=0.1, lie_votes=True)
    red = [engine(w, spec) for w in (cuda, torch.device("cpu"))]
    res = [e.run_rounds(0, 1)[0] for e in red]
    assert res[0].aggregator == res[1].aggregator
    card, cpu = (e.states.params.cpu() for e in red)
    for sl in ParamLayout(16, 8, 3).slices():
        err = (card[:, sl] - cpu[:, sl]).abs().max() / cpu[:, sl].abs().max()
        assert float(err) <= 1e-4


def _same(a, b) -> bool:
    """Bitwise equality of two tensors (NaN included for floats)."""
    a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
    if a.is_floating_point():
        return a.shape == b.shape and torch.equal(_bits(a), _bits(b))
    return torch.equal(a, b)


def _tiered_setup(where, n=6, **cfg_kw):
    from fedmse_tpu_torch.config import ExperimentConfig
    cfg = ExperimentConfig(dim_features=16, hidden_neus=8, latent_dim=3,
                           network_size=n, epochs=2, **cfg_kw)
    clients = synthetic_clients(n_clients=n, dim=16, n_normal=240,
                                n_abnormal=120, seed=0)
    dev_x = np.concatenate([c.dev_raw for c in clients])[:200].astype(
        np.float32)
    return cfg, stack_clients(clients, dev_x, 12, device=where)


def _tiered_engine(cfg, data, where, n=6):
    from fedmse_tpu_torch.federation.tiered import TieredRoundEngine
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    return TieredRoundEngine(make_model("hybrid", 16, 8, 3, device=where),
                             cfg, data, n_real=n, rngs=ExperimentRngs(run=0),
                             model_type="hybrid", update_type="mse_avg",
                             device=where)


def _rounds(engine, k):
    out = []
    engine.run_rounds(0, k, lambda r, s: out.append(r) or False)
    return out


def test_tiered_full_participation_is_the_dense_engine_on_card(cuda):
    """C == N on the card (graphs captured, then replayed): the tiered
    engine's rounds and states are the dense fused engine's bit for bit,
    with the tie-break on; the round waits on the prefetch's copy event."""
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    cfg, data = _tiered_setup(cuda, num_participants=1.0, num_rounds=3)
    dense = RoundEngine(make_model("hybrid", 16, 8, 3, device=cuda), cfg,
                        data, n_real=6, rngs=ExperimentRngs(run=0),
                        model_type="hybrid", update_type="mse_avg",
                        fused=True)
    want = dense.run_rounds(0, 3)
    tier = _tiered_engine(cfg, data, cuda)
    got = _rounds(tier, 3)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert (a.selected, a.aggregator) == (b.selected, b.aggregator)
        assert a.verification_results == b.verification_results
        for f in ("client_metrics", "tracking", "min_valid"):
            assert _same(getattr(a, f), getattr(b, f)), f
    for x, y in zip(tier.store.host.tensors(), dense.states.tensors()):
        assert _same(x, y)
    f = tier._round
    assert all(b.captured for b in (f.enter, f.epoch, f.leave))


def test_tiered_staging_is_pinned_and_the_round_waits_for_the_copy(
        cuda, monkeypatch):
    """The staging slabs are pinned; with the side stream held back by a
    sleep before every prefetch copy, the prefetched loop is still the
    serial loop bit for bit, and every round's stream waited on its
    copy's event."""
    cfg, data = _tiered_setup(cuda, num_participants=0.5, num_rounds=4)
    serial = _tiered_engine(cfg, data, cuda)
    want = [serial.run_round(r) for r in range(4)]
    pre = _tiered_engine(cfg, data, cuda)
    pre._ensure_round()
    for slab in pre._staging:
        assert all(t.is_pinned() for t in slab.tensors())
    assert pre._out.params.is_pinned()
    slow_prefetch = pre._prefetch

    def held_back(plan):
        with torch.cuda.stream(pre._side):
            torch.cuda._sleep(20_000_000)
        return slow_prefetch(plan)
    pre._prefetch = held_back
    waited = []
    real_wait = torch.cuda.Stream.wait_event
    monkeypatch.setattr(torch.cuda.Stream, "wait_event",
                        lambda s, e: waited.append(e) or real_wait(s, e))
    real_load = pre._load

    def load(pf, prev):
        assert any(e is pf.ready for e in waited)
        return real_load(pf, prev)
    pre._load = load
    got = _rounds(pre, 4)
    for a, b in zip(got, want):
        assert (a.selected, a.aggregator) == (b.selected, b.aggregator)
        assert _same(a.client_metrics, b.client_metrics)
    for x, y in zip(pre.store.host.tensors(), serial.store.host.tensors()):
        assert _same(x, y)


def test_tiered_init_leaves_no_fleet_axis_tensor_on_card(cuda):
    """A 100k-client tier at small width, then a round at C = 512: no CUDA
    tensor carries the fleet's axis, and the card holds far less than the
    dense state would."""
    import gc
    from fedmse_tpu_torch.federation.state import (TieredClientStore,
                                                   dense_state_bytes)
    n = 100_000
    model = make_model("hybrid", 6, 4, 2, device=cuda)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    tier = TieredClientStore.create(model, n,
                                    torch.Generator().manual_seed(1))
    assert torch.cuda.memory_allocated() == before
    slab = tier.gather(np.arange(512))
    on_card = slab.apply(lambda t: t.to(cuda))
    fleet = [o for o in gc.get_objects() if isinstance(o, torch.Tensor)
             and o.is_cuda and o.dim() and o.shape[0] == n]
    assert not fleet
    assert torch.cuda.memory_allocated() - before <= \
        dense_state_bytes(model, n) / 100
    del on_card


def _flywheel_setup(cuda, background):
    """A 6-gateway federation at width 16 served through the continuous
    front with a flywheel: every gateway's reservoir over min_rows."""
    from fedmse_tpu_torch.config import ExperimentConfig
    from fedmse_tpu_torch.flywheel import FlywheelBuffer, FlywheelController
    from fedmse_tpu_torch.serving import (ContinuousBatcher, DriftMonitor,
                                          fit_calibration)
    n, dim = 6, 16
    clients = synthetic_clients(n_clients=n, dim=dim, n_normal=400,
                                n_abnormal=60, seed=3)
    data = stack_clients(clients, np.zeros((40, dim), np.float32), 12,
                         device=cuda)
    model = make_model("hybrid", dim, 8, 3, device=cuda)
    params = init_stacked_params(model, n, torch.Generator().manual_seed(1),
                                 device=cuda)
    eng = ServingEngine.from_federation(model, "hybrid", params,
                                        data.train_xb, data.train_mb,
                                        score_kind="knn", knn_bank_size=64,
                                        max_bucket=64, device=cuda)
    cal = fit_calibration(eng, data.valid_x.cpu().numpy(),
                          data.valid_m.cpu().numpy(), percentile=99.0)
    buf = FlywheelBuffer(n, dim, capacity=96, seed=0)
    front = ContinuousBatcher(eng, max_batch=32, latency_budget_ms=1e9,
                              calibration=cal, drift=DriftMonitor(cal),
                              intake=buf.tap())
    cfg = ExperimentConfig(network_size=n, dim_features=dim, hidden_neus=8,
                           latent_dim=3, epochs=3, batch_size=12)
    ctl = FlywheelController(front, front.drift, buf, model, "hybrid",
                             "mse_avg", cfg, dev_x=np.zeros((40, dim)),
                             rounds=2, min_rows=32, background=background)
    rows = data.train_xb.reshape(n, -1, dim)[:, :80].cpu().numpy()
    for g in range(n):
        buf.admit(rows[g], np.full(80, g, np.int32))
    stream = data.test_x.cpu().numpy()[:, :40].reshape(-1, dim)
    gws = np.repeat(np.arange(n, dtype=np.int32), 40)
    return eng, front, ctl, buf, stream, gws


def _flat(ctl):
    return ctl.runner.layout.flatten(ctl.batcher.engine.params)


def test_background_finetune_capture_overlaps_a_streaming_front(cuda):
    """The fine-tune's round graphs are captured on the executor's thread
    while the serving thread streams, copies and waits on the card: no
    capture error, no ticket dropped, the served params unchanged until
    the install, and the fine-tuned params the synchronous fine-tune's
    bits from the same snapshot (a fresh engine on the main thread)."""
    from fedmse_tpu_torch.flywheel import FinetuneRunner
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    eng, front, ctl, buf, stream, gws = _flywheel_setup(cuda, True)
    seen = {}
    real = ctl.runner.run

    def spy(finetune, warm, rngs, rounds, assignment=None):
        seen.update(finetune=finetune, warm=warm.clone(), run=rngs.run)
        out = real(finetune, warm, rngs, rounds, assignment)
        seen["params"] = ctl.runner.layout.flatten(out[0])
        return out

    ctl.runner.run = spy
    before = _flat(ctl)
    blocks = []
    assert ctl.trigger(np.asarray([0])) is None and ctl.finetune_pending
    chunks = 0
    while ctl.finetune_pending:
        blocks.append(front.submit_many(stream, gws))
        front.drain()
        assert torch.equal(_flat(ctl), before) or eng.swap_count == 1
        chunks += 1
        ctl.poll()
    torch.cuda.synchronize()
    assert eng.swap_count == 1 and len(ctl.events) == 1
    assert chunks >= 1 and all(b.done for b in blocks)
    st = front.stats()
    assert st["rows_served"] == st["rows_submitted"]
    assert not torch.equal(_flat(ctl), before)
    sync = FinetuneRunner(ctl.model, ctl.runner.cfg, "hybrid", "mse_avg",
                          ctl.runner.n_real, cuda)
    tree, _, _ = sync.run(seen["finetune"], seen["warm"],
                          ExperimentRngs(run=seen["run"]), ctl.rounds)
    assert torch.equal(sync.layout.flatten(tree), seen["params"])
    fused = next(iter(ctl.runner._engines.values()))._fused
    assert all(b.captured for b in (fused.enter, fused.epoch,
                                             fused.leave))


def test_served_params_unchanged_until_the_install(cuda):
    """A synchronous fine-tune on the card trains clones: the served params
    are their bits before and after the fine-tune, and change only at the
    install; a second fine-tune of the same shapes reuses the captured
    engine."""
    eng, front, ctl, buf, stream, gws = _flywheel_setup(cuda, False)
    real = ctl.runner.run
    checks = []

    def checked(finetune, warm, rngs, rounds, assignment=None):
        served = _flat(ctl)
        assert torch.equal(served, warm)
        out = real(finetune, warm, rngs, rounds, assignment)
        torch.cuda.synchronize()
        checks.append(torch.equal(_flat(ctl), served))
        return out

    ctl.runner.run = checked
    before = _flat(ctl)
    event = ctl.trigger(np.asarray([0]))
    assert event is not None and checks == [True]
    assert not torch.equal(_flat(ctl), before)
    rows = stream.reshape(6, 40, -1)
    for g in range(6):
        for _ in range(2):
            buf.admit(rows[g], np.full(40, g, np.int32))
    ctl._cooldown = 0
    assert ctl.trigger(np.asarray([1])) is not None
    assert checks == [True, True] and ctl.runner.engines_built == 1


def _net_replicas(cuda, n, score_kind="knn", precision="f32"):
    """n LocalReplicas over one 8-gateway federation at 115/27/7 on the
    card, each engine its own (the same params), each on its own stream."""
    from fedmse_tpu_torch.net.router import make_local_replicas
    gen = torch.Generator().manual_seed(3)
    model = make_model("hybrid", 115, 27, 7, device=cuda)
    params = init_stacked_params(model, 8, gen, device=cuda)
    train_x = np.random.default_rng(3).normal(
        size=(8, 256, 115)).astype(np.float32)
    engines = [ServingEngine.from_federation(
        model, "hybrid", params, train_x=train_x, max_bucket=256,
        score_kind=score_kind, knn_bank_size=128, knn_k=4, device=cuda,
        precision=precision)
        for _ in range(n)]
    return make_local_replicas(lambda i: engines[i], n, max_batch=256,
                               latency_budget_ms=1e9)


def test_replica_streams_give_the_default_streams_bits(cuda):
    """Each LocalReplica issues its buckets on its own CUDA stream; a row's
    score is the same bits whichever replica (stream) scored it, and the
    bits of the engine's own blocking score on the default stream."""
    from fedmse_tpu_torch.net.router import Router
    reps = _net_replicas(cuda, 3)
    assert len({id(r.stream) for r in reps}) == 3
    assert all(r.stream != torch.cuda.current_stream(cuda) for r in reps)
    rng = np.random.default_rng(5)
    rows = rng.normal(size=(3 * 256, 115)).astype(np.float32)
    gws = rng.integers(0, 8, 3 * 256).astype(np.int32)
    want = reps[0].engine.score(rows, gws)
    for shift in range(3):  # every slice through every replica
        router = Router(reps)
        router._rr = shift
        res = router.submit_many(rows, gws)
        router.drain()
        assert res.finalize()
        np.testing.assert_array_equal(res.scores.view(np.int32),
                                      want.view(np.int32))


def test_swap_placed_on_an_executor_thread_is_read_whole(cuda):
    """A wire swap's payload placed on an executor thread (server.
    _prepare_swap_payload) and installed by the router: every replica
    stream's next bucket scores under the whole new state (the bits of
    an engine built on it), and the install copied nothing."""
    import concurrent.futures
    import pickle
    from fedmse_tpu_torch.net.client import host_payload
    from fedmse_tpu_torch.net.router import Router
    from fedmse_tpu_torch.net.server import _prepare_swap_payload
    reps = _net_replicas(cuda, 2)
    router = Router(reps)
    fresh = _net_replicas(cuda, 1)[0].engine
    gen = torch.Generator().manual_seed(11)
    params2 = init_stacked_params(fresh.model, 8, gen, device=cuda)
    fresh.swap_state(params=params2)
    body = pickle.dumps(host_payload({"params": fresh.params,
                                      "banks": fresh.banks}), 4)
    rng = np.random.default_rng(6)
    rows = rng.normal(size=(512, 115)).astype(np.float32)
    gws = rng.integers(0, 8, 512).astype(np.int32)
    # keep both replica streams busy while the payload lands
    for _ in range(4):
        router.submit_many(rows, gws)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        placed = pool.submit(_prepare_swap_payload, body, (
            cuda, reps[0].engine.policy.compute_dtype)).result()
    router.swap(**placed)
    res = router.submit_many(rows, gws)
    router.drain()
    assert res.finalize()
    want = fresh.score(rows, gws)
    np.testing.assert_array_equal(res.scores.view(np.int32),
                                  want.view(np.int32))
    for rep in reps:
        assert rep.engine.params["encoder"]["Dense_0"]["kernel"].data_ptr() \
            == placed["params"]["encoder"]["Dense_0"]["kernel"].data_ptr()
        assert rep.engine.banks.latents.data_ptr() == \
            placed["banks"].latents.data_ptr()


def test_in_process_bf16_swap_reads_the_payload_whole(cuda):
    """An in-process Router.swap of f32 params into bf16 replicas, the
    payload written on the default stream just before (behind a long
    sleep kernel) and dropped just after: each replica's stream casts it
    only once written, so every replica then scores the bits of an
    engine built on the new params."""
    from fedmse_tpu_torch.net.router import Router
    reps = _net_replicas(cuda, 2, precision="bf16")
    router = Router(reps)
    fresh = _net_replicas(cuda, 1, precision="bf16")[0].engine
    gen = torch.Generator().manual_seed(12)
    params2 = init_stacked_params(fresh.model, 8, gen, device=cuda)
    rng = np.random.default_rng(7)
    rows = rng.normal(size=(512, 115)).astype(np.float32)
    gws = rng.integers(0, 8, 512).astype(np.int32)
    for _ in range(4):  # keep both replica streams busy
        router.submit_many(rows, gws)
    torch.cuda._sleep(200_000_000)  # the payload lands late on this stream
    payload = {c: {n: {k: v.clone() for k, v in layer.items()}
                   for n, layer in coder.items()}
               for c, coder in params2.items()}
    router.swap(params=payload)
    del payload
    res = router.submit_many(rows, gws)
    router.drain()
    assert res.finalize()
    fresh.swap_state(params=params2)
    want = fresh.score(rows, gws)
    np.testing.assert_array_equal(res.scores.view(np.int32),
                                  want.view(np.int32))


# ---- the client mesh (parallel/) on the card ---- #

def test_codec_on_card_is_the_cpu_codes_and_scales(cuda):
    from fedmse_tpu_torch.parallel.quantize import (quantize_blockwise,
                                                    quantize_blockwise_k)
    gen = torch.Generator().manual_seed(7)
    x = torch.randn((3, 6764), generator=gen) * torch.tensor(
        [[1e-3], [1.0], [40.0]])
    x[1, :512] = 0.0  # zero blocks: scale 1, codes 0
    for block in (64, 256):
        qc, sc = quantize_blockwise_k(x, block)
        qg, sg = quantize_blockwise_k(x.to(cuda), block)
        assert torch.equal(qg.cpu(), qc) and torch.equal(sg.cpu(), sc)
        q1, s1 = quantize_blockwise(x[2].to(cuda), block)
        assert torch.equal(q1.cpu(), qc[2]) and torch.equal(s1.cpu(), sc[2])


def test_world_one_nccl_shardmap_merge_is_einsum_bits(cuda, tmp_path):
    """A one-rank NCCL group: the exact collective merge's gather goes
    through NCCL and gives the dense merge's bits; one-group quantized is
    shard_map's bits."""
    import torch.distributed as dist

    from fedmse_tpu_torch.federation.aggregation import make_aggregate_fn
    from fedmse_tpu_torch.parallel import collectives as coll
    from fedmse_tpu_torch.parallel import multihost
    from fedmse_tpu_torch.parallel.mesh import client_mesh
    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    multihost.initialize(store=dist.FileStore(str(tmp_path / "store"), 1),
                         world_size=1, rank=0, backend="nccl", device="cuda")
    try:
        mesh = client_mesh(device=cuda)
        assert mesh.backend == "nccl" and mesh.group.pg is not None
        model = make_model("hybrid", 115, 27, 7, device=cuda)
        gen = torch.Generator().manual_seed(3)
        p = (torch.randn((10, ParamLayout(115, 27, 7).size), generator=gen)
             * 0.2).to(cuda)
        sel = torch.tensor([1, 0, 1, 1, 0, 1, 1, 0, 1, 1.0], device=cuda)
        dev_x = torch.randn((256, 115), generator=gen).to(cuda)
        for ut in ("avg", "mse_avg"):
            m, w = make_aggregate_fn(model, ut)(p, sel, dev_x)
            ms, ws = coll.make_shardmap_aggregate(model, ut, mesh)(p, sel,
                                                                   dev_x)
            mq, _ = coll.make_hierarchical_aggregate(
                model, ut, mesh, num_groups=1)(p, sel, dev_x)
            assert torch.equal(ms, m) and torch.equal(ws, w)
            assert torch.equal(mq, ms)
    finally:
        multihost.shutdown()


# ---- the real-data pipeline ---- #

def test_host_reader_builds_beside_the_kernels(cuda, tmp_path):
    """The CSV reader builds with the host compiler into the kernels'
    build directory, on a machine with the card, and parses to
    np.loadtxt's float64 bits."""
    from fedmse_tpu_torch.data.fast_csv import read_dir_f64
    from fedmse_tpu_torch.ops import native
    native.build(native.KERNEL_SOURCES + native.HOST_SOURCES)
    libs = [native.library_path(n) for n in
            native.KERNEL_SOURCES + native.HOST_SOURCES]
    assert all(p.exists() and p.parent == native.BUILD_DIR for p in libs)
    rows = np.random.default_rng(0).normal(size=(257, 115)) * 1e3
    np.savetxt(tmp_path / "data.csv", rows, delimiter=",", fmt="%.17g")
    got = read_dir_f64(str(tmp_path), allow_header=False)
    want = np.loadtxt(tmp_path / "data.csv", delimiter=",", ndmin=2)
    assert np.array_equal(got.view(np.int64), want.view(np.int64))


def _small_raw_tree(root, devices=3, dim=16, n=240):
    rng = np.random.default_rng(4)
    header = ",".join(f"f{j}" for j in range(dim))
    for i in range(devices):
        shift = rng.normal(0, 2.0, size=dim)
        for sub, name, rows in (
                ("normal", "benign_traffic.csv",
                 rng.normal(0, 1, (n, dim)) + shift),
                ("abnormal", "mirai_udp.csv",
                 rng.normal(4, 2, (n // 2, dim)) + shift)):
            d = root / f"Device_{i}" / sub
            d.mkdir(parents=True, exist_ok=True)
            np.savetxt(d / name, rows, delimiter=",", fmt="%.7g",
                       header=header, comments="")


def test_realdata_driver_run_on_card(cuda, tmp_path):
    """[realdata]'s path at width 16: shards from a raw tree (the k-means
    of --cluster-labels on the card: the same labels on a second run, the
    CPU's partition up to a permutation), then `main --dataset-config` on the card, which
    launches the train and forward kernels and reaches the CPU run's AUC
    within 2e-3."""
    import json
    from fedmse_tpu_torch.config import DatasetConfig
    from fedmse_tpu_torch.data import prep
    from fedmse_tpu_torch.main import main
    _small_raw_tree(tmp_path / "raw")
    pooled = prep.pool_raw_devices(str(tmp_path / "raw"), benign_frac=1.0,
                                   abnormal_frac=1.0)
    on_card = prep.relabel_by_clusters(pooled, 3, seed=0, device=cuda)
    again = prep.relabel_by_clusters(pooled, 3, seed=0, device=cuda)
    on_cpu = prep.relabel_by_clusters(pooled, 3, seed=0, device="cpu")
    for split in prep.SPLITS:
        # one seed, one labelling: the center update has no atomics
        assert np.array_equal(on_card[split][1], again[split][1])
        pairs = set(zip(on_card[split][1].tolist(), on_cpu[split][1].tolist()))
        assert len(pairs) == 3, split
    prep.main(["--raw", str(tmp_path / "raw"), "--out",
               str(tmp_path / "shards"), "--n-clients", "4", "--mode",
               "noniid", "--alpha", "1.0", "--benign-frac", "1.0",
               "--abnormal-frac", "1.0", "--cluster-labels", "3"])
    ds = tmp_path / "ds.json"
    ds.write_text(json.dumps(DatasetConfig.for_client_dirs(
        str(tmp_path / "shards"), 4).to_json()))
    finals = {}
    for device in ("cuda", "cpu"):
        before = fused_train_grads.launches, fused_forward_stats.launches
        out = main(["--dataset-config", str(ds), "--network-size", "4",
                    "--model-types", "hybrid", "--update-types", "mse_avg",
                    "--dim-features", "16", "--hidden-neus", "8",
                    "--latent-dim", "3", "--no-save", "--checkpoint-dir",
                    str(tmp_path / device), "--device", device])
        finals[device] = np.asarray(
            out["results"]["hybrid/mse_avg/run0"]["final_metrics"])
        if device == "cuda":
            assert fused_train_grads.launches > before[0]
            assert fused_forward_stats.launches > before[1]
    assert np.isfinite(finals["cuda"]).all()
    assert abs(finals["cuda"].mean() - finals["cpu"].mean()) <= 2e-3


@pytest.mark.parametrize("key", [(987654321, 0x564F5445),
                                 (10000, 0x4348414F, 0x52454C45)])
def test_keyed_tie_break_row_on_card_is_the_cpu_bits(cuda, key):
    """The keyed tie-break (utils/seeding.keyed_uniform_row) on the card:
    the same bits as on the CPU and as its numpy twin, at 100,000 lanes
    with pad ids, under a captured graph too (the tier's `leave` body
    computes it there, reading the round from a device buffer)."""
    from fedmse_tpu_torch.ops.graphs import CapturedBody
    from fedmse_tpu_torch.utils.seeding import (key_words,
                                                keyed_uniform_row,
                                                keyed_uniform_row_np)
    ids = np.arange(100_000, dtype=np.int64) * 21_473 % (2 ** 33)
    ids[::97] = -1
    k = torch.tensor(key_words(key), dtype=torch.int64)
    voters = torch.tensor([[0], [1], [4095], [99_999]])
    rounds = torch.zeros((), dtype=torch.int64, device=cuda)
    out = torch.empty((4, ids.size), device=cuda)
    args = (k.to(cuda), rounds, voters.to(cuda),
            torch.from_numpy(ids).to(cuda))
    body = CapturedBody(lambda: out.copy_(keyed_uniform_row(*args)), cuda,
                        "keyed row")
    for t in (3, 17):  # the eager first call, then a replay
        rounds.fill_(t)
        body()
        torch.cuda.synchronize()
        cpu = keyed_uniform_row(k, torch.tensor(t), voters,
                                torch.from_numpy(ids))
        assert torch.equal(out.cpu().view(torch.int32), cpu.view(torch.int32))
        np.testing.assert_array_equal(
            cpu.numpy(), keyed_uniform_row_np(key, t, voters.numpy(), ids))


@pytest.mark.parametrize("kind", ["dense", "batched"])
def test_keyed_fused_round_rows_on_card_are_the_cpu_bits(cuda, kind,
                                                         monkeypatch):
    """A fused round above the tie-break's size rule (voting.
    TIE_BREAK_SHEET_BYTES lowered to 0: keyed) on the card, 4 clients, 2
    rounds: it holds no draws, and the vote and re-election rows its
    elections computed from its own device buffers (each run's key in the
    batched round) are the CPU's bits and the numpy twin's."""
    from fedmse_tpu_torch.config import CompatConfig, ExperimentConfig
    from fedmse_tpu_torch.federation import RoundEngine, voting
    from fedmse_tpu_torch.federation.batched import BatchedRunEngine
    from fedmse_tpu_torch.utils.seeding import (ExperimentRngs,
                                                keyed_uniform_row_np)
    monkeypatch.setattr(voting, "TIE_BREAK_SHEET_BYTES", 0)
    n = 4
    cfg = ExperimentConfig(dim_features=16, hidden_neus=8, latent_dim=3,
                           network_size=n, epochs=2, num_participants=1.0,
                           compat=CompatConfig(vote_tie_break=True))
    clients = synthetic_clients(n_clients=n, dim=16, n_normal=240,
                                n_abnormal=120, seed=0)
    dev_x = np.concatenate([c.dev_raw for c in clients])[:200].astype(
        np.float32)
    data = stack_clients(clients, dev_x, 12, device=cuda)
    model = make_model("hybrid", 16, 8, 3, cfg.shrink_lambda, device=cuda)
    if kind == "dense":
        eng = RoundEngine(model, cfg, data, n_real=n,
                          rngs=ExperimentRngs(run=0), model_type="hybrid",
                          update_type="mse_avg", fused=True)
        res = eng.run_rounds(0, 2)
        keys = {"vote": [eng.rngs.vote_key()],
                "reelect": [eng.rngs.reelect_key()]}
    else:
        eng = BatchedRunEngine(model, cfg, data, n_real=n, runs=3,
                               model_type="hybrid", update_type="mse_avg")
        outs, _, _ = eng.run_schedule_chunk(0, 2, np.ones(3, bool))
        res = [o for row in outs for o in row]
        keys = {"vote": [r.vote_key() for r in eng.rngs],
                "reelect": [r.reelect_key() for r in eng.rngs]}
    assert eng.keyed_tie_break
    f = eng.fused_round()
    assert f.u is None and f.u_all is None
    assert all(np.isfinite(r.client_metrics if kind == "dense"
                           else r.metrics).all() for r in res)
    torch.cuda.synchronize()
    assert int(f.round_t) == 1
    voters = torch.arange(n, device=cuda)
    for name, key_list in keys.items():
        src = voting.KeyedDraws(f.tie_key[name], f.round_t, f.lane_ids)
        pos = voters if kind == "dense" else voters.expand(3, n)
        card = src.rows(pos).cpu()
        cpu = voting.KeyedDraws(src.key.cpu(), src.round.cpu(),
                                src.ids.cpu()).rows(pos.cpu())
        assert torch.equal(card.view(torch.int32), cpu.view(torch.int32))
        for r, key in enumerate(key_list):
            twin = keyed_uniform_row_np(key, 1, np.arange(n)[:, None],
                                        np.arange(n))
            row = cpu if kind == "dense" else cpu[r]
            np.testing.assert_array_equal(row.numpy(), twin)


def test_round_ledger_tiles_each_chunk_on_card(cuda):
    """The fused round's ledger on the card (utils/profiling.py): in each
    chunk the rounds' body and idle device ms add up to the chunk's
    marker-to-marker device span within 1%, every field is finite and
    >= 0, and the chunks chain their edges; rounds that stop early count
    one speculative epoch."""
    import time

    from fedmse_tpu_torch.config import CompatConfig, ExperimentConfig
    from fedmse_tpu_torch.federation import (RoundEngine,
                                             run_pipelined_schedule)
    from fedmse_tpu_torch.utils import profiling
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    cfg = ExperimentConfig(dim_features=12, hidden_neus=8, latent_dim=3,
                           network_size=6, epochs=4, patience=1,
                           lr_rate=0.2, batch_size=8,
                           compat=CompatConfig(vote_tie_break=False))
    clients = synthetic_clients(n_clients=6, dim=12, n_normal=120,
                                n_abnormal=60, seed=3)
    dev_x = np.concatenate([c.dev_raw for c in clients])[:100].astype(
        np.float32)
    data = stack_clients(clients, dev_x, 8, device=cuda)
    eng = RoundEngine(make_model("hybrid", 12, 8, 3, cfg.shrink_lambda,
                                 device=cuda), cfg, data, n_real=6,
                      rngs=ExperimentRngs(run=0), model_type="hybrid",
                      update_type="mse_avg", fused=True)
    t0 = time.perf_counter()
    run_pipelined_schedule(eng, 0, 9, 3, lambda rs, sec: None,
                           can_rewind=False)
    seconds = time.perf_counter() - t0
    chunks = [c for c in profiling.recent_chunks() if c["t_dispatch"] >= t0]
    assert [c["first_round"] for c in chunks] == [0, 3, 6]
    for c in chunks:
        parts = [r[k] for r in c["rounds"] for k in profiling.ROUND_MS]
        assert all(np.isfinite(v) and v >= 0 for v in parts)
        assert c["span_ms"] > 0
        assert sum(parts) == pytest.approx(c["span_ms"], rel=0.01)
        for r in c["rounds"]:
            spec = r["epoch_replays"] - r["epochs_run"]
            assert spec in (0, 1) and (r["speculative_ms"] > 0) == (spec > 0)
    for a, b in zip(chunks, chunks[1:]):
        assert b["edge_from"] == a["seq"]
        assert np.isfinite(b["idle_chunk_edge_ms"])
        assert b["idle_chunk_edge_ms"] >= 0
    window = profiling.ledger_window(t0, seconds)
    assert window["rounds"] == 9
    assert eng._fused.epochs_run == [r["epochs_run"] for c in chunks
                                     for r in c["rounds"]]


# -- the local-training step's update (csrc/adam_update.cu) -----------------

UPDATE_LR, UPDATE_MU = 1e-3, 0.001


def _update_inputs(s, p, device, seed=0):
    """A step's update inputs on `device`: params, Adam state (some counts
    at int32's max), grads, anchors, the batch's losses, a running loss sum,
    and has_b / active flags with NaN grads and losses in rows that do not
    step (an all-masked batch)."""
    from fedmse_tpu_torch.federation.optim import AdamState
    gen = torch.Generator().manual_seed(seed)
    params = (torch.rand((s, p), generator=gen) - 0.5) * 0.4
    grads = torch.randn((s, p), generator=gen) * 1e-2
    opt = AdamState(torch.randint(0, 400, (s,), generator=gen,
                                  dtype=torch.int32),
                    torch.randn((s, p), generator=gen) * 1e-3,
                    torch.rand((s, p), generator=gen) * 1e-5)
    opt.count[1::7] = np.iinfo(np.int32).max
    prev = params + torch.randn((s, p), generator=gen) * 1e-2
    loss = torch.rand(s, generator=gen) + 0.5
    loss_sum = torch.rand(s, generator=gen) * 5
    has = torch.rand(s, generator=gen) < 0.8
    active = torch.rand(s, generator=gen) < 0.8
    has[0], active[0] = True, True
    grads[~has | ~active] = float("nan")
    loss[~has] = float("nan")
    move = lambda t: t.to(device)  # noqa: E731
    return (move(params), AdamState(*map(move, opt)), move(grads),
            move(prev), move(loss), move(loss_sum), move(has), move(active))


def _run_update(fn, inputs, fedprox, place=torch.clone):
    """fn on copies of `inputs` made by `place`: (params, count, mu, nu,
    loss_sum)."""
    from fedmse_tpu_torch.federation.optim import AdamState
    params, opt, grads, prev, loss, loss_sum, has, active = inputs
    params, loss_sum = place(params), loss_sum.clone()
    opt = AdamState(opt.count.clone(), *(place(t) for t in opt[1:]))
    fn(params, opt, grads, UPDATE_LR, has, active=active, loss=loss,
       loss_sum=loss_sum, prev=prev if fedprox else None,
       prox_mu=UPDATE_MU)
    return params, *opt, loss_sum


def _prox_sum_bound(inputs, result):
    """How far summation order alone moves the FedProx loss sum, per row:
    two orders of a sum of P non-negative terms each lie within
    (P - 1) 2^-24 of it, so mu times their gap, plus a rounding flip in
    each of the three roundings after the sum (mu x, loss +, loss_sum +):
    3 ulp of the loss sum, which is the largest of the three."""
    params, _, _, prev, _, _, _, _ = inputs
    p = params.shape[1]
    prox = ((params.double() - prev.double()) ** 2).sum(dim=1).float()
    out = result.abs()
    ulp = torch.nextafter(out, torch.full_like(out, float("inf"))) - out
    return 2 * (p - 1) * 2.0 ** -24 * UPDATE_MU * prox + 3 * ulp


@pytest.mark.parametrize("fedprox", [False, True])
@pytest.mark.parametrize("p", [6764, 339])
@pytest.mark.parametrize("s", [5, 250, 512])
def test_update_kernel_matches_plain_bit_for_bit(cuda, s, p, fedprox):
    """The kernel against the op sequence it replaces (the plain version on
    the card): p, mu, nu and count bit for bit; the loss sum bit for bit
    without FedProx and within the prox sum's reordering bound under it
    (the one sum the kernel takes in its own order, fixed by P). Rows that
    do not step keep every bit, NaN grads there included. P = 339 takes the
    scalar path (P % 4 != 0)."""
    from fedmse_tpu_torch.ops.adam_update import (adam_update,
                                                  adam_update_plain)
    inputs = _update_inputs(s, p, cuda, seed=s + p)
    before = adam_update.launches
    got = _run_update(adam_update, inputs, fedprox)
    assert adam_update.launches == before + 1
    want = _run_update(adam_update_plain, inputs, fedprox)
    torch.cuda.synchronize()
    for name, a, b in zip(("params", "count", "mu", "nu"), got, want):
        assert torch.equal(_bits(a), _bits(b)), name
    if fedprox:
        gap = (got[-1] - want[-1]).abs()
        assert (gap <= _prox_sum_bound(inputs, want[-1])).all()
    else:
        assert torch.equal(_bits(got[-1]), _bits(want[-1]))
    params, opt, *_, has, active = inputs
    still = ~(has & active)
    assert still.any()
    for a, b in zip(got[:4], (params, *opt)):
        assert torch.equal(_bits(a[still]), _bits(b[still]))
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[-1]).all()


@pytest.mark.parametrize("fedprox", [False, True])
def test_update_kernel_row_alone_equals_row_in_cohort(cuda, fedprox):
    """A row's bits are the same updated alone as inside a cohort of 250,
    and with misaligned buffers (the scalar path): the FedProx sum's order
    is fixed by P alone."""
    from fedmse_tpu_torch.ops.adam_update import adam_update
    inputs = _update_inputs(250, 6764, cuda, seed=5)
    whole = _run_update(adam_update, inputs, fedprox)

    def misaligned(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    shifted = list(inputs)
    shifted[2], shifted[3] = misaligned(inputs[2]), misaligned(inputs[3])
    assert shifted[2].data_ptr() % 16 != 0
    again = _run_update(adam_update, shifted, fedprox, place=misaligned)
    for a, b in zip(whole, again):
        assert torch.equal(_bits(a), _bits(b))
    has, active = inputs[-2], inputs[-1]
    rows = [0, int((~active).nonzero()[0]), int((~has).nonzero()[0])]
    opt = inputs[1]
    for k in rows:
        one = [t[k:k + 1] for t in inputs]
        one[1] = type(opt)(*(t[k:k + 1] for t in opt))
        alone = _run_update(adam_update, one, fedprox)
        for a, b in zip(alone, whole):
            assert torch.equal(_bits(a), _bits(b[k:k + 1])), k


def test_update_kernel_graph_replay_equals_eager(cuda):
    """The update captured in a CUDA graph (one kernel node, counted as
    one adam_update a replay) gives the eager call's bits."""
    from fedmse_tpu_torch.federation.optim import AdamState
    from fedmse_tpu_torch.ops.adam_update import adam_update
    inputs = _update_inputs(250, 6764, cuda, seed=6)
    want = _run_update(adam_update, inputs, True)
    params, opt, grads, prev, loss, loss_sum, has, active = inputs
    work = [params.clone(), AdamState(*(t.clone() for t in opt)),
            loss_sum.clone()]

    def body():
        work[0].copy_(params)
        work[1].copy_(opt)
        work[2].copy_(loss_sum)
        adam_update(work[0], work[1], grads, UPDATE_LR, has, active=active,
                    loss=loss, loss_sum=work[2], prev=prev,
                    prox_mu=UPDATE_MU)

    graphed = _captured(body, [work[0]])
    graphed()  # the eager warm-up and the capture
    assert graphed.kernels == {"adam_update": 1}
    for _ in range(2):
        work[0].zero_()
        graphed()
        torch.cuda.synchronize()
        for a, b in zip((work[0], *work[1], work[2]), want):
            assert torch.equal(_bits(a), _bits(b))


def test_update_kernel_refused_launch_raises(cuda, monkeypatch):
    """A launch the card refuses (a cluster of 16 CTAs, above the portable
    8 the kernel is not allowed beyond) raises at the call."""
    from fedmse_tpu_torch.ops import adam_update as mod
    inputs = _update_inputs(5, 6764, cuda, seed=7)
    monkeypatch.setattr(mod, "row_ctas", lambda p: 16)
    before = mod.adam_update.launches
    with pytest.raises(RuntimeError, match="adam_update launch failed"):
        _run_update(mod.adam_update, inputs, True)
    assert mod.adam_update.launches == before


def test_epoch_graph_runs_two_kernels_a_step(cuda):
    """The local-training epoch captured as a graph: each batch step adds
    exactly two nodes (the train kernel and the update), and the graph
    counts one fused_ae_train and one adam_update a step."""
    from fedmse_tpu_torch.federation.local_training import LocalTrainer
    from fedmse_tpu_torch.federation.state import init_client_states
    model = make_model("autoencoder", 16, 8, 3, device=cuda)
    counts = {}
    for n_normal in (200, 400):
        clients = synthetic_clients(n_clients=4, dim=16, n_normal=n_normal,
                                    n_abnormal=40, seed=1)
        dev_x = np.concatenate([c.dev_raw for c in clients])[:100].astype(
            np.float32)
        data = stack_clients(clients, dev_x, 12, device=cuda)
        states = init_client_states(model, 4,
                                    torch.Generator().manual_seed(2),
                                    device=cuda)
        trainer = LocalTrainer(model, epochs=2, patience=1, fedprox=True,
                               mu=0.001, lr=1e-3)
        idx = torch.tensor([0, 2, 3], device=cuda)
        co = trainer.cohort(idx, states.params, data.train_xb,
                            data.train_mb, data.valid_xb, data.valid_mb)
        trainer.begin(co, states.params, states.opt_state,
                      states.prev_global, data.train_xb, data.train_mb,
                      data.valid_xb, data.valid_mb)
        graphed = _captured(lambda: trainer.epoch(co), [co.p])
        graphed()
        nb = data.train_xb.shape[1]
        assert graphed.kernels == {"fused_ae_train": nb, "adam_update": nb,
                                   "fused_ae_forward": 1}
        counts[nb] = graphed.nodes
    (nb1, n1), (nb2, n2) = sorted(counts.items())
    assert nb2 > nb1 and n2 - n1 == 2 * (nb2 - nb1)


# ---- KitNET (ops/kitnet.py, csrc/kitnet.cu) ---- #

def _kitnet_federation(device, n=10, rows=600, seed=0):
    """A federation of n gateways in N-BaIoT's layout (23 statistics x 5
    windows, the windows of one statistic correlated at 0.9), min-max
    scaled by each gateway's train rows; returns (data, feature map)."""
    from fedmse_tpu_torch.data.stacking import FederatedData
    from fedmse_tpu_torch.models import kitnet
    g = torch.Generator().manual_seed(seed)
    stat_of = torch.tensor([s for first, count in ((0, 3), (3, 3), (6, 7),
                                                   (13, 3), (16, 7))
                            for _ in range(5)
                            for s in range(first, first + count)])

    def rows_of(k):
        u = torch.randn((n, k, 23), generator=g)
        eps = torch.randn((n, k, 115), generator=g)
        return 0.9 ** 0.5 * u[:, :, stat_of] + 0.1 ** 0.5 * eps
    normal, abnormal = rows_of(rows), 4.0 + 2.0 * rows_of(rows // 5)
    tr = int(0.4 * rows)
    train = normal[:, :tr]
    lo, hi = train.amin(1, keepdim=True), train.amax(1, keepdim=True)
    scale = lambda t: (t - lo) / (hi - lo)  # noqa: E731

    def batches(t):
        nb = -(-t.shape[1] // 12)
        xb = torch.nn.functional.pad(t, (0, 0, 0, nb * 12 - t.shape[1]))
        mb = (torch.arange(nb * 12) < t.shape[1]).float()
        return (xb.view(n, nb, 12, 115).contiguous(),
                mb.view(1, nb, 12).expand(n, nb, 12).contiguous())
    txb, tmb = batches(scale(train))
    va = scale(normal[:, tr:tr + rows // 10])
    vxb, vmb = batches(va)
    test = torch.cat([scale(normal[:, tr + rows // 10:]), scale(abnormal)],
                     dim=1)
    t_norm = test.shape[1] - abnormal.shape[1]
    data = FederatedData(
        train_xb=txb, train_mb=tmb, valid_xb=vxb, valid_mb=vmb,
        valid_x=va.contiguous(), valid_m=torch.ones(n, va.shape[1]),
        test_x=test.contiguous(), test_m=torch.ones(n, test.shape[1]),
        test_y=torch.cat([torch.zeros(t_norm),
                          torch.ones(abnormal.shape[1])]).expand(
            n, -1).contiguous(),
        dev_x=va.reshape(-1, 115)[:200].contiguous(),
        client_mask=torch.ones(n))
    fmap = kitnet.federated_feature_map(txb, tmb, data.client_mask, 10)
    data = FederatedData(**{k: getattr(data, k).to(device)
                            for k in data.__dataclass_fields__})
    return data, fmap


def _kitnet_models(layout, s, device, seed=4):
    """s models on dyadic grids (params k/64 in (-1, 1), statistics k/64
    with lo < hi), one client with nothing seen (hi < lo)."""
    from fedmse_tpu_torch.models import kitnet
    g = torch.Generator().manual_seed(seed)
    flat = torch.randint(-63, 64, (s, layout.size), generator=g) / 64.0
    lo = torch.randint(0, 16, (s, layout.k), generator=g) / 64.0
    hi = lo + torch.randint(1, 48, (s, layout.k), generator=g) / 64.0
    stats = torch.cat([lo, hi], dim=1)
    stats[-1] = kitnet.fresh_stats(1, layout, "cpu")[0]
    return flat.to(device), stats.to(device)


@pytest.mark.parametrize("s", [250, 5])
def test_kitnet_kernels_match_plain_at_the_cells_shapes(cuda, s):
    """Both KitNET kernels against their plain twins at the cell's shapes
    (S clients of 12-row batches, the 115-feature map), inputs on dyadic
    grids: the statistic, the loss and every leaf's gradient within 1e-5
    scale-normalized (f32 summation order and the kernels' FMAs), the
    updated statistics within 1e-6; one launch a call."""
    from fedmse_tpu_torch.models.flat import KitnetLayout
    from fedmse_tpu_torch.ops import kitnet as ops
    data, fmap = _kitnet_federation(cuda)
    layout = KitnetLayout(fmap)
    flat, stats = _kitnet_models(layout, s, cuda)
    g = torch.Generator().manual_seed(5)
    x = (torch.randint(0, 65, (s, 12, 115), generator=g) / 64.0).to(cuda)
    m = torch.ones((s, 12), device=cuda)
    m[1, 9:] = 0.0
    active = torch.ones(s, dtype=torch.bool, device=cuda)
    active[0] = False
    before = ops.kitnet_train_grads.launches
    got_stats = stats.clone()
    loss, grads = ops.kitnet_train_grads(flat, got_stats, x, m,
                                         layout=layout, active=active)
    assert ops.kitnet_train_grads.launches == before + 1
    want_stats = stats.clone()
    w_loss, w_grads = ops.kitnet_train_grads_plain(
        flat, want_stats, x, m, layout=layout, active=active)
    assert torch.equal(got_stats[0], stats[0])
    assert (got_stats - want_stats).abs().max() <= 1e-6 * \
        want_stats.abs().max()
    assert (loss - w_loss).abs().max() <= 1e-5 * w_loss.abs().max()
    for sl in layout.slices():
        assert (grads[:, sl] - w_grads[:, sl]).abs().max() <= \
            1e-5 * w_grads[:, sl].abs().max()
    params = layout.tree(flat, stats=stats)
    rows = x.reshape(-1, 115)
    for idx in (torch.arange(s, dtype=torch.int32, device=cuda)
                .repeat_interleave(12),
                torch.randint(-1, s + 1, (rows.shape[0],), generator=g,
                              dtype=torch.int32).to(cuda)):
        before = ops.kitnet_forward_stats.launches
        got = ops.kitnet_forward_stats(params, rows, idx)
        assert ops.kitnet_forward_stats.launches == before + 1
        want = ops.kitnet_forward_stats_plain(params, rows, idx)
        for a, b in zip(got, want):
            assert torch.equal(torch.isnan(a), torch.isnan(b))
            a, b = torch.nan_to_num(a), torch.nan_to_num(b)
            assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def test_kitnet_train_kernel_is_bitwise_repeatable(cuda):
    from fedmse_tpu_torch.models.flat import KitnetLayout
    from fedmse_tpu_torch.ops import kitnet as ops
    _, fmap = _kitnet_federation(cuda)
    layout = KitnetLayout(fmap)
    flat, stats = _kitnet_models(layout, 250, cuda)
    x = torch.rand((250, 12, 115), device=cuda)
    m = torch.ones((250, 12), device=cuda)
    outs = []
    for _ in range(2):
        st = stats.clone()
        outs.append(ops.kitnet_train_grads(flat, st, x, m, layout=layout)
                    + (st,))
    for a, b in zip(*outs):
        assert torch.equal(_bits(a), _bits(b))


def test_kitnet_main_path_launches_its_kernels(cuda):
    """model_type 'kitnet' through main.run_combination on the card: the
    fused, pipelined schedule launches the KitNET kernels and the update
    and never the autoencoder's; the epoch graph holds one train kernel
    and one update a step and one forward; AUC and params within 2e-3
    and 1e-4 per leaf of the same run on the CPU twins."""
    from fedmse_tpu_torch.config import CompatConfig, ExperimentConfig
    from fedmse_tpu_torch.main import run_combination
    from fedmse_tpu_torch.ops.graphs import WRAPPERS
    cfg = ExperimentConfig(scaler="minmax", num_rounds=3, epochs=2,
                           fused_schedule_chunk=2,
                           compat=CompatConfig(vote_tie_break=False))
    outs = {}
    for device in ("cpu", cuda):
        data, _ = _kitnet_federation(device)
        before = {k: w.launches for k, w in WRAPPERS.items()}
        out = run_combination(cfg, data, 10, "kitnet", "fedprox", 0)
        if device != "cpu":
            torch.cuda.synchronize()
        outs[str(device)] = (out, {k: w.launches - before[k]
                                   for k, w in WRAPPERS.items()})
    (cpu, _), (gpu, launched) = outs["cpu"], outs[str(cuda)]
    assert launched["kitnet_train"] > 0 and launched["kitnet_forward"] > 0
    assert launched["adam_update"] == launched["kitnet_train"]
    assert launched["fused_ae_train"] == launched["fused_ae_forward"] == 0
    eng = gpu["engine"]
    nb = eng.data.train_xb.shape[1]
    assert eng.fused_round().epoch.kernels == {
        "kitnet_train": nb, "adam_update": nb, "kitnet_forward": 1}
    a, b = eng.states.params.cpu(), cpu["engine"].states.params
    for sl in eng.layout.slices():
        assert (a[:, sl] - b[:, sl]).abs().max() <= \
            1e-4 * b[:, sl].abs().max()
    np.testing.assert_allclose(gpu["final_metrics"], cpu["final_metrics"],
                               atol=2e-3)


def test_kitnet_fused_round_matches_per_phase_round_on_card(cuda):
    """The fused KitNET round (CUDA graphs) against the per-phase round
    from one state and cohort, tie-break off: the same aggregator and
    verification rows; params, statistics and AUC within 1e-6
    scale-normalized (the same kernels in the same order: expected
    bit-equal)."""
    from fedmse_tpu_torch.config import CompatConfig, ExperimentConfig
    from fedmse_tpu_torch.federation import RoundEngine
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    cfg = ExperimentConfig(scaler="minmax", epochs=2,
                           compat=CompatConfig(vote_tie_break=False))
    data, fmap = _kitnet_federation(cuda)

    def engine(fused):
        model = make_model("kitnet", 115, feature_map=fmap, device=cuda)
        return RoundEngine(model, cfg, data, n_real=10,
                           rngs=ExperimentRngs(run=0), model_type="kitnet",
                           update_type="fedprox", fused=fused)
    per, fus = engine(False), engine(True)
    for r in range(2):
        selected = per.select_clients()
        want = per.run_round(r, selected=selected)
        got = fus.run_round(r, selected=selected)
        assert got.aggregator == want.aggregator
        assert got.verification_results == want.verification_results
        np.testing.assert_allclose(got.client_metrics, want.client_metrics,
                                   atol=1e-6)
    for name in ("params", "stats", "prev_global", "hist_params"):
        a = getattr(fus.states, name).cpu()
        b = getattr(per.states, name).cpu()
        assert torch.equal(torch.isinf(a), torch.isinf(b))
        a, b = torch.nan_to_num(a, posinf=0, neginf=0), \
            torch.nan_to_num(b, posinf=0, neginf=0)
        assert (a - b).abs().max() <= 1e-6 * b.abs().max().clamp_min(1e-30)

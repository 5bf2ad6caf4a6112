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


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lam", [0.0, 10.0])
@pytest.mark.parametrize("shape", [(1, 115, 27, 7, 12), (5, 115, 27, 7, 12),
                                   (3, 37, 9, 3, 200), (512, 115, 27, 7, 12),
                                   (2, 16, 8, 3, 1)])
def test_train_kernel_matches_plain_and_counts(cuda, cdt, lam, shape):
    g, d, h, lat, rows = shape
    layout = ParamLayout(d, h, lat)
    flat = _flat_params(layout, g, cuda)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((g, rows, d), generator=gen).to(cuda, cdt)
    mask = (torch.rand((g, rows), generator=gen) < 0.8).float().to(cuda)
    if g > 1:
        mask[-1] = 0.0  # an all-masked client: NaN, as in the reference
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
    wide = ParamLayout(128, 128, 120)  # parameters beyond shared memory
    with pytest.raises(ValueError, match="too wide"):
        fused_train_grads(torch.zeros((1, wide.size), device=cuda),
                          torch.zeros((1, 4, 128), device=cuda),
                          torch.ones((1, 4), device=cuda), layout=wide)


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

"""CUDA kernel tests of the port: they need an NVIDIA card and nvcc and skip
without them. This file imports neither jax nor the JAX package, so on a
machine with a card and no JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances as in chip_smoke.py: scale-normalized 1e-5 in f32 (summation
order only) and 2**-6 in bf16 (a bf16 rounding flip between layers).
"""

import numpy as np
import pytest
import torch

from fedmse_tpu_torch.data import stack_clients, synthetic_clients
from fedmse_tpu_torch.evaluation import make_evaluate_all
from fedmse_tpu_torch.models import init_stacked_params, make_model
from fedmse_tpu_torch.ops.fused_ae import (fused_forward_stats,
                                           fused_forward_stats_plain)
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

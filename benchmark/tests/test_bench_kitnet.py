"""The KitNET cell's yardstick and reference on canned inputs: the roofline
and FLOP counts of `roofline_kitnet.py` against hand counts at the
traffic's nominal map (23 statistics x 5 windows, each statistic's
windows one autoencoder), the reference's written-out backward pass
against autograd, the driver's N-BaIoT column layout, and the kernels'
readers finding nothing to read off the card."""

import types

import pytest
import torch

from benchmark import roofline_kitnet as rk
from benchmark.drivers import federated_kitnet as drv
from benchmark.harness import BENCH, load_file
from benchmark.reference import kitnet as ref
from benchmark.tests.tiny import tiny_cell

NOMINAL = tuple(tuple(range(5 * j, 5 * j + 5)) for j in range(23))


def test_flop_and_parameter_hand_counts():
    # 23 autoencoders 5 -> 4 and the output 23 -> 18
    assert rk.shapes(NOMINAL) == ((5, 4),) * 23 + ((23, 18),)
    assert rk.param_count(NOMINAL) == 23 * (20 + 4 + 5) + (414 + 18 + 23) \
        == 1_122
    assert rk.stats_width(NOMINAL) == 46
    # 2 x 2 n h a row forward; 2 x 5 n h trained
    assert rk.forward_flops_per_row(NOMINAL) == 4 * (23 * 20 + 414) == 3_496
    assert rk.train_flops_per_row(NOMINAL) == 10 * (23 * 20 + 414) == 8_740


def test_bounds_hand_counts():
    ms, what = rk.forward_bound(1_500_000, 500, NOMINAL)
    nbytes = 1_500_000 * (4 * 115 + 4 + 8) + 500 * 4 * (1_122 + 46)
    assert what == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    ms, what = rk.forward_bound(10, 500, NOMINAL)  # more models than rows
    assert ms == pytest.approx((10 * 472 + 10 * 4 * 1_168) / 3.35e12 * 1e3)
    ms, what = rk.train_bound(12, 250, NOMINAL)
    nbytes = 250 * (12 * (4 * 115 + 4) + 4 * 1_122 + 8 * 46 + 4 * 1_122 + 4)
    assert what == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_round_flops_hand_count():
    shapes = {"gateways": 500, "cohort": 250, "epochs": 5,
              "train_rows": 4_000, "valid_rows": 1_000, "test_rows": 3_000,
              "dev_rows": 40_000}
    parts = rk.round_flops(shapes, NOMINAL, "fedprox")
    assert parts["train"] == 250 * 4_000 * 5 * 8_740
    rows = 250 * 1_000 * 5 + 500 * 1_000 + 1_000 + 500 * 3_000
    assert parts["forward"] == rows * 3_496
    mse = rk.round_flops(shapes, NOMINAL, "mse_avg")
    assert mse["forward"] == (rows + 250 * 40_000) * 3_496


@pytest.mark.parametrize("mu", [0.0, 1e-3])
def test_reference_backward_is_autograd(mu):
    fmap = ((0, 3, 5), (1, 2), (4, 6, 7, 8))
    g = torch.Generator().manual_seed(0)
    p = ref.param_count(fmap)
    flat = torch.randn((3, p), generator=g, dtype=torch.float64)
    prev = torch.randn((3, p), generator=g, dtype=torch.float64)
    x = torch.rand((3, 12, 9), generator=g, dtype=torch.float64)
    m = (torch.rand((3, 12), generator=g) > 0.3).to(torch.float64)
    k = len(fmap)
    stats = torch.cat([torch.rand((3, k), generator=g,
                                  dtype=torch.float64) * 0.1,
                       torch.rand((3, k), generator=g,
                                  dtype=torch.float64) + 0.5], dim=1)
    active = torch.tensor([True, False, True])
    loss, grads, new = ref.loss_and_grads(flat, stats, prev, x, m, fmap, mu,
                                          active)
    assert torch.equal(new[1], stats[1])
    leaf = flat.clone().requires_grad_(True)
    _, per_row = ref.rows(leaf, new, x, fmap)
    want = (per_row * m).sum(dim=1) / m.sum(dim=1)
    want = want + mu * torch.square(leaf - prev).sum(dim=1)
    (auto,) = torch.autograd.grad(want.sum(), leaf)
    torch.testing.assert_close(loss, want.detach())
    torch.testing.assert_close(grads, auto)


def test_statistics_update_from_the_real_rows():
    s = torch.tensor([[[0.2, 0.5], [0.1, 0.9], [0.7, 0.0]]])
    m = torch.tensor([[1.0, 1.0, 0.0]])
    fresh = ref.fresh_stats(1, 2, "cpu")
    got = ref.update_stats(fresh, s, m, torch.tensor([True]))
    assert torch.equal(got, torch.tensor([[0.1, 0.5, 0.2, 0.9]]))
    # (hi < lo): s itself; else (s - lo) / (hi - lo + 1e-16)
    assert torch.equal(ref.normalize(s, fresh), s)


def test_columns_follow_n_baiot_layout():
    col = drv.statistic_of_column([3, 3, 7, 3, 7], 5)
    assert col.shape == (115,)
    assert col[:15].tolist() == [0, 1, 2] * 5
    assert col[30:37].tolist() == list(range(6, 13))
    assert sorted(col.tolist()) == sorted(list(range(23)) * 5)
    nominal = drv.shapes_of(tiny_cell("train-kitnet-500gw").traffic,
                            tiny_cell("train-kitnet-500gw").config)
    assert sorted(map(len, nominal["nominal_map"])) == [5] * 4


@pytest.mark.parametrize("name", ["kitnet_train_kernel_roofline.train",
                                  "kitnet_forward_kernel_roofline.train"])
def test_kitnet_readers_find_nothing_to_read(name):
    cell = tiny_cell("train-kitnet-500gw")
    shapes = cell.driver.shapes_of(cell.traffic, cell.config)
    reader = load_file(BENCH / "metrics" / f"{name}.py",
                       f"canned_{name.replace('.', '_')}")
    for on_card, window in ((False, {"feature_map": NOMINAL}),
                            (True, {})):
        ctx = types.SimpleNamespace(
            cell=cell, config=cell.config, traffic=cell.traffic,
            dims=cell.dims, precision="f32", on_card=on_card,
            device=torch.device("cuda" if on_card else "cpu"),
            window=window, trace=None, shapes=shapes, flops_per_round=1e9)
        assert reader.read(ctx) is None

"""The yardstick on canned inputs: the roofline and FLOP counts against
hand counts at the paper's 115/27/7, each per-layer reader on a canned
context, and the trace's reduction on a canned event list."""

import types

import pytest
import torch

from benchmark import roofline
from benchmark.harness import BENCH, load_file
from benchmark.tests.tiny import SPEC, tiny_cell
from benchmark.trace import reduce_events

DIMS = (115, 27, 7)


def test_flops_per_row_hand_counts():
    # 2 (115*27 + 27*7 + 7*27 + 27*115) and the backward's
    # 2 (2*27*115 + 2*7*27 + 2*27*7 + 115*27)
    assert roofline.forward_flops_per_row(DIMS) == 13_176
    assert roofline.train_flops_per_row(DIMS) == 13_176 + 20_142 == 33_318
    assert roofline.param_count(DIMS) == 6_764


def test_bounds_hand_counts():
    ms, what = roofline.train_bound(12, 250, "f32", DIMS)
    nbytes = 250 * (12 * (115 * 4 + 4) + 4 * 6_764 + 4 * 6_765)
    assert what == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    ms, what = roofline.forward_bound(3_504_000, 500, "f32", DIMS)
    assert what == "operations"
    assert ms == pytest.approx(13_176 * 3_504_000 / 67e12 * 1e3)
    ms, what = roofline.dist_bound(1_500_000, 512, 500, 7)
    nbytes = 4.0 * (1_500_000 * 512 + 1_500_000 * 8 + 500 * 512 * 7)
    assert what == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_round_flops_hand_count():
    shapes = {"gateways": 500, "cohort": 250, "epochs": 5,
              "train_rows": 4_000, "valid_rows": 1_000, "test_rows": 3_000,
              "dev_rows": 40_000, "bank": 512}
    parts = roofline.round_flops(shapes, DIMS, "knn", "mse_avg")
    assert parts["train"] == 250 * 4_000 * 5 * 33_318
    rows = (250 * 1_000 * 5 + 500 * 1_000 + 1_000 + 500 * 3_000
            + 250 * 40_000 + 500 * 4_000)
    assert parts["forward"] == rows * 13_176
    assert parts["knn"] == 2 * 7 * 512 * 500 * 3_000
    mse = roofline.round_flops(shapes, DIMS, "mse", "fedprox")
    assert mse["knn"] == 0
    assert mse["forward"] == (rows - 250 * 40_000 - 500 * 4_000) * 13_176


def _ctx(on_card=True, trace=None, **window):
    cell = tiny_cell("train-hybrid-knn-500gw")
    w = {"rounds": 64, "epochs": 200, "window_s": 2.0,
         "graph_replay_s": 0.5,
         "pipeline": {"host_gap_s": [-0.2, 0.004, 0.002]}}
    w.update(window)
    return types.SimpleNamespace(
        cell=cell, config=cell.config, traffic=cell.traffic, dims=cell.dims,
        precision="f32", device=torch.device("cuda" if on_card else "cpu"),
        on_card=on_card, window=w, trace=trace,
        shapes=cell.driver.shapes_of(cell.traffic, cell.config),
        flops_per_round=1e9)


def _read(name, ctx):
    return load_file(BENCH / "metrics" / f"{name}.py",
                     f"canned_{name.replace('.', '_')}").read(ctx)


def test_every_per_layer_metric_has_a_reader():
    for m in SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_readers_on_a_canned_context():
    ctx = _ctx(trace={"busy_s": 0.3, "window_s": 0.4})
    assert _read("pipeline_host_gap_ms.train", ctx) == pytest.approx(
        1e3 * 0.006 / 64)
    assert _read("graph_replay_host_ms.train", ctx) == pytest.approx(
        1e3 * 0.5 / 64)
    assert _read("device_idle_share.train", ctx) == pytest.approx(25.0)
    assert _read("train_mfu", ctx) == pytest.approx(
        100 * 64e9 / 2.0 / 67e12)
    assert _read("epoch_ms.train", ctx) == pytest.approx(1e3 * 2.0 / 200)


def test_readers_find_nothing_to_read():
    ctx = _ctx(on_card=False, pipeline={"host_gap_s": []})
    for name in ("pipeline_host_gap_ms.train", "graph_replay_host_ms.train",
                 "train_kernel_roofline.train",
                 "forward_kernel_roofline.train",
                 "dist_kernel_roofline.train", "device_idle_share.train",
                 "train_mfu", "epoch_ms.train"):
        assert _read(name, ctx) is None, name


def test_reduce_events_on_a_canned_trace():
    ms = 1_000_000
    events = [
        ("cpu", "bench.span", 10 * ms, 60 * ms),
        ("cpu", "fused.epoch", 10 * ms, 40 * ms),
        ("cpu", "cudaEventSynchronize", 30 * ms, 40 * ms),
        ("cpu", "fused.leave", 40 * ms, 60 * ms),
        ("device", "before_span", 0, 12 * ms),
        ("device", "train", 15 * ms, 30 * ms),
        ("device", "adam", 25 * ms, 35 * ms),
        ("device", "train", 42 * ms, 50 * ms),
    ]
    out = reduce_events(events)
    # the span runs from the mark (10 ms) to the last device end (50 ms);
    # busy: [10, 12] + [15, 35] + [42, 50]
    assert out["window_s"] == pytest.approx(0.040)
    assert out["busy_s"] == pytest.approx(0.030)
    assert out["device_ops"][0] == ["train", pytest.approx(0.023)]
    # each gap named by what the host was in when it began
    assert out["idle_gaps"][0] == ["fused.epoch/cudaEventSynchronize",
                                   pytest.approx(0.007)]
    assert out["idle_gaps"][1] == ["fused.epoch/python",
                                   pytest.approx(0.003)]
    assert reduce_events([e for e in events if e[1] != "bench.span"]) is None

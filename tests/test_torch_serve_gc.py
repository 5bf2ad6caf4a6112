"""The --serve pass keeps the garbage collector's full collections off its
stream: `run_serve_smoke` freezes every object alive after setup
(gc.freeze) for the stream and unfreezes them after it, also when the stream
raises. Driven through the port's CLI on the CPU, as
tests/test_torch_knn_serving.py drives it."""

import gc
import json
import os

import pytest
import torch

from fedmse_tpu_torch.config import DatasetConfig
from fedmse_tpu_torch.main import main as port_main
from fedmse_tpu_torch.serving import ContinuousBatcher, MicroBatcher

torch.set_num_threads(1)


def _serve_args(tmp_path, front: str):
    from tests.test_data import _write_client_csvs

    root = str(tmp_path / "shards")
    _write_client_csvs(root, 3, dim=6, n_normal=40, n_abnormal=12)
    cfg_path = os.path.join(root, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(DatasetConfig.for_client_dirs(root, 3).to_json(), f)
    args = ["--device", "cpu", "--dataset-config", cfg_path,
            "--model-types", "hybrid", "--update-types", "mse_avg",
            "--network-size", "3", "--dim-features", "6", "--epochs", "1",
            "--num-rounds", "1", "--batch-size", "8",
            "--checkpoint-dir", str(tmp_path / "ckpt"),
            "--score-kind", "knn", "--knn-bank-size", "16", "--knn-k", "3",
            "--serve", "--serve-rows", "96"]
    return args + (["--serve-continuous"] if front == "continuous" else [])


@pytest.fixture
def unfrozen():
    gc.unfreeze()
    assert gc.get_freeze_count() == 0
    yield
    gc.unfreeze()


@pytest.mark.parametrize("front", ["sync", "continuous"])
def test_serve_pass_freezes_the_collector_for_its_stream(front, tmp_path,
                                                         monkeypatch,
                                                         unfrozen):
    batcher = MicroBatcher if front == "sync" else ContinuousBatcher
    seen = []
    drain = batcher.drain

    def spy(self):
        seen.append(gc.get_freeze_count())
        return drain(self)
    monkeypatch.setattr(batcher, "drain", spy)
    out = port_main(_serve_args(tmp_path, front))
    assert out["serve_smoke"]["rows"] > 0
    assert seen and seen[0] > 0  # frozen while the stream drains
    assert gc.get_freeze_count() == 0  # and unfrozen after it


@pytest.mark.parametrize("front", ["sync", "continuous"])
def test_serve_pass_unfreezes_when_its_stream_raises(front, tmp_path,
                                                     monkeypatch, unfrozen):
    batcher = MicroBatcher if front == "sync" else ContinuousBatcher

    def fail(self):
        assert gc.get_freeze_count() > 0
        raise RuntimeError("the stream failed")
    monkeypatch.setattr(batcher, "drain", fail)
    with pytest.raises(RuntimeError, match="the stream failed"):
        port_main(_serve_args(tmp_path, front))
    assert gc.get_freeze_count() == 0

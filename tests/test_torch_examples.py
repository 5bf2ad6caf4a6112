"""The port's examples (examples/*_torch.py) run to completion on the CPU
with `--device cpu`, at their own small sizes, and report what the JAX
package's examples report: a trained federation's AUC, served verdicts
that agree with the labels and a drift flag on the shifted gateway, and
flywheel swaps with no ticket dropped. real_data_federation_torch.py runs
on shards the port's shard builder wrote."""

import importlib.util
import json
import os

import numpy as np
import torch

from tests.test_data import _write_client_csvs

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_minimal_federation_runs_on_cpu(capsys):
    final = _example("minimal_federation_torch").main(["--device", "cpu"])
    assert final > 0.9
    out = capsys.readouterr().out
    assert out.count("round ") == 3 and "block of rounds" in out


def test_real_data_federation_runs_on_prepared_shards(tmp_path, capsys):
    from fedmse_tpu_torch.config import DatasetConfig
    from fedmse_tpu_torch.data.prep import create_federated_shards
    src, out = str(tmp_path / "src"), str(tmp_path / "shards")
    _write_client_csvs(src, 2, dim=12, n_normal=120, n_abnormal=40)
    create_federated_shards(src, out, n_clients=3, mode="iid", seed=0,
                            device="cpu")
    path = tmp_path / "ds.json"
    path.write_text(json.dumps(DatasetConfig.for_client_dirs(out, 3)
                               .to_json()))
    final = _example("real_data_federation_torch").main(
        [str(path), "--rounds", "2", "--epochs", "2", "--device", "cpu"])
    assert np.isfinite(final) and final > 0.9
    assert capsys.readouterr().out.count("round ") == 2


def test_serving_demo_runs_on_cpu():
    out = _example("serving_demo_torch").main(["--device", "cpu"])
    assert out["agreement"] > 0.9 and out["rows_served"] > 0
    assert out["drifted_before"] == [] and 0 in out["drifted_after"]


def test_flywheel_demo_runs_on_cpu():
    out = _example("flywheel_demo_torch").main(["--device", "cpu"])
    assert out["swaps"] >= 1
    assert out["zero_dropped"]
    assert out["rows_resolved"] == out["rows_submitted"]

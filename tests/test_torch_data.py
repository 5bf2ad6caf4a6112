"""The port's data layer (fedmse_tpu_torch/data) produces the same arrays
as the JAX package's for the same seed and batch size."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fedmse_tpu.data import stack_clients as jax_stack_clients
from fedmse_tpu.data.synthetic import synthetic_clients as jax_synthetic
from fedmse_tpu_torch.data import (IoTDataProcessor, stack_clients, stack_dims,
                                   synthetic_clients)

torch.set_num_threads(1)


@pytest.mark.parametrize("noniid", [False, True])
def test_synthetic_clients_equal_jax_copy(noniid):
    ours = synthetic_clients(n_clients=3, dim=11, n_normal=50, n_abnormal=20,
                             seed=5, noniid=noniid)
    theirs = jax_synthetic(n_clients=3, dim=11, n_normal=50, n_abnormal=20,
                           seed=5, noniid=noniid)
    for a, b in zip(ours, theirs):
        assert a.name == b.name
        for field in ("train_x", "valid_x", "test_x", "test_y"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))
        np.testing.assert_array_equal(a.dev_raw, b.dev_raw.to_numpy())
        assert isinstance(a.dev_raw, np.ndarray)
        np.testing.assert_array_equal(a.scaler.mean_, b.scaler.mean_)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("pad_to", [None, 5])
def test_stack_clients_equal_jax_copy(precision, pad_to):
    clients = synthetic_clients(n_clients=3, dim=9, n_normal=47,
                                n_abnormal=13, seed=1)
    jclients = jax_synthetic(n_clients=3, dim=9, n_normal=47, n_abnormal=13,
                             seed=1)
    dev_x = np.random.default_rng(0).normal(size=(8, 9)).astype(np.float32)
    tdt = torch.bfloat16 if precision == "bf16" else None
    jdt = jnp.bfloat16 if precision == "bf16" else None
    ours = stack_clients(clients, dev_x, 12, pad_clients_to=pad_to,
                         dtype=tdt, device="cpu")
    theirs = jax_stack_clients(jclients, dev_x, 12, pad_clients_to=pad_to,
                               dtype=jdt)
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), np.asarray(getattr(theirs, f.name))
        assert tuple(a.shape) == b.shape, f.name
        assert str(a.dtype).split(".")[-1] == str(b.dtype), f.name
        np.testing.assert_array_equal(a.float().numpy(),
                                      b.astype(np.float32), err_msg=f.name)
    d = stack_dims(clients, 12, pad_to)
    assert (d.n_pad, d.nb, d.dim) == (pad_to or 3, ours.train_xb.shape[1], 9)


def test_scaler_minmax_and_zero_variance():
    x = np.array([[1.0, 2.0], [3.0, 2.0], [5.0, 2.0]], np.float32)
    std = IoTDataProcessor("standard").fit(x)
    assert std.scale_[1] == 1.0 and std.scale_.dtype == np.float32
    mm, _ = IoTDataProcessor("minmax").fit_transform(x)
    np.testing.assert_allclose(mm[:, 0], [0.0, 0.5, 1.0])
    with pytest.raises(ValueError):
        IoTDataProcessor("robust").fit(x)


@pytest.mark.parametrize("network_size,new_device", [(5, True), (3, False)])
def test_csv_pipeline_equals_jax_copy(tmp_path, network_size, new_device):
    """load_data, prepare_clients and build_dev_dataset give the JAX
    package's arrays for the same seed: the device sample, the shuffles,
    the splits, the scalers and the dev set, with a client missing its
    abnormal shard."""
    import shutil

    from fedmse_tpu.config import DatasetConfig as JaxDataset
    from fedmse_tpu.config import ExperimentConfig as JaxConfig
    from fedmse_tpu.data import build_dev_dataset as jax_dev
    from fedmse_tpu.data import load_data as jax_load
    from fedmse_tpu.data import prepare_clients as jax_prepare
    from fedmse_tpu_torch.config import DatasetConfig, ExperimentConfig
    from fedmse_tpu_torch.data import (build_dev_dataset, load_data,
                                       prepare_clients)
    from tests.test_data import _write_client_csvs

    _write_client_csvs(str(tmp_path), 5, dim=7, n_normal=53, n_abnormal=19,
                       seed=3)
    shutil.rmtree(tmp_path / "Client-2" / "abnormal")
    np.testing.assert_array_equal(
        load_data(str(tmp_path / "Client-1" / "normal")),
        jax_load(str(tmp_path / "Client-1" / "normal")).to_numpy())
    kw = dict(dim_features=7, network_size=network_size,
              new_device=new_device)
    ours = prepare_clients(DatasetConfig.for_client_dirs(str(tmp_path), 5),
                           ExperimentConfig(**kw), np.random.default_rng(9))
    rng = np.random.default_rng(9)
    theirs = jax_prepare(JaxDataset.for_client_dirs(str(tmp_path), 5),
                         JaxConfig(**kw), rng)
    assert [c.name for c in ours] == [c.name for c in theirs]
    for a, b in zip(ours, theirs):
        for field in ("train_x", "valid_x", "test_x", "test_y"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))
        np.testing.assert_array_equal(a.dev_raw, b.dev_raw.to_numpy())
    mine = np.random.default_rng(9)
    prepare_clients(DatasetConfig.for_client_dirs(str(tmp_path), 5),
                    ExperimentConfig(**kw), mine)
    np.testing.assert_array_equal(build_dev_dataset(ours, mine),
                                  jax_dev(theirs, rng))

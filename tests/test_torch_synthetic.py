"""The port's data generators and padding (fedmse_tpu_torch/data/synthetic.py,
data/stacking.py `pad_federated_data`) against the JAX package's:

  * every generator (IID / shifted, multimodal, typed, Dirichlet with and
    without label shift, starved shards topped up) gives the JAX arrays
    bit for bit from the same seed: train, valid, test, labels, the dev
    rows (a numpy array here, a DataFrame there), names and the scaler's
    statistics;
  * `dirichlet_partition`, the numpy copy of the prep tool's partitioner,
    gives the JAX partition from the same generator state;
  * `pad_federated_data` grows a stacked federation's client axis exactly
    as stack-time padding does, and as the JAX function does.
"""

import numpy as np
import pytest
import torch

from fedmse_tpu.data import stack_clients as jax_stack
from fedmse_tpu.data import synthetic as jax_synthetic
from fedmse_tpu.data.prep import dirichlet_partition as jax_partition
from fedmse_tpu.data.stacking import pad_federated_data as jax_pad
from fedmse_tpu_torch.data import (dirichlet_partition, pad_federated_data,
                                   stack_clients, synthetic)

torch.set_num_threads(1)

GENERATORS = [
    ("synthetic_clients", dict(n_clients=3, dim=16, seed=4, noniid=True)),
    ("synthetic_multimodal_clients", dict(n_clients=4, dim=16, modes=3,
                                          seed=1)),
    ("synthetic_typed_clients", dict(n_clients=8, types=4, dim=16, seed=11)),
    ("synthetic_typed_clients", dict(n_clients=5, types=2, dim=16, modes=2,
                                     type_scale=3.0, seed=0)),
    ("synthetic_dirichlet_clients", dict(n_clients=6, dim=16, alpha=0.3,
                                         seed=2)),
    ("synthetic_dirichlet_clients", dict(n_clients=5, dim=16, alpha=0.5,
                                         label_shift=0.4, seed=5)),
    # alpha this small starves shards: the min_rows top-up draws run
    ("synthetic_dirichlet_clients", dict(n_clients=8, dim=16, alpha=0.05,
                                         rows_per_client=60, min_rows=40,
                                         seed=7)),
]


@pytest.mark.parametrize("name,kw", GENERATORS)
def test_generators_match_jax_bit_for_bit(name, kw):
    want = getattr(jax_synthetic, name)(**kw)
    got = getattr(synthetic, name)(**kw)
    assert len(got) == len(want) == kw["n_clients"]
    for a, b in zip(got, want):
        assert a.name == b.name
        for f in ("train_x", "valid_x", "test_x", "test_y"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        assert isinstance(a.dev_raw, np.ndarray)
        assert np.array_equal(a.dev_raw, b.dev_raw.to_numpy())
        assert np.array_equal(a.scaler.mean_, b.scaler.mean_)
        assert np.array_equal(a.scaler.scale_, b.scaler.scale_)


def test_typed_fleet_anomalies_are_another_types_traffic():
    """A typed gateway's anomalies are the next type's modes in its own
    frame: the standardized anomaly rows have the normal rows' spread."""
    clients = synthetic.synthetic_typed_clients(n_clients=4, types=2,
                                                dim=16, seed=3)
    for c in clients:
        normal = c.test_x[c.test_y == 0]
        anomal = c.test_x[c.test_y == 1]
        assert anomal.shape[0] == 120
        ratio = np.linalg.norm(anomal, axis=1).mean() / \
            np.linalg.norm(normal, axis=1).mean()
        assert 0.5 < ratio < 2.0  # radius-matched, not norm outliers


@pytest.mark.parametrize("prop_seed", [None, 9])
def test_dirichlet_partition_matches_jax(prop_seed):
    origins = np.random.default_rng(0).integers(0, 4, size=300)
    want = jax_partition(origins, 5, 0.5, np.random.default_rng(1),
                         prop_seed=prop_seed)
    got = dirichlet_partition(origins, 5, 0.5, np.random.default_rng(1),
                              prop_seed=prop_seed)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert sorted(np.concatenate(got).tolist()) == list(range(300))


def _stack(pad_to=None):
    clients = synthetic.synthetic_typed_clients(n_clients=4, types=2,
                                                dim=16, seed=0)
    dev_x = np.concatenate([c.dev_raw for c in clients])[:100].astype(
        np.float32)
    return clients, dev_x, stack_clients(clients, dev_x, 12,
                                         pad_clients_to=pad_to, device="cpu")


def test_pad_federated_data_is_stack_time_padding():
    clients, dev_x, data = _stack()
    padded = pad_federated_data(data, 7)
    at_stack = _stack(pad_to=7)[2]
    for name, t in vars(padded).items():
        assert torch.equal(t, getattr(at_stack, name)), name
    assert padded.client_mask.tolist() == [1, 1, 1, 1, 0, 0, 0]
    assert padded.dev_x is data.dev_x
    assert pad_federated_data(data, 4) is data
    with pytest.raises(ValueError, match="cannot shrink"):
        pad_federated_data(data, 3)
    jdata = jax_pad(jax_stack(clients, dev_x, 12), 7)
    for name, t in vars(padded).items():
        assert np.array_equal(t.numpy(), np.asarray(getattr(jdata, name))), \
            name

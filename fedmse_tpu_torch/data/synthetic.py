"""Synthetic federated IoT-like data (port of
fedmse_tpu/data/synthetic.py::synthetic_clients, numpy only).

Standardized normal traffic per client and shifted/scaled abnormal traffic,
with the reference's 40/10/40/10 train/valid/dev/test split of the normal
rows. The same seed gives the same arrays as the JAX package's copy.
"""

from __future__ import annotations

from typing import List

import numpy as np

from fedmse_tpu_torch.data.loader import ClientData, IoTDataProcessor


def synthetic_clients(n_clients: int = 4, dim: int = 16, n_normal: int = 240,
                      n_abnormal: int = 120, seed: int = 0,
                      noniid: bool = False) -> List[ClientData]:
    """Per-client ClientData with the reference's 40/10/40/10 discipline."""
    rng = np.random.default_rng(seed)
    clients = []
    for i in range(n_clients):
        shift = rng.normal(0, 2.0, size=dim) if noniid else np.zeros(dim)
        normal = rng.normal(0, 1.0, size=(n_normal, dim)) + shift
        abnormal = rng.normal(4.0, 2.0, size=(n_abnormal, dim)) + shift

        n_train = int(0.4 * n_normal)
        n_valid = int(0.1 * n_normal)
        n_dev = int(0.4 * n_normal)
        train, valid = normal[:n_train], normal[n_train:n_train + n_valid]
        dev = normal[n_train + n_valid:n_train + n_valid + n_dev]
        test = normal[n_train + n_valid + n_dev:]

        proc = IoTDataProcessor(scaler="standard")
        train_x, _ = proc.fit_transform(train)
        valid_x, _ = proc.transform(valid)
        test_x, test_y = proc.transform(test)
        ab_x, ab_y = proc.transform(abnormal, type="abnormal")

        clients.append(ClientData(
            name=f"synthetic-{i + 1}",
            train_x=train_x.astype(np.float32),
            valid_x=valid_x.astype(np.float32),
            test_x=np.concatenate([test_x, ab_x]).astype(np.float32),
            test_y=np.concatenate([test_y, ab_y]).astype(np.float32),
            dev_raw=dev,
            scaler=proc,
        ))
    return clients

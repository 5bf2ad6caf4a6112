"""CSV shards -> per-client split and scaled arrays (port of
fedmse_tpu/data/loader.py, numpy only: the card's machine has no pandas).

  * `load_data`         concatenates every *.csv of a directory, headerless,
                        parsed to float64 by the port's host reader
                        (data/fast_csv.py, correctly rounded: the values
                        pandas' round-trip parser and the JAX package's
                        native reader give) and cast to float32;
  * `IoTDataProcessor`  a numpy StandardScaler/MinMaxScaler with sklearn's
                        semantics (biased std, zero variance -> scale 1.0;
                        minmax to (0, 1)) that keeps the input dtype while
                        accumulating the statistics in float64;
  * `prepare_clients`   the reference's per-device pipeline: shuffle, the
                        40/10/40/10 normal split, the scaler fit on train
                        only, abnormal rows all to test, and the optional
                        new-device normals appended to test;
  * `build_dev_dataset` equal-size samples of every client's dev split,
                        re-standardized with a fresh scaler.

The `data_rng` draws are the JAX package's, call for call, so the same seed
gives the same arrays. `ClientData.dev_raw` is a plain np.ndarray here.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from fedmse_tpu_torch.config import DatasetConfig, ExperimentConfig
from fedmse_tpu_torch.data.fast_csv import csv_files, read_dir_f64

logger = logging.getLogger(__name__)


def load_data(path: str, dtype: Optional[np.dtype] = np.float32
              ) -> np.ndarray:
    """Concatenate every headerless CSV file in `path` into one [rows, F]
    array: parsed as float64 by the host reader (a header line, a
    malformed field or a ragged row raises RuntimeError), then cast to
    `dtype` (None keeps float64)."""
    out = read_dir_f64(path, allow_header=False)
    return out if dtype is None else out.astype(dtype)


class IoTDataProcessor:
    """Scaler wrapper with label attachment (normal=0 / abnormal=1)."""

    def __init__(self, scaler: str = "standard"):
        self.kind = scaler
        self.mean_: Optional[np.ndarray] = None
        self.scale_: Optional[np.ndarray] = None
        self.min_: Optional[np.ndarray] = None

    def fit(self, data: np.ndarray) -> "IoTDataProcessor":
        data = np.asarray(data)
        if self.kind == "standard":
            self.mean_ = data.mean(axis=0, dtype=np.float64).astype(data.dtype)
            scale = data.std(axis=0, dtype=np.float64).astype(data.dtype)
            self.scale_ = np.where(scale == 0.0,
                                   np.asarray(1.0, data.dtype), scale)
        elif self.kind == "minmax":
            dmin, dmax = data.min(axis=0), data.max(axis=0)
            rng = np.where(dmax - dmin == 0.0,
                           np.asarray(1.0, data.dtype), dmax - dmin)
            self.scale_ = (np.asarray(1.0, data.dtype) / rng).astype(data.dtype)
            self.min_ = dmin
        else:
            raise ValueError(f"unknown scaler {self.kind!r}")
        return self

    def _apply(self, data: np.ndarray) -> np.ndarray:
        data = np.asarray(data)
        # f32 standardization can overflow to inf on a near-zero-variance
        # train feature; the evaluator's nan_to_num guard absorbs it
        with np.errstate(over="ignore"):
            if self.kind == "standard":
                return (data - self.mean_) / self.scale_
            return (data - self.min_) * self.scale_

    def transform(self, data, type: str = "normal"
                  ) -> Tuple[np.ndarray, np.ndarray]:
        processed = self._apply(np.asarray(data))
        label = (np.zeros(len(processed), dtype=np.float32)
                 if type == "normal"
                 else np.ones(len(processed), dtype=np.float32))
        return processed, label

    def fit_transform(self, data) -> Tuple[np.ndarray, np.ndarray]:
        self.fit(np.asarray(data))
        return self.transform(data, type="normal")


@dataclasses.dataclass
class ClientData:
    """One client's prepared (unpadded) arrays: float32, standardized."""

    name: str
    train_x: np.ndarray  # [n_train, D] normal, scaled
    valid_x: np.ndarray  # [n_valid, D]
    test_x: np.ndarray   # [n_test, D] normal test + abnormal
    test_y: np.ndarray   # [n_test] 0 = normal, 1 = abnormal
    dev_raw: Optional[np.ndarray]  # unscaled dev split rows
    scaler: Optional[IoTDataProcessor]


def _split_sizes(n: int, fractions: Sequence[float]
                 ) -> Tuple[int, int, int, int]:
    """Train/valid/dev sizes from the fractions; test gets the rest."""
    train = int(fractions[0] * n)
    valid = int(fractions[1] * n)
    dev = int(fractions[2] * n)
    return train, valid, dev, n - train - valid - dev


def _cast32(x: np.ndarray, device: str, what: str) -> np.ndarray:
    """float32, with a warning for values standardization overflowed (a
    near-zero-variance train feature); the evaluator's nan_to_num guard
    absorbs them."""
    with np.errstate(over="ignore"):
        x32 = x.astype(np.float32)
    n_nonfinite = int((~np.isfinite(x32)).sum())
    if n_nonfinite:
        logger.warning("%s: %d non-finite standardized %s values (float32 "
                       "overflow; near-zero train variance feature)",
                       device, n_nonfinite, what)
    return x32


def prepare_clients(dataset: DatasetConfig, cfg: ExperimentConfig,
                    data_rng: np.random.Generator,
                    network_size: Optional[int] = None) -> List[ClientData]:
    """The reference's per-device pipeline; `data_rng` draws the device
    sample and the row shuffles."""
    n_net = network_size or cfg.network_size
    devices = list(dataset.devices_list)
    if len(devices) > n_net:
        idx = data_rng.choice(len(devices), size=n_net, replace=False)
        devices = [devices[i] for i in idx]

    def shard(rel_path: str) -> str:
        return os.path.join(dataset.data_path, rel_path)

    clients: List[ClientData] = []
    for device in devices:
        # a gateway with no normal traffic cannot train a normal profile
        if not csv_files(shard(device.normal_data_path)):
            logger.warning("%s: no normal shard under %s; skipping device",
                           device.name, device.normal_data_path)
            continue
        normal = load_data(shard(device.normal_data_path))
        normal = normal[data_rng.permutation(len(normal))]
        # a label-skewed shard may have no abnormal traffic at all: 0 rows
        if csv_files(shard(device.abnormal_data_path)):
            abnormal = load_data(shard(device.abnormal_data_path))
            abnormal = abnormal[data_rng.permutation(len(abnormal))]
        else:
            abnormal = normal[:0]
            logger.warning("%s: no abnormal shard at %s (0 abnormal rows)",
                           device.name, device.abnormal_data_path)

        n_train, n_valid, n_dev, _ = _split_sizes(len(normal),
                                                  cfg.split_fractions)
        train = normal[:n_train]
        valid = normal[n_train:n_train + n_valid]
        dev = normal[n_train + n_valid:n_train + n_valid + n_dev]
        test = normal[n_train + n_valid + n_dev:]

        proc = IoTDataProcessor(scaler=cfg.scaler)
        train_x, _ = proc.fit_transform(train)
        valid_x, _ = proc.transform(valid)
        test_x, test_y = proc.transform(test)
        abnormal_x, abnormal_y = proc.transform(abnormal, type="abnormal")
        if cfg.new_device:
            if csv_files(shard(device.test_normal_data_path)):
                new_x, new_y = proc.transform(
                    load_data(shard(device.test_normal_data_path)))
                test_x = np.concatenate([test_x, new_x], axis=0)
                test_y = np.concatenate([test_y, new_y], axis=0)
            else:
                logger.warning("%s: no test_normal shard at %s (new-device "
                               "normals absent from the test set)",
                               device.name, device.test_normal_data_path)
        test_x = np.concatenate([test_x, abnormal_x], axis=0)
        test_y = np.concatenate([test_y, abnormal_y], axis=0)

        clients.append(ClientData(
            name=device.name,
            train_x=_cast32(train_x, device.name, "train"),
            valid_x=_cast32(valid_x, device.name, "valid"),
            test_x=_cast32(test_x, device.name, "test"),
            test_y=test_y.astype(np.float32),
            dev_raw=dev, scaler=proc))
        logger.info("%s: %d train / %d valid / %d test rows", device.name,
                    len(train_x), len(valid_x), len(test_x))
    if not clients:
        raise FileNotFoundError(
            f"no usable devices under {dataset.data_path!r}: every "
            "configured client is missing its normal-traffic shard")
    return clients


def build_dev_dataset(clients: Sequence[ClientData],
                      data_rng: np.random.Generator,
                      scaler: str = "standard") -> np.ndarray:
    """The shared dev set: min_len rows sampled from each client's dev
    split, concatenated, standardized by a fresh scaler."""
    min_len = min(len(c.dev_raw) for c in clients)
    parts = [c.dev_raw[data_rng.choice(len(c.dev_raw), size=min_len,
                                       replace=False)] for c in clients]
    dev_x, _ = IoTDataProcessor(scaler=scaler).fit_transform(
        np.concatenate(parts, axis=0))
    return dev_x.astype(np.float32)

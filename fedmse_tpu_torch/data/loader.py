"""Per-client arrays and the scaler (port of the numpy half of
fedmse_tpu/data/loader.py).

`IoTDataProcessor` is a numpy StandardScaler/MinMaxScaler with sklearn's
semantics (biased std, zero variance -> scale 1.0; minmax to (0, 1)) that
keeps the input dtype while accumulating the statistics in float64.
`ClientData` holds one client's prepared arrays; its unscaled dev split is
a plain np.ndarray here (the JAX package keeps a pandas DataFrame, and the
card's machine has no pandas). CSV loading (`load_data`,
`prepare_clients`, `build_dev_dataset`) waits for the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


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

"""Score -> verdict calibration: per-gateway percentile thresholds (a
numpy-only copy of fedmse_tpu/serving/calibration.py).

The paper's detector semantics: a gateway flags a row as anomalous when
its score exceeds a threshold fit on that gateway's own *normal*
validation traffic (the reference's centroid classifier uses the median
of training distances, Centroid.py:15-25; production detectors run a
high percentile for a controlled false-positive rate — the percentile is
the knob here, default 95).

The calibration also records the validation score distribution (mean /
std / count) per gateway — the reference distribution the drift monitor
compares live traffic against (serving/drift.py) — and persists as
JSON alongside the checkpoint tree it was fit from
(`ResultsWriter.serving_dir`), so a serving process can load params +
thresholds from disk with no training-side state.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np


def refit_row(scores, percentile: float):
    """(threshold, mean, std, count) of one gateway's fresh normal
    scores — the one home of the refit formula, which
    `ServingCalibration.refit` and the later flywheel port share."""
    scores = np.asarray(scores, np.float64)
    if scores.size == 0:
        raise ValueError("refit needs at least one normal score")
    return (float(np.percentile(scores, percentile)),
            float(np.mean(scores)), float(np.std(scores)),
            int(scores.size))


@dataclasses.dataclass
class ServingCalibration:
    """Fitted per-gateway detector state (numpy, host-side)."""

    percentile: float
    thresholds: np.ndarray  # [N] score threshold per gateway
    mean: np.ndarray        # [N] validation-normal score mean
    std: np.ndarray         # [N] validation-normal score std (ddof=0)
    count: np.ndarray       # [N] validation rows the fit saw
    model_type: str = ""

    @property
    def num_gateways(self) -> int:
        return len(self.thresholds)

    def verdicts(self, scores, gateway_ids=None) -> np.ndarray:
        """Boolean anomaly verdicts: score > threshold[gateway]."""
        scores = np.asarray(scores)
        if gateway_ids is None:
            gw = np.zeros(scores.shape[0], np.int32)
        else:
            gw = np.broadcast_to(np.asarray(gateway_ids, np.int32),
                                 scores.shape)
        return scores > self.thresholds[gw]

    def refit(self, gateway: int, scores,
              percentile: Optional[float] = None) -> "ServingCalibration":
        """A COPY with one gateway's threshold/mean/std/count refit on
        fresh normal scores — the drift-triggered threshold hot-swap
        payload: when a drift monitor recommends a swap, score a batch of
        known-normal rows for the flagged gateway and install the refit copy; every other
        gateway's calibration is untouched. The copy leaves `self` alone
        so batches already dispatched keep their snapshot."""
        pct = self.percentile if percentile is None else percentile
        thresholds = self.thresholds.copy()
        mean, std = self.mean.copy(), self.std.copy()
        count = self.count.copy()
        (thresholds[gateway], mean[gateway], std[gateway],
         count[gateway]) = refit_row(scores, pct)
        return ServingCalibration(percentile=self.percentile,
                                  thresholds=thresholds, mean=mean, std=std,
                                  count=count, model_type=self.model_type)

    # ---------------------------- persistence ---------------------------- #

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump({
                "percentile": self.percentile,
                "model_type": self.model_type,
                # inf (a gateway with no validation rows) is not strict
                # JSON; round-trip it as null
                "thresholds": [None if not np.isfinite(t) else float(t)
                               for t in self.thresholds],
                "mean": [float(m) for m in self.mean],
                "std": [float(s) for s in self.std],
                "count": [int(c) for c in self.count],
            }, f, indent=1)
        return path

    @staticmethod
    def load(path: str) -> "ServingCalibration":
        with open(path) as f:
            raw = json.load(f)
        return ServingCalibration(
            percentile=float(raw["percentile"]),
            thresholds=np.asarray(
                [np.inf if t is None else t for t in raw["thresholds"]],
                np.float64),
            mean=np.asarray(raw["mean"], np.float64),
            std=np.asarray(raw["std"], np.float64),
            count=np.asarray(raw["count"], np.int64),
            model_type=str(raw.get("model_type", "")),
        )


def fit_calibration(engine, valid_x, valid_m=None,
                    percentile: float = 95.0) -> ServingCalibration:
    """Fit per-gateway thresholds on validation normals.

    `valid_x` [N, V, D] (+ optional row mask `valid_m` [N, V]) is the
    stacked validation split the training side already holds
    (FederatedData.valid_x / valid_m). Scores come through the serving
    engine itself, so calibration sees exactly the deployed score path.
    A gateway with zero valid rows gets threshold +inf (never flags) and
    count 0 — the drift monitor treats it as uncalibrated.
    """
    valid_x = np.asarray(valid_x, np.float32)
    n = valid_x.shape[0]
    thresholds = np.full(n, np.inf)
    mean = np.zeros(n)
    std = np.zeros(n)
    count = np.zeros(n, np.int64)
    for g in range(n):
        rows = valid_x[g]
        if valid_m is not None:
            rows = rows[np.asarray(valid_m[g]) > 0]
        if len(rows) == 0:
            continue
        scores = engine.score(rows, np.full(len(rows), g, np.int32))
        thresholds[g] = float(np.percentile(scores, percentile))
        mean[g] = float(np.mean(scores))
        std[g] = float(np.std(scores))
        count[g] = len(rows)
    return ServingCalibration(percentile=percentile, thresholds=thresholds,
                              mean=mean, std=std, count=count,
                              model_type=engine.model_type)

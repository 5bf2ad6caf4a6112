"""Streaming drift detection over served scores, per gateway (a numpy-only
copy of fedmse_tpu/serving/drift.py).

The reference handles distribution change only at training time (a new
device joins -> retrain the federation). A deployed detector needs the
inverse signal: notice *while serving* that a gateway's live score
distribution has departed the calibration distribution — traffic
shifted, a device was replaced, or the model went stale — and flag it
for recalibration/retraining.

`DriftMonitor` keeps a Welford running mean/variance per gateway
(numerically stable one-pass; batches merge via Chan's parallel update,
so a 1024-row dispatch is one O(gateways) update, not 1024 scalar ones)
and compares the live mean against the calibration mean in calibration-
std units.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from fedmse_tpu_torch.serving.calibration import ServingCalibration


class DriftMonitor:
    """Welford/Chan streaming moments per gateway vs the calibration.

    A gateway drifts when it has seen at least `min_count` live rows and
    |live_mean - calib_mean| > z_threshold * calib_std — a mean shift of
    z_threshold calibration standard deviations. Gateways the calibration
    never saw (count 0) are reported as uncalibrated, never drifted.

    A drifted gateway becomes `swap_recommended` once the drifted state
    has been SUSTAINED for `min_batches` consecutive `update()` calls
    that carried its traffic — the hot-swap trigger the continuous front
    acts on (serving/continuous.py swap), debounced so one anomalous
    burst does not churn checkpoints. The field is computed entirely
    here, so the trigger is testable without an engine in the loop.

    `cooldown_updates` is the post-swap hysteresis (the flywheel's
    anti-thrash guard, fedmse_tpu/flywheel/, but useful standalone):
    after a `rebaseline`, `swap_recommended` stays suppressed for that
    many further `update()` calls carrying each gateway's traffic, so a
    swap that lands while the live distribution is still settling (or a
    marginally-wrong recalibration) cannot immediately re-trigger the
    swap it just performed. Drift DETECTION (`drifted`, `shift`) is not
    suppressed — only the recommendation — so telemetry keeps seeing the
    truth during the cooldown.
    """

    def __init__(self, calibration: ServingCalibration,
                 z_threshold: float = 3.0, min_count: int = 30,
                 min_batches: int = 3, cooldown_updates: int = 0):
        self.calibration = calibration
        self.z_threshold = z_threshold
        self.min_count = min_count
        self.min_batches = min_batches
        self.cooldown_updates = cooldown_updates
        n = calibration.num_gateways
        self.count = np.zeros(n, np.int64)
        self.mean = np.zeros(n)
        self._m2 = np.zeros(n)  # sum of squared deviations from the mean
        # consecutive drifted updates (per gateway, counting only updates
        # that carried that gateway's rows)
        self._streak = np.zeros(n, np.int64)
        # post-rebaseline hysteresis: >= 0 means the gateway is inside
        # its cooldown (decremented only by updates carrying its
        # traffic, floored at -1; -1 = cooldown over / never armed, so a
        # freshly built monitor is NOT suppressed)
        self._cooldown = np.full(n, -1, np.int64)
        # update()-call counter + the count at the last rebaseline (None
        # until one happens) — report() surfaces both so an operator can
        # see how fresh the current baseline is
        self.updates = 0
        self.last_rebaseline = None

    def update(self, scores, gateway_ids=None) -> None:
        """Absorb one served batch of scores (+ per-row gateway ids)."""
        scores = np.asarray(scores, np.float64)
        if gateway_ids is None:
            gw = np.zeros(scores.shape[0], np.int32)
        else:
            gw = np.broadcast_to(np.asarray(gateway_ids, np.int32),
                                 scores.shape)
        present = np.unique(gw)
        for g in present:
            xs = scores[gw == g]
            nb = len(xs)
            mb = float(np.mean(xs))
            m2b = float(np.sum((xs - mb) ** 2))
            na, ma = int(self.count[g]), float(self.mean[g])
            delta = mb - ma
            n = na + nb
            # Chan et al. parallel combine of (count, mean, M2) pairs
            self.mean[g] = ma + delta * nb / n
            self._m2[g] += m2b + delta * delta * na * nb / n
            self.count[g] = n
        # sustain accounting: a gateway that saw traffic this update either
        # extends its drifted streak or resets it; quiet gateways keep
        # theirs (no evidence either way)
        drifted = self.drifted()
        self._streak[present] = np.where(drifted[present],
                                         self._streak[present] + 1, 0)
        # cooldown ticks on the same evidence basis as the streak: only
        # updates carrying a gateway's traffic count it down. Armed at
        # cooldown_updates by rebaseline(), it stays >= 0 — suppressing
        # the recommendation — for exactly cooldown_updates such updates
        self._cooldown[present] = np.maximum(self._cooldown[present] - 1, -1)
        self.updates += 1

    def live_std(self) -> np.ndarray:
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.sqrt(np.where(self.count > 0,
                                    self._m2 / np.maximum(self.count, 1),
                                    0.0))

    def shift(self) -> np.ndarray:
        """Per-gateway mean shift in calibration-std units (0 where the
        calibration std is 0 and the means agree; inf where it is 0 and
        they do not)."""
        cal = self.calibration
        diff = np.abs(self.mean - cal.mean)
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            z = np.where(cal.std > 0, diff / np.maximum(cal.std, 1e-300),
                         np.where(diff > 0, np.inf, 0.0))
        return z

    def drifted(self) -> np.ndarray:
        """[N] bool: calibrated gateways whose live mean left the band."""
        z = self.shift()
        return ((self.count >= self.min_count)
                & (self.calibration.count > 0)
                & (z > self.z_threshold))

    def swap_recommended(self) -> np.ndarray:
        """[N] bool: drifted AND sustained for min_batches updates AND out
        of the post-rebaseline cooldown — the debounced hot-swap trigger
        (recalibrate / refresh bank / pull a newer checkpoint,
        serving/continuous.py swap; the flywheel controller's input)."""
        return (self.drifted() & (self._streak >= self.min_batches)
                & (self._cooldown < 0))

    def rebaseline(self, calibration: ServingCalibration,
                   reset: bool = True) -> None:
        """Swap in a recalibrated reference distribution (the threshold
        hot-swap path). `reset=True` restarts the live moments and
        streaks — the old traffic was measured against the old baseline,
        so carrying it over would immediately re-flag the gateway the
        swap just fixed."""
        if calibration.num_gateways != self.calibration.num_gateways:
            raise ValueError(
                f"rebaseline calibration covers "
                f"{calibration.num_gateways} gateways, monitor tracks "
                f"{self.calibration.num_gateways}")
        self.calibration = calibration
        self.last_rebaseline = self.updates
        # arm the anti-thrash hysteresis: no swap recommendation for the
        # next cooldown_updates updates per gateway (class docstring);
        # 0 = feature off, nothing armed
        self._cooldown[:] = (self.cooldown_updates
                             if self.cooldown_updates > 0 else -1)
        if reset:
            self.count[:] = 0
            self.mean[:] = 0.0
            self._m2[:] = 0.0
            self._streak[:] = 0

    def report(self) -> Dict:
        """JSON-safe summary (per-gateway rows + the flagged lists)."""
        z = self.shift()
        drifted = self.drifted()
        recommended = self.swap_recommended()
        live_std = self.live_std()
        cal = self.calibration
        gateways: List[Dict] = []
        for g in range(cal.num_gateways):
            gateways.append({
                "gateway": g,
                "live_count": int(self.count[g]),
                "live_mean": float(self.mean[g]),
                "live_std": float(live_std[g]),
                "calib_mean": float(cal.mean[g]),
                "calib_std": float(cal.std[g]),
                "shift_sigmas": (None if not np.isfinite(z[g])
                                 else float(z[g])),
                "calibrated": bool(cal.count[g] > 0),
                "drifted": bool(drifted[g]),
                "drift_streak": int(self._streak[g]),
                "cooldown_remaining": int(max(self._cooldown[g], 0)),
                "swap_recommended": bool(recommended[g]),
            })
        return {
            "z_threshold": self.z_threshold,
            "min_count": self.min_count,
            "min_batches": self.min_batches,
            "cooldown_updates": self.cooldown_updates,
            "updates": self.updates,
            "last_rebaseline": self.last_rebaseline,
            "drifted_gateways": [int(g) for g in np.nonzero(drifted)[0]],
            "swap_recommended_gateways": [int(g) for g in
                                          np.nonzero(recommended)[0]],
            "gateways": gateways,
        }

"""Flywheel self-poisoning traffic: the slow-drift auto-retrain trap (a
numpy-only copy of fedmse_tpu/redteam/traffic.py; its draws are the JAX
package's bit for bit).

The flywheel (flywheel/) fine-tunes the deployed detector from its OWN
serving stream: rows the detector verdicts normal enter per-gateway
reservoirs, and a sustained drift quorum fires a fine-tune and a hot swap.
That loop is the attack surface: an adversary who controls a gateway's
traffic walks its rows from the honest regime toward an attack regime
SLOWLY, keeping each batch under the deployed threshold, so the verdicts
stay "normal", the reservoirs fill with its rows, and each fine-tune moves
the model a little further toward scoring the attack regime as normal.

`SlowDriftAdversary` adapts on the only feedback a real attacker sees, the
verdicts on its own rows: it advances while they stay normal and retreats
when the detector pushes back. The defenses measured against it live in
flywheel/buffer.py: the verdict-margin floor (admit only rows scoring
well below threshold) and the per-gateway influence cap.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class SlowDriftAdversary:
    """Adaptive drift-walk generator for one (or a few) captive gateways.

    `position` in [0, 1] is where the current batch sits on the
    honest(`start_mu`) → attack(`target_mu`) line. After each served
    batch, call `observe(normal_frac)` with the fraction of its rows the
    deployed detector verdicted normal: positions advance by `step` while
    acceptance holds above `min_normal_frac`, and RETREAT by a half-step
    when the detector pushes back (the binary-search-like probing a real
    adversary runs against an accept/reject oracle)."""

    def __init__(self, start_mu: np.ndarray, target_mu: np.ndarray,
                 seed: int = 0, spread: float = 0.05, step: float = 0.08,
                 min_normal_frac: float = 0.9,
                 max_position: float = 1.0):
        self.start_mu = np.asarray(start_mu, np.float32)
        self.target_mu = np.asarray(target_mu, np.float32)
        if self.start_mu.shape != self.target_mu.shape:
            raise ValueError("start_mu and target_mu must share a shape, "
                             f"got {self.start_mu.shape} vs "
                             f"{self.target_mu.shape}")
        if not 0 < step <= 1:
            raise ValueError(f"step must be in (0, 1], got {step}")
        self.rng = np.random.default_rng(seed)
        self.spread = float(spread)
        self.step = float(step)
        self.min_normal_frac = float(min_normal_frac)
        self.max_position = float(max_position)
        self.position = 0.0

    def mu(self) -> np.ndarray:
        """Current batch center on the honest→target line."""
        return ((1.0 - self.position) * self.start_mu
                + self.position * self.target_mu)

    def next_batch(self, n_rows: int) -> np.ndarray:
        """[n_rows, D] f32 rows at the current position, tight spread —
        the attacker wants low variance so no row strays over threshold."""
        d = self.start_mu.shape[0]
        rows = self.mu()[None, :] + self.spread * self.rng.standard_normal(
            (n_rows, d))
        return rows.astype(np.float32)

    def observe(self, normal_frac: float) -> None:
        """Feed back the detector's response to the last batch and adapt."""
        if normal_frac >= self.min_normal_frac:
            self.position = min(self.max_position,
                                self.position + self.step)
        else:
            self.position = max(0.0, self.position - 0.5 * self.step)

    def target_rows(self, n_rows: int,
                    seed: Optional[int] = None) -> np.ndarray:
        """[n_rows, D] rows AT the attack regime (position 1.0) — the
        probe set the sweep scores to measure whether the detector has
        gone blind there (attack success = these verdict normal)."""
        rng = self.rng if seed is None else np.random.default_rng(seed)
        d = self.start_mu.shape[0]
        rows = self.target_mu[None, :] + self.spread * rng.standard_normal(
            (n_rows, d))
        return rows.astype(np.float32)


def normal_fraction(verdicts: np.ndarray) -> float:
    """Fraction of a batch verdicted normal (verdict False = normal —
    the ServingCalibration boolean convention). The attacker's only
    feedback signal and the sweep's blindness metric."""
    v = np.asarray(verdicts)
    if v.size == 0:
        return 0.0
    return float((v == 0).mean())

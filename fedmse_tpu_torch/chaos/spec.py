"""The failure scenario of a chaotic run (port of
fedmse_tpu/chaos/spec.py).

  * dropout_p        per-client per-round: the client never trains (churn);
  * straggler_p      per-client per-round: it trains, but its update
                     arrives after the round's deadline;
  * crash_p          per-round: the ELECTED aggregator dies after winning,
                     and the surviving quota-eligible cohort re-elects on
                     the device (federation/fused.py);
  * broadcast_loss_p per-client: the client misses the aggregated
                     broadcast and keeps its local state across the merge.

`start_round` / `stop_round` bound the chaos window [start, stop). The
draws come from the run's chaos stream (utils/seeding.py), so enabling
chaos moves no other draw, and a zero-probability spec is bit-identical to
a chaos-free schedule.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

_PROB_FIELDS = ("dropout_p", "straggler_p", "crash_p", "broadcast_loss_p")


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """Failure probabilities and the active window."""

    dropout_p: float = 0.0
    straggler_p: float = 0.0
    crash_p: float = 0.0
    broadcast_loss_p: float = 0.0
    start_round: int = 0
    stop_round: Optional[int] = None

    def __post_init__(self):
        for name in _PROB_FIELDS:
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        if self.start_round < 0:
            raise ValueError(
                f"start_round must be >= 0, got {self.start_round}")
        if self.stop_round is not None and self.stop_round <= self.start_round:
            raise ValueError(
                f"stop_round ({self.stop_round}) must be > start_round "
                f"({self.start_round}); the window [start, stop) is else "
                f"empty and the spec is a silent no-op")

    @property
    def is_null(self) -> bool:
        """True when every failure probability is zero."""
        return all(getattr(self, name) == 0.0 for name in _PROB_FIELDS)

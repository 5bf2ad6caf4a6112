"""A malicious aggregator: the merged model tampered with between
aggregation and broadcast, to exercise the verification defense (port of
fedmse_tpu/federation/attack.py).

Attacks:
  * scale      every parameter times `strength`;
  * noise      plus strength x N(0, 1) per parameter;
  * sign_flip  -strength x the parameters;
  * zero       an all-zero model.

The attacked rounds are start_round, start_round + every_k, ... up to
(exclusive) stop_round. Whether a round is attacked is decided on the host
per absolute round (`attack_active`) and reaches the fused round as a
device bit, so a captured round holds no round number. The noise is drawn
on the host from the run's attack stream (utils/seeding.py), one [P] row
per absolute round (`noise_draws`), for a chunk ahead: the fused and the
per-phase paths poison with the same numbers. jax.random's normals cannot
be reproduced here; parity tests feed the JAX package's draw.

Use: `RoundEngine(..., poison_fn=make_poison_fn(spec))`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from fedmse_tpu_torch.utils.seeding import StreamKey, stream_rng

ATTACK_KINDS = ("scale", "noise", "sign_flip", "zero")


@dataclasses.dataclass(frozen=True)
class AttackSpec:
    """Kind, strength and schedule: rounds start_round, start_round +
    every_k, ... before stop_round (None: to the end)."""

    kind: str = "scale"
    strength: float = 10.0
    every_k: int = 1
    start_round: int = 0
    stop_round: Optional[int] = None

    def __post_init__(self):
        if self.kind not in ATTACK_KINDS:
            raise ValueError(f"unknown attack kind {self.kind!r}; "
                             f"one of {ATTACK_KINDS}")
        if self.every_k < 1:
            raise ValueError(f"every_k must be >= 1, got {self.every_k}")
        if self.stop_round is not None and self.stop_round <= self.start_round:
            raise ValueError(
                f"stop_round ({self.stop_round}) must be > start_round "
                f"({self.start_round})")


def attack_active(spec: AttackSpec, round_index: int) -> bool:
    """Whether absolute round `round_index` is attacked."""
    active = (round_index >= spec.start_round
              and (round_index - spec.start_round) % spec.every_k == 0)
    if spec.stop_round is not None:
        active = active and round_index < spec.stop_round
    return active


def poison_params(merged: torch.Tensor, spec: AttackSpec,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The attack applied to flat params [..., P]; `noise` (standard
    normals of the same shape) for kind 'noise'."""
    if spec.kind == "scale":
        return merged * spec.strength
    if spec.kind == "sign_flip":
        return -spec.strength * merged
    if spec.kind == "zero":
        return torch.zeros_like(merged)
    if noise is None:
        raise ValueError("a noise attack needs its draws")
    return merged + spec.strength * noise


def noise_draws(key: StreamKey, start_round: int, n_rounds: int,
                width: int) -> np.ndarray:
    """[n_rounds, width] f32 standard normals, row r from round
    start_round + r alone."""
    out = np.empty((n_rounds, width), np.float32)
    for r in range(n_rounds):
        out[r] = stream_rng(key, start_round + r).standard_normal(
            width, dtype=np.float32)
    return out


class PoisonFn:
    """poison_fn(merged [P], active, noise=None) -> merged: the attack where
    the device value `active` is > 0, the merged model elsewhere (a select,
    no host read)."""

    def __init__(self, spec: AttackSpec):
        self.spec = spec

    @property
    def needs_noise(self) -> bool:
        return self.spec.kind == "noise"

    def active(self, start_round: int, n_rounds: int) -> np.ndarray:
        """[n_rounds] f32: 1 where the round is attacked."""
        return np.asarray([attack_active(self.spec, start_round + r)
                           for r in range(n_rounds)], np.float32)

    def __call__(self, merged: torch.Tensor, active: torch.Tensor,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return torch.where(active > 0,
                           poison_params(merged, self.spec, noise), merged)


def make_poison_fn(spec: AttackSpec) -> PoisonFn:
    """The RoundEngine's poison_fn for `spec`."""
    return PoisonFn(spec)

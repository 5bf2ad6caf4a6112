"""RedteamSpec: an adaptive adversary coalition, its poison schedule and the
defense knobs measured against it (port of fedmse_tpu/redteam/spec.py).

Two attacks, both aimed where the federation decides:

  * ``cluster_poison``: a coalition of gateway slots whose latent
    statistics place it in a victim cluster (redteam/mimicry.py) poisons
    from inside: its own submitted updates every scheduled round (the
    update stage) and, when one of its members wins the election, the
    merge it coordinates (the merge stage), scoped to the victim cluster's
    row when ``victim_cluster`` names one;
  * ``sybil``: the coalition arrives through elastic joins, votes for its
    own members (``lie_votes``) and captures the aggregation quorum.

The defense knob ``min_tenure``: a recycled tenant (generation > 0) may
neither vote nor be elected until it has held its slot for that many
consecutive rounds. Founding tenants are never gated.

Validation is eager: every bad value raises at construction. A null spec
(``is_null``) builds nothing into the fused round, so its rounds are the
rounds of an engine built with no spec.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

REDTEAM_KINDS = ("none", "cluster_poison", "sybil")
POISON_KINDS = ("scale", "sign_flip", "noise")


@dataclasses.dataclass(frozen=True)
class RedteamSpec:
    """Adversary coalition + poison schedule + defense knobs.

    The coalition is either the explicit ``adversaries`` tuple of ABSOLUTE
    slot ids or a per-slot bernoulli(``adversary_frac``) draw keyed on the
    absolute slot id, so padding the client axis cannot move it. Poison
    fires on rounds ``start_round, start_round + every_k, ...`` up to
    (exclusive) ``stop_round``.

    ``victim_cluster`` scopes the merge-stage poison to one cluster's row
    of the [K, ...] cluster merges (None: the whole merge).
    ``mimic_blend`` is the moment-blend weight the host-side mimicry
    helper uses to steer the coalition's latent statistics toward the
    victim's (1.0 = perfect mimicry)."""

    kind: str = "none"
    adversaries: Optional[Tuple[int, ...]] = None
    adversary_frac: float = 0.0
    victim_cluster: Optional[int] = None
    poison: str = "scale"
    strength: float = 10.0
    every_k: int = 1
    start_round: int = 0
    stop_round: Optional[int] = None
    lie_votes: bool = False
    mimic_blend: float = 0.0
    # --- defense knobs ---
    min_tenure: int = 0

    def __post_init__(self):
        if self.kind not in REDTEAM_KINDS:
            raise ValueError(f"unknown redteam kind {self.kind!r}; "
                             f"one of {REDTEAM_KINDS}")
        if self.poison not in POISON_KINDS:
            raise ValueError(f"unknown poison kind {self.poison!r}; "
                             f"one of {POISON_KINDS}")
        if not 0.0 <= self.adversary_frac <= 1.0:
            raise ValueError("adversary_frac must be in [0, 1], got "
                             f"{self.adversary_frac}")
        if self.adversaries is not None:
            if len(self.adversaries) == 0:
                raise ValueError("adversaries, when given, must be a "
                                 "non-empty tuple of absolute slot ids")
            if any(a < 0 for a in self.adversaries):
                raise ValueError(f"adversary slot ids must be >= 0, got "
                                 f"{self.adversaries}")
            if len(set(self.adversaries)) != len(self.adversaries):
                raise ValueError(f"duplicate adversary slot ids: "
                                 f"{self.adversaries}")
        if self.kind != "none" and self.adversaries is None \
                and self.adversary_frac == 0.0:
            # an attack with no attackers would silently measure nothing
            raise ValueError(f"kind={self.kind!r} needs a coalition: set "
                             "adversaries or adversary_frac > 0")
        if self.every_k < 1:
            raise ValueError(f"every_k must be >= 1, got {self.every_k}")
        if self.start_round < 0:
            raise ValueError(
                f"start_round must be >= 0, got {self.start_round}")
        if self.stop_round is not None and self.stop_round <= self.start_round:
            raise ValueError(
                f"stop_round ({self.stop_round}) must be > start_round "
                f"({self.start_round}); an empty window silently never "
                f"attacks")
        if self.victim_cluster is not None and self.victim_cluster < 0:
            raise ValueError(
                f"victim_cluster must be >= 0, got {self.victim_cluster}")
        if not 0.0 <= self.mimic_blend <= 1.0:
            raise ValueError(
                f"mimic_blend must be in [0, 1], got {self.mimic_blend}")
        if self.min_tenure < 0:
            raise ValueError(
                f"min_tenure must be >= 0, got {self.min_tenure}")

    @property
    def is_null(self) -> bool:
        """True when the spec changes nothing: no adversary and no defense
        knob. The engine then builds no hook at all."""
        return self.kind == "none" and self.min_tenure == 0

    @property
    def attacks(self) -> bool:
        """True when an adversary coalition exists (the poison and vote
        hooks are built in)."""
        return self.kind != "none"

    def signature(self) -> str:
        """Canonical string for checkpoint compatibility (the JAX package's
        spelling: suffixes only for non-defaults)."""
        adv = ("-" if self.adversaries is None
               else ".".join(str(a) for a in self.adversaries))
        sig = (f"k{self.kind}a{adv}f{self.adversary_frac:g}"
               f"p{self.poison}x{self.strength:g}e{self.every_k}"
               f"s{self.start_round}t{self.stop_round}")
        if self.victim_cluster is not None:
            sig += f"v{self.victim_cluster}"
        if self.lie_votes:
            sig += "L"
        if self.mimic_blend:
            sig += f"b{self.mimic_blend:g}"
        if self.min_tenure:
            sig += f"n{self.min_tenure}"
        return sig

"""The red team's hooks in the fused round (port of
fedmse_tpu/redteam/adversary.py), on the port's flat [N, P] params.

Where federation/attack.py's poison_fn models a blind malicious aggregator,
these model a COALITION that attacks where the federation decides:

  * `update_fn` poisons the coalition's OWN updates after local training:
    each adversarial row of the trained params is perturbed before the
    merge, so the poison arrives weighted like any honest update and must
    get past verification from inside;
  * `merge_fn` fires only when the ELECTED aggregator is adversarial and
    poisons the merge it coordinates: the victim cluster's row of the
    [K, P] cluster merges when the spec names one (the other clusters'
    broadcasts are untouched), else the whole merge.

The JAX package schedules both with `lax.cond` on the traced round index.
A captured CUDA graph replays both stages every round, so here the
schedule is data: `active(start, n)` gives each round's 0/1 flag on the
host, the chunk uploads it, and the hooks select with `torch.where`.
(The package imports nothing of federation/, which imports it.) Noise
(poison 'noise') is drawn on the host from the run's red-team stream
(utils/seeding.py): the update stage's row of client i at absolute round t
from `stream_rng(key, UPDATE_POISON_FOLD, t, i)`, the merge stage's from
`stream_rng(key, MERGE_POISON_FOLD, t, 0)` ([K·P] when clustered: its
first P values are the unclustered draw). The fold constants are the JAX
package's round-key folds. jax.random's normals cannot be reproduced here;
parity tests feed the JAX package's draw.

`RedteamFns` also carries the election's flags: `gate_votes` builds the
min-tenure gate in, `lie_votes` the colluding voter's pick
(federation/voting.elect_on_device).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from fedmse_tpu_torch.redteam.spec import RedteamSpec
from fedmse_tpu_torch.utils.seeding import StreamKey, stream_rng

# the two poison stages' sub-streams, the JAX package's round-key folds
UPDATE_POISON_FOLD = 0x52454454  # "REDT"
MERGE_POISON_FOLD = 0x52454455


def schedule_active(spec: RedteamSpec, round_index: int) -> bool:
    """Whether absolute round `round_index` is a poison round."""
    active = (round_index >= spec.start_round
              and (round_index - spec.start_round) % spec.every_k == 0)
    if spec.stop_round is not None:
        active = active and round_index < spec.stop_round
    return active


def _poison_rows(spec: RedteamSpec, params: torch.Tensor, adv: torch.Tensor,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Perturb the adversarial rows (adv [G] > 0) of params [G, P]; the
    honest rows pass through bit for bit. `noise` [G, P] standard normals
    for poison 'noise'."""
    rows = adv[:, None]
    if spec.poison == "scale":
        return params * torch.where(rows > 0, spec.strength, 1.0)
    if spec.poison == "sign_flip":
        return torch.where(rows > 0, -spec.strength * params, params)
    if noise is None:
        raise ValueError("a noise poison needs its draws")
    return torch.where(rows > 0, params + rows * spec.strength * noise,
                       params)


def _poison_tree(spec: RedteamSpec, merged: torch.Tensor,
                 noise: Optional[torch.Tensor] = None,
                 clustered: bool = False) -> torch.Tensor:
    """Perturb a merge: the victim cluster's row of the [K, P] cluster
    merges when clustered and the spec names one, else every element of
    merged ([P], or [K, P]). `noise` has merged's shape."""
    if clustered and spec.victim_cluster is not None:
        k = merged.shape[0]
        victim = (torch.arange(k, device=merged.device)
                  == spec.victim_cluster).to(torch.float32)
        return _poison_rows(spec, merged, victim, noise)
    if spec.poison == "scale":
        return merged * spec.strength
    if spec.poison == "sign_flip":
        return -spec.strength * merged
    if noise is None:
        raise ValueError("a noise poison needs its draws")
    return merged + spec.strength * noise


def update_noise(key: StreamKey, start_round: int, n_rounds: int,
                 n_clients: int, width: int) -> np.ndarray:
    """[n_rounds, n_clients, width] f32 standard normals of the update
    stage; client i's row at round t from (t, i) alone."""
    out = np.empty((n_rounds, n_clients, width), np.float32)
    for r in range(n_rounds):
        for i in range(n_clients):
            out[r, i] = stream_rng(key, UPDATE_POISON_FOLD, start_round + r,
                                   i).standard_normal(width,
                                                      dtype=np.float32)
    return out


def merge_noise(key: StreamKey, start_round: int, n_rounds: int,
                width: int) -> np.ndarray:
    """[n_rounds, width] f32 standard normals of the merge stage; row r
    from round start_round + r alone."""
    out = np.empty((n_rounds, width), np.float32)
    for r in range(n_rounds):
        out[r] = stream_rng(key, MERGE_POISON_FOLD, start_round + r,
                            0).standard_normal(width, dtype=np.float32)
    return out


class RedteamFns(NamedTuple):
    """What the fused round builds in. `update_fn(params [N, P], adv [N],
    active, noise=None)` and `merge_fn(merged, aggregator_is_adv, active,
    noise=None, clustered=False)` are None when the stage is off (a
    defense-only spec); `active` and `aggregator_is_adv` are device
    values, so neither reads the host. `gate_votes` builds the min-tenure
    election gate in, `lie_votes` the colluding voter's pick."""

    update_fn: Optional[Callable]
    merge_fn: Optional[Callable]
    lie_votes: bool
    gate_votes: bool
    spec: RedteamSpec

    @property
    def needs_noise(self) -> bool:
        return self.spec.attacks and self.spec.poison == "noise"

    def active(self, start_round: int, n_rounds: int) -> np.ndarray:
        """[n_rounds] f32: 1 where the round is a poison round."""
        return np.asarray([schedule_active(self.spec, start_round + r)
                           for r in range(n_rounds)], np.float32)


def make_redteam_fns(spec: Optional[RedteamSpec]) -> Optional[RedteamFns]:
    """None for no spec or a null one (nothing is built); otherwise the
    hooks. A defense-only spec (kind 'none', min_tenure > 0) gives both
    poison stages None and the vote gate alone."""
    if spec is None or spec.is_null:
        return None
    update_fn = merge_fn = None
    if spec.attacks:
        def update_fn(params, adv, active, noise=None):
            return torch.where(active > 0,
                               _poison_rows(spec, params, adv, noise),
                               params)

        def merge_fn(merged, aggregator_is_adv, active, noise=None,
                     clustered=False):
            fire = (active > 0) & aggregator_is_adv
            return torch.where(fire, _poison_tree(spec, merged, noise,
                                                  clustered), merged)

    return RedteamFns(update_fn=update_fn, merge_fn=merge_fn,
                      lie_votes=bool(spec.lie_votes and spec.attacks),
                      gate_votes=spec.min_tenure > 0, spec=spec)

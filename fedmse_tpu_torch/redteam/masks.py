"""The red team's per-round inputs: [T, N] adversary and vote-eligibility
masks, on the host (port of fedmse_tpu/redteam/masks.py).

Like the chaos masks and the membership timeline, the coalition is an
input of the fused round, not control flow around it: the engine expands
the whole schedule once and uploads a slice per chunk, so every chunking
and replay sees the same coalition.

  * slot i's coalition draw is one bernoulli from
    `stream_rng(redteam_key, COALITION, 0, i)`: a function of the run's
    red-team key and the ABSOLUTE slot id alone, so padding the client
    axis cannot move the coalition, and drawing it consumes nothing from
    any other stream (utils/seeding.py). jax.random's draw cannot be
    reproduced here; parity tests feed the JAX package's masks;
  * the coalition does not change over rounds, but the masks are [T, N]
    so they ride the chunk's uploads like every other per-round input;
  * `vote_ok` is the min-tenure defense: a recycled tenant (generation
    > 0) may neither vote nor be elected until it has held its slot for
    `min_tenure` consecutive rounds, computed from the expanded elastic
    membership timeline. Founding tenants are never gated.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from fedmse_tpu_torch.redteam.spec import RedteamSpec
from fedmse_tpu_torch.utils.seeding import StreamKey, stream_rng

COALITION = 0  # the coalition draw's sub-stream of the red-team stream


class RedteamMasks(NamedTuple):
    """Per-round red-team inputs, numpy, on a leading [T] rounds axis."""

    adv: np.ndarray      # [T, N] f32: 1 = the slot is adversary-controlled
    vote_ok: np.ndarray  # [T, N] f32: 1 = the slot may vote and be elected


def null_redteam_masks(n_clients: int) -> RedteamMasks:
    """One round of no adversary and no gate (what a null spec expands
    to), [1, N]."""
    return RedteamMasks(adv=np.zeros((1, n_clients), np.float32),
                        vote_ok=np.ones((1, n_clients), np.float32))


def coalition_mask(spec: RedteamSpec, redteam_key: StreamKey,
                   n_clients: int) -> np.ndarray:
    """[N] f32 adversary-slot mask: the explicit ids when the spec names
    them (ids past the client axis drop), else the per-slot draw."""
    adv = np.zeros(n_clients, np.float32)
    if not spec.attacks:
        return adv
    if spec.adversaries is not None:
        ids = [a for a in spec.adversaries if a < n_clients]
        adv[np.asarray(ids, np.int64)] = 1.0
        return adv
    for i in range(n_clients):
        adv[i] = float(stream_rng(redteam_key, COALITION, 0, i).random()
                       < spec.adversary_frac)
    return adv


def tenure_vote_ok(min_tenure: int, membership, n_rounds: int,
                   n_clients: int) -> np.ndarray:
    """[T, N] f32 vote eligibility under the min-tenure gate, from an
    expanded membership timeline (leaves [T', N], T' >= n_rounds). A
    recycled tenant's streak restarts at 1 on its `joined` round and grows
    while it stays a member; it may vote once streak >= min_tenure.
    Founding tenants (generation 0) always may."""
    member = np.asarray(membership.member[:n_rounds]) > 0
    joined = np.asarray(membership.joined[:n_rounds]) > 0
    gen = np.asarray(membership.generation[:n_rounds])
    vote_ok = np.ones((n_rounds, n_clients), np.float32)
    streak = np.zeros((n_clients,), np.int64)
    for t in range(n_rounds):
        streak = np.where(joined[t], 1, np.where(member[t], streak + 1, 0))
        gated = (gen[t] > 0) & (streak < min_tenure)
        vote_ok[t] = np.where(gated, 0.0, 1.0)
    return vote_ok


def make_redteam_masks(spec: RedteamSpec, redteam_key: StreamKey,
                       n_rounds: int, n_clients: int,
                       membership=None) -> RedteamMasks:
    """The masks of rounds [0, n_rounds). `membership` (an expanded
    MembershipMasks over at least the same horizon) is needed only when
    `min_tenure > 0`: without an elastic timeline there is no recycled
    tenant to gate."""
    adv_row = coalition_mask(spec, redteam_key, n_clients)
    adv = np.broadcast_to(adv_row, (n_rounds, n_clients)).copy()
    if spec.min_tenure > 0:
        if membership is None:
            # a silent all-pass gate would report the defense as free
            raise ValueError("min_tenure > 0 needs the expanded elastic "
                             "membership masks (no elastic spec => no "
                             "recycled tenants to gate)")
        vote_ok = tenure_vote_ok(spec.min_tenure, membership, n_rounds,
                                 n_clients)
    else:
        vote_ok = np.ones((n_rounds, n_clients), np.float32)
    return RedteamMasks(adv=adv, vote_ok=vote_ok)

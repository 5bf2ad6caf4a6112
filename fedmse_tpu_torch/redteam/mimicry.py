"""Latent-statistics mimicry: the cluster-assignment poisoning front end
(port of fedmse_tpu/redteam/mimicry.py; numpy, as there).

The cluster fit (cluster/assign.py) groups gateways by the Gaussian-JS
divergence between their latent-moment summaries. An adversary that wants
INTO a victim cluster needs latent statistics that look like the victim's
to the JS metric, not the victim's data. `mimic_latent_stats` crafts them
on the host, between the statistics and the medoid fit: each adversary's
(mean, cov) is moment-blended toward the victim's, the exact moment summary
of a mixture that draws from the victim with probability `blend` (1.0 is
perfect mimicry, which no moments-based metric can tell apart). The defense
it calibrates is assignment hysteresis (cluster/assign.py
refit_with_hysteresis): an imperfect mimic keeps paying its residual
divergence at every refit and never flips.

`assignment_capture_rate` is the attack's first-stage success metric: the
fraction of the coalition the fit placed inside the victim cluster.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def mimic_latent_stats(means: np.ndarray, covs: np.ndarray,
                       adv_ids: Sequence[int], victim_mu: np.ndarray,
                       victim_cov: np.ndarray,
                       blend: float) -> Tuple[np.ndarray, np.ndarray]:
    """Blend the adversary rows of per-gateway latent stats toward the
    victim's (new arrays; inputs untouched).

    means [G, D] f32, covs [G, D, D] f32; victim_mu [D], victim_cov
    [D, D]. The blended row is the moment summary of the mixture
    blend·victim + (1-blend)·own: mean is the convex combination, cov is
    the within-component blend PLUS the between-component spread
    blend·(1-blend)·outer(Δμ) — dropping the spread term would understate
    the mimic's variance and make the forgery EASIER to cluster-separate
    than a real traffic blend, overselling the defense."""
    if not 0.0 <= blend <= 1.0:
        raise ValueError(f"blend must be in [0, 1], got {blend}")
    means = np.array(means, np.float32, copy=True)
    covs = np.array(covs, np.float32, copy=True)
    victim_mu = np.asarray(victim_mu, np.float32)
    victim_cov = np.asarray(victim_cov, np.float32)
    for g in adv_ids:
        dmu = victim_mu - means[g]
        means[g] = blend * victim_mu + (1.0 - blend) * means[g]
        covs[g] = (blend * victim_cov + (1.0 - blend) * covs[g]
                   + blend * (1.0 - blend) * np.outer(dmu, dmu))
    return means, covs


def assignment_capture_rate(assignment: np.ndarray,
                            adv_ids: Sequence[int],
                            victim: int) -> float:
    """Fraction of the coalition assigned to the victim cluster — the
    cluster-poisoning attack's first-stage success metric."""
    if len(adv_ids) == 0:
        return 0.0
    assignment = np.asarray(assignment)
    inside = sum(1 for g in adv_ids if int(assignment[g]) == victim)
    return inside / len(adv_ids)

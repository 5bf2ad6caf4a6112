"""ClusterSpec: the clustered and personalized federation's settings (port
of fedmse_tpu/cluster/spec.py; the same fields, validation messages,
`is_null` and `signature()`, character for character, since the signature
is a checkpoint key a snapshot of either package is checked against).

  * `k`             cluster-level global models; k = 1 is the single-global
                    federation, and with `personalize` off the engine builds
                    nothing for it (the fused round's graphs are the clean
                    round's);
  * `personalize`   the modules in `shared_modules` (default the encoder)
                    take the cluster merge, every other module stays each
                    gateway's own: the broadcast a client verifies and
                    loads is cluster-encoder + own-decoder;
  * `refit_every`   0 fits the assignment once at round 0; n > 0 refits
                    when n rounds have passed since the last fit, at the
                    entry of a chunk (an assignment holds for its chunk);
  * `metric`        'js' (Gaussian Jensen-Shannon over each gateway's latent
                    mean and covariance) or 'gmm' (variational mixture JS
                    over per-gateway latent GMMs of `gmm_components`);
  * `hysteresis`    a cadence refit moves a gateway off its cluster only
                    when the best cluster's JS beats its own by this
                    relative margin;
  * `fit_sample`    fleets larger than this fit medoids on a stride
                    subsample and assign everyone to the medoids (0: always
                    the dense [G, G] fit).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Clustered + personalized federation knobs (module docstring)."""

    k: int = 1
    personalize: bool = False
    refit_every: int = 0
    metric: str = "js"
    # assignment-move hysteresis on cadence refits (module docstring);
    # 0.0 = refit from scratch (the exact pre-hysteresis behavior)
    hysteresis: float = 0.0
    # mixture size of the 'gmm' metric's per-gateway latent summary
    gmm_components: int = 2
    shared_modules: Tuple[str, ...] = ("encoder",)
    # medoid-fit scale cap (the CLARA idiom): fleets larger than this fit
    # medoids on a deterministic stride subsample and assign everyone by
    # JS to the k medoid Gaussians (O(G*k)) — the dense [G, G] pairwise
    # matrix is quadratic and infeasible at pod scale (100k gateways =
    # 40 GB). Fleets <= fit_sample keep the exact dense fit, so every
    # pre-existing grid is bitwise unchanged. 0 = always dense.
    fit_sample: int = 4096

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.fit_sample < 0:
            raise ValueError(
                f"fit_sample must be >= 0 (0 = always dense pairwise), "
                f"got {self.fit_sample}")
        if self.refit_every < 0:
            raise ValueError(
                f"refit_every must be >= 0 (0 = fit once), got "
                f"{self.refit_every}")
        if self.metric not in ("js", "gmm"):
            raise ValueError(
                f"unknown assignment metric {self.metric!r}: 'js' (Gaussian "
                "Jensen-Shannon over per-gateway latent statistics) and "
                "'gmm' (variational mixture JS over per-gateway latent "
                "GMMs) are the supported metrics; the reference's KDE "
                "similarity_score is deliberately not an assignment metric "
                "— PARITY.md §9")
        if not 0.0 <= self.hysteresis < 1.0:
            raise ValueError(
                f"hysteresis must be in [0, 1) (0 = refit from scratch, "
                f"-> 1 = never move), got {self.hysteresis}")
        if self.gmm_components < 1:
            raise ValueError(
                f"gmm_components must be >= 1, got {self.gmm_components}")
        if self.personalize and not self.shared_modules:
            raise ValueError(
                "personalize=True needs at least one shared module "
                "(an empty shared set federates nothing — that is local "
                "training, not personalized federation)")

    @property
    def is_null(self) -> bool:
        """True when the spec changes nothing: k=1 without personalization
        IS the single-global program (the bit-identity lowering)."""
        return self.k == 1 and not self.personalize

    def signature(self) -> str:
        """Canonical string for the checkpoint-compat guard (JSON-stable,
        the ElasticSpec.signature idiom): a K or mask change invalidates
        resumed assignments with a clear message."""
        shared = ".".join(self.shared_modules)
        sig = (f"k{self.k}p{int(self.personalize)}r{self.refit_every}"
               f"m{self.metric}s{shared}")
        if self.fit_sample != 4096:  # default stays compatible with
            sig += f"f{self.fit_sample}"  # ... pre-fit_sample checkpoints
        if self.hysteresis != 0.0:  # same pre-existing-checkpoint rule
            sig += f"h{self.hysteresis}"
        if self.gmm_components != 2:  # the metric is already in `m...`
            sig += f"c{self.gmm_components}"
        return sig

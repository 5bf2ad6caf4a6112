"""The red team's round half: adaptive adversaries and the defenses measured
against them, in the fused round (port of fedmse_tpu/redteam/).

  * spec.py      RedteamSpec (coalition, poison schedule, defense knobs)
  * masks.py     the [T, N] adversary and vote-eligibility inputs
  * adversary.py the update and merge poison hooks and the election flags
  * mimicry.py   latent-statistics forgery against the cluster fit
  * traffic.py   the slow-drift adversary against the flywheel (flywheel/)
  * ingest.py    the gateway plane's half: shed-storm forcing against
                 admission and cost gaming against the autoscaler (net/)

    from fedmse_tpu_torch.redteam import RedteamSpec
    engine = RoundEngine(..., fused=True, redteam=RedteamSpec(
        kind="sybil", adversaries=(3, 5), lie_votes=True))
"""

from fedmse_tpu_torch.redteam.adversary import (MERGE_POISON_FOLD,
                                                UPDATE_POISON_FOLD,
                                                RedteamFns,
                                                make_redteam_fns,
                                                merge_noise, update_noise)
from fedmse_tpu_torch.redteam.ingest import (CostGamingAdversary,
                                             InstantReplica,
                                             ShedStormAdversary,
                                             cost_gaming_cell,
                                             shed_storm_cell)
from fedmse_tpu_torch.redteam.masks import (RedteamMasks, coalition_mask,
                                            make_redteam_masks,
                                            null_redteam_masks,
                                            tenure_vote_ok)
from fedmse_tpu_torch.redteam.mimicry import (assignment_capture_rate,
                                              mimic_latent_stats)
from fedmse_tpu_torch.redteam.spec import (POISON_KINDS, REDTEAM_KINDS,
                                           RedteamSpec)
from fedmse_tpu_torch.redteam.traffic import (SlowDriftAdversary,
                                              normal_fraction)

__all__ = [
    "RedteamSpec", "REDTEAM_KINDS", "POISON_KINDS",
    "RedteamMasks", "make_redteam_masks", "null_redteam_masks",
    "coalition_mask", "tenure_vote_ok",
    "RedteamFns", "make_redteam_fns",
    "update_noise", "merge_noise",
    "UPDATE_POISON_FOLD", "MERGE_POISON_FOLD",
    "mimic_latent_stats", "assignment_capture_rate",
    "SlowDriftAdversary", "normal_fraction",
    "InstantReplica", "ShedStormAdversary", "shed_storm_cell",
    "CostGamingAdversary", "cost_gaming_cell",
]

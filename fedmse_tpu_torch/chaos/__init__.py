"""Fault injection: client churn, stragglers, aggregator crashes and
broadcast loss, as per-round masks the fused round takes from device
buffers (port of fedmse_tpu/chaos/).

    from fedmse_tpu_torch.chaos import ChaosSpec
    engine = RoundEngine(..., fused=True,
                         chaos=ChaosSpec(dropout_p=0.3, crash_p=0.1))
"""

from fedmse_tpu_torch.chaos.masks import (ChaosMasks, all_clear_masks,
                                          make_batched_chaos_masks,
                                          make_chaos_masks, reelection_draws)
from fedmse_tpu_torch.chaos.metrics import (joiner_incumbent_gap,
                                            mean_auc_curve,
                                            membership_metrics,
                                            quota_exhaustion_round,
                                            resilience_metrics,
                                            rounds_to_recover)
from fedmse_tpu_torch.chaos.spec import ChaosSpec

__all__ = ["ChaosMasks", "ChaosSpec", "all_clear_masks",
           "joiner_incumbent_gap", "make_batched_chaos_masks",
           "make_chaos_masks", "mean_auc_curve",
           "membership_metrics", "quota_exhaustion_round",
           "reelection_draws", "resilience_metrics", "rounds_to_recover"]

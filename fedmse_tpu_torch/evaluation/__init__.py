"""Per-client evaluation over the stacked federation."""

from fedmse_tpu_torch.evaluation.evaluator import (make_evaluate_all,
                                                   resolve_score_kind)

__all__ = ["make_evaluate_all", "resolve_score_kind"]

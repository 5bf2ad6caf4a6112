"""The streaming semi-supervised control loop (port of fedmse_tpu/flywheel/).

FedMSE trains on normal-only traffic; the flywheel turns that premise into
a closed loop over the pieces the port already has:

    serve     (serving/continuous.py: the forward and, for the kNN score,
               the kNN score kernel per bucket)
      -> buffer    (buffer.py: rows verdicted normal enter per-gateway host
                    reservoirs through the front's intake tap, one call
                    per harvested batch)
      -> trigger   (serving/drift.py swap_recommended, sustained over the
                    controller's quorum of polls)
      -> fine-tune (controller.py: a few fused federated rounds on the
                    buffered rows, warm-started from clones of the live
                    params: the train kernel in CUDA graphs)
      -> swap      (swap.py: params, refreshed kNN banks or centroids and
                    refit thresholds installed in ONE ContinuousBatcher.swap
                    call, the drift monitor rebaselined, cooldown armed)
      -> serve     (no ticket dropped or scored twice across the swap)

`run_flywheel_smoke` (harness.py) is the CLI's `--flywheel` pass.
"""

from fedmse_tpu_torch.flywheel.buffer import (FinetuneData, FlywheelBuffer,
                                              stack_ragged_rows)
from fedmse_tpu_torch.flywheel.controller import (FinetuneRunner,
                                                  FlywheelController,
                                                  finetune_config)
from fedmse_tpu_torch.flywheel.harness import (host_auc, run_flywheel_smoke,
                                               stream_with_polling,
                                               ticket_integrity)
from fedmse_tpu_torch.flywheel.swap import (build_and_apply_swap,
                                            refit_calibration)

__all__ = [
    "FlywheelBuffer", "FinetuneData", "stack_ragged_rows",
    "FlywheelController", "FinetuneRunner", "finetune_config",
    "build_and_apply_swap", "refit_calibration",
    "run_flywheel_smoke", "stream_with_polling", "ticket_integrity",
    "host_auc",
]

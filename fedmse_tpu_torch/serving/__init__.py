"""Online anomaly scoring over a trained federation.

  engine.py       bucketed scorer: multi-tenant (per-row gateway routing in
                  the fused kernel) and single-global; state as a per-launch
                  operand -> hot swap; non-blocking dispatch / harvest
  calibration.py  per-gateway percentile thresholds fit on validation
                  normals, persisted as JSON
  batcher.py      host-side micro-batcher (max_batch / max_wait_ms) with
                  latency percentiles and rows/s
"""

from fedmse_tpu_torch.serving.batcher import MicroBatcher, Ticket
from fedmse_tpu_torch.serving.calibration import (ServingCalibration,
                                                  fit_calibration)
from fedmse_tpu_torch.serving.engine import (PendingScores, ServingEngine,
                                             ServingRoster,
                                             UnknownGatewayError,
                                             fit_gateway_centroids)

__all__ = ["MicroBatcher", "Ticket", "ServingCalibration", "fit_calibration",
           "PendingScores", "ServingEngine", "ServingRoster",
           "UnknownGatewayError", "fit_gateway_centroids"]

"""Online anomaly scoring over a trained federation.

  engine.py       bucketed scorer: multi-tenant (per-row gateway routing in
                  the fused kernel and the distance kernel) and
                  single-global; state {params, centroids, banks} as a
                  per-launch operand -> hot swap; non-blocking dispatch /
                  harvest
  calibration.py  per-gateway percentile thresholds fit on validation
                  normals, persisted as JSON
  batcher.py      host-side micro-batcher (max_batch / max_wait_ms) with
                  latency percentiles and rows/s
  continuous.py   continuous-batching front: double-buffered dispatch,
                  adaptive bucket pick, hot swap between dispatches
  drift.py        streaming per-gateway drift monitor vs the calibration
  smoke.py        the CLI's --serve pass (fedmse_tpu_torch.main)
"""

from fedmse_tpu_torch.serving.batcher import MicroBatcher, Ticket
from fedmse_tpu_torch.serving.calibration import (ServingCalibration,
                                                  fit_calibration)
from fedmse_tpu_torch.serving.continuous import (ContinuousBatcher,
                                                 StreamTicket, TicketBlock)
from fedmse_tpu_torch.serving.drift import DriftMonitor
from fedmse_tpu_torch.serving.engine import (PendingScores, ServingEngine,
                                             ServingRoster,
                                             UnknownGatewayError,
                                             fit_gateway_centroids)
from fedmse_tpu_torch.serving.smoke import (interleave_order,
                                            interleave_test_rows,
                                            run_serve_smoke)

__all__ = ["MicroBatcher", "Ticket", "ServingCalibration", "fit_calibration",
           "ContinuousBatcher", "StreamTicket", "TicketBlock",
           "DriftMonitor", "PendingScores", "ServingEngine", "ServingRoster",
           "UnknownGatewayError", "fit_gateway_centroids",
           "interleave_order", "interleave_test_rows", "run_serve_smoke"]

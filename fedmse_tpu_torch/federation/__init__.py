"""The federated training round: client state, local training, the vote,
aggregation, verification, the round engine with its per-phase and fused
paths (fused.py: the round with no host read inside, replayed as CUDA
graphs on the card) and the pipelined chunk loop (pipeline.py)."""

from fedmse_tpu_torch.federation.fused import FusedRound, FusedRoundOut
from fedmse_tpu_torch.federation.pipeline import (InFlightChunk,
                                                  PipelineStats,
                                                  run_pipelined_schedule)
from fedmse_tpu_torch.federation.rounds import (RoundEngine, RoundResult,
                                                absorb_fused_out,
                                                split_metric_columns)
from fedmse_tpu_torch.federation.state import (ClientStates, HostState,
                                               client_states_from_numpy,
                                               init_client_states)

__all__ = ["RoundEngine", "RoundResult", "split_metric_columns",
           "absorb_fused_out", "FusedRound", "FusedRoundOut",
           "InFlightChunk", "PipelineStats", "run_pipelined_schedule",
           "ClientStates", "HostState", "client_states_from_numpy",
           "init_client_states"]

"""The federated training round: client state, local training, the vote,
aggregation, verification, the round engine with its per-phase and fused
paths (fused.py: the round with no host read inside, replayed as CUDA
graphs on the card), the pipelined chunk loop (pipeline.py), batched
runs (batched.py: a combination's seeds as one federation) and the tiered
state layout (tiered.py: the fleet's state on the host, each round's
cohort on the card)."""

from fedmse_tpu_torch.federation.fused import FusedRound, FusedRoundOut
from fedmse_tpu_torch.federation.pipeline import (InFlightChunk,
                                                  PipelineStats,
                                                  PrefetchedCohort,
                                                  TieredStats,
                                                  run_pipelined_batched,
                                                  run_pipelined_schedule)
from fedmse_tpu_torch.federation.rounds import (RoundEngine, RoundResult,
                                                absorb_fused_out,
                                                split_metric_columns)
from fedmse_tpu_torch.federation.state import (ClientStates, HostState,
                                               TieredClientStore,
                                               client_states_from_numpy,
                                               init_client_states)
from fedmse_tpu_torch.federation.batched import BatchedRunEngine
from fedmse_tpu_torch.federation.tiered import (TieredRoundEngine,
                                                run_tiered_combination)

__all__ = ["RoundEngine", "RoundResult", "split_metric_columns",
           "absorb_fused_out", "FusedRound", "FusedRoundOut",
           "InFlightChunk", "PipelineStats", "run_pipelined_schedule",
           "run_pipelined_batched", "BatchedRunEngine",
           "PrefetchedCohort", "TieredStats", "TieredRoundEngine",
           "run_tiered_combination", "TieredClientStore",
           "ClientStates", "HostState", "client_states_from_numpy",
           "init_client_states"]

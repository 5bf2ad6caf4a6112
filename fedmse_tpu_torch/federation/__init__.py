"""The federated training round: client state, local training, the vote,
aggregation, verification and the round engine."""

from fedmse_tpu_torch.federation.rounds import (RoundEngine, RoundResult,
                                                split_metric_columns)
from fedmse_tpu_torch.federation.state import (ClientStates, HostState,
                                               client_states_from_numpy,
                                               init_client_states)

__all__ = ["RoundEngine", "RoundResult", "split_metric_columns",
           "ClientStates", "HostState", "client_states_from_numpy",
           "init_client_states"]

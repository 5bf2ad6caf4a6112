"""Federated data: per-client arrays, synthetic clients, stacked tensors."""

from fedmse_tpu_torch.data.loader import (ClientData, IoTDataProcessor,
                                          build_dev_dataset, load_data,
                                          prepare_clients)
from fedmse_tpu_torch.data.stacking import (FederatedData, StackDims,
                                            pad_federated_data,
                                            stack_clients, stack_dims)
from fedmse_tpu_torch.data.synthetic import (dirichlet_partition,
                                             synthetic_clients,
                                             synthetic_dirichlet_clients,
                                             synthetic_multimodal_clients,
                                             synthetic_typed_clients)

__all__ = ["ClientData", "IoTDataProcessor", "build_dev_dataset",
           "load_data", "prepare_clients", "FederatedData", "StackDims",
           "pad_federated_data", "stack_clients", "stack_dims",
           "dirichlet_partition", "synthetic_clients",
           "synthetic_dirichlet_clients", "synthetic_multimodal_clients",
           "synthetic_typed_clients"]

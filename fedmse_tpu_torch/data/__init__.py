"""Federated data: per-client arrays, synthetic clients, stacked tensors."""

from fedmse_tpu_torch.data.loader import (ClientData, IoTDataProcessor,
                                          build_dev_dataset, load_data,
                                          prepare_clients)
from fedmse_tpu_torch.data.stacking import (FederatedData, StackDims,
                                            stack_clients, stack_dims)
from fedmse_tpu_torch.data.synthetic import synthetic_clients

__all__ = ["ClientData", "IoTDataProcessor", "build_dev_dataset",
           "load_data", "prepare_clients", "FederatedData", "StackDims",
           "stack_clients", "stack_dims", "synthetic_clients"]

"""The ClientModel checkpoint tree."""

from fedmse_tpu_torch.checkpointing.io import (ResultsWriter,
                                               load_client_models,
                                               save_client_models)

__all__ = ["ResultsWriter", "load_client_models", "save_client_models"]

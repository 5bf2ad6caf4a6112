"""Results artifacts and the ClientModel checkpoint tree."""

from fedmse_tpu_torch.checkpointing.io import (ResultsWriter,
                                               load_client_models,
                                               save_client_models,
                                               save_latent_data,
                                               save_training_tracking)

__all__ = ["ResultsWriter", "load_client_models", "save_client_models",
           "save_latent_data", "save_training_tracking"]

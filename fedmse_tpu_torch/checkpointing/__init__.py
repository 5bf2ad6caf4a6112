"""Results artifacts, the ClientModel checkpoint tree and whole-federation
snapshots for a resume."""

from fedmse_tpu_torch.checkpointing.io import (CheckpointManager,
                                               ResultsWriter,
                                               load_client_models,
                                               save_client_models,
                                               save_latent_data,
                                               save_training_tracking)

__all__ = ["CheckpointManager", "ResultsWriter", "load_client_models", "save_client_models",
           "save_latent_data", "save_training_tracking"]

"""Autoencoder models and the centroid classifier."""

from fedmse_tpu_torch.models.autoencoder import (Autoencoder, ShrinkAutoencoder,
                                                 init_stacked_params,
                                                 make_model, params_from_numpy)
from fedmse_tpu_torch.models.centroid import CentroidClassifier, fit_centroid

__all__ = ["Autoencoder", "ShrinkAutoencoder", "init_stacked_params",
           "make_model", "params_from_numpy", "CentroidClassifier",
           "fit_centroid"]

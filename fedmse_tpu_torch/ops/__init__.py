"""Tensor ops of the port: losses, distances, statistics, metrics, the
precision policy, and the fused autoencoder-forward kernel (fused_ae.py,
built from csrc/fused_ae.cu by native.py)."""

"""PyTorch + CUDA port of fedmse_tpu for NVIDIA Hopper.

A second package beside the JAX reference (`fedmse_tpu/`), written in
PyTorch with hand-written CUDA kernels. It imports neither jax nor anything
of `fedmse_tpu`. This slice carries the scoring path: per-client evaluation
and multi-tenant serving over the fused autoencoder-forward kernel
(csrc/fused_ae.cu). Entry points run on the card unless the caller passes
device="cpu" (fedmse_tpu_torch/device.py).
"""

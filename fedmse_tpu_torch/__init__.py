"""PyTorch + CUDA port of fedmse_tpu for NVIDIA Hopper.

A second package beside the JAX reference (`fedmse_tpu/`), written in
PyTorch with hand-written CUDA kernels. It imports neither jax nor anything
of `fedmse_tpu`. It carries the scoring path (per-client evaluation and
multi-tenant serving over the fused autoencoder-forward kernel,
csrc/fused_ae.cu) and federated training (federation/, main.py; every
local batch step is one launch of the fused train-step kernel,
csrc/fused_train.cu). Entry points run on the card unless the caller
passes device="cpu" (fedmse_tpu_torch/device.py).
"""

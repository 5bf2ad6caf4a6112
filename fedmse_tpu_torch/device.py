"""Where the port runs: the card by default, the CPU only when asked.

Every entry point that places tensors takes `device=` and resolves it here.
The default is "cuda"; without a CUDA device that raises instead of quietly
running on the CPU. Tests pass device="cpu", which runs the plain PyTorch
versions of the kernels.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """The torch.device for `device`; raises when CUDA is asked for but
    absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fedmse_tpu_torch runs on a CUDA device by default, and none is "
            "available; pass device='cpu' to run the plain PyTorch versions "
            "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev

"""Device resolution and float32 numerics for the PyTorch port.

Entry points run on the GPU unless the caller asks for the CPU explicitly;
with no GPU and no explicit ``device="cpu"`` they raise rather than quietly
running on the host.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

# The port computes in full float32, as the JAX package does on the CPU.
# Matmuls already default to it; cuDNN convolutions otherwise run in TF32
# (about three decimal digits), which would break parity with the reference.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the GPU; asking for CUDA without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "posterior_matching_torch: no CUDA device is available; pass "
            "device='cpu' to run on the host"
        )
    return dev

"""Device resolution, float32 numerics and the compute dtype for the
PyTorch port.

Entry points run on the GPU unless the caller asks for the CPU explicitly;
with no GPU and no explicit ``device="cpu"`` they raise rather than quietly
running on the host. Under a process group (:mod:`posterior_matching_torch.
parallel.mesh`) the GPU is the rank's own, ``cuda:LOCAL_RANK``.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist

# The port computes in full float32, as the JAX package does on the CPU.
# Matmuls already default to it; cuDNN convolutions otherwise run in TF32
# (about three decimal digits), which would break parity with the reference.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# A bf16 matmul (compute_dtype bfloat16's unfused Blocks) sums in float32, as
# XLA's does: cuBLAS may otherwise reduce its split-K partials in bf16.
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the GPU (the rank's, ``cuda:LOCAL_RANK``, under a
    process group); asking for CUDA without one raises."""
    if device is None and dist.is_available() and dist.is_initialized():
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "posterior_matching_torch: no CUDA device is available; pass "
            "device='cpu' to run on the host"
        )
    return dev


def torch_dtype(compute_dtype) -> torch.dtype:
    """A config's ``compute_dtype`` (None, "float32" or "bfloat16", or that
    torch dtype) as a torch dtype; any other is refused by name."""
    names = {None: torch.float32, "float32": torch.float32, "bfloat16": torch.bfloat16}
    if compute_dtype in (torch.float32, torch.bfloat16):
        return compute_dtype
    if compute_dtype not in names:
        raise ValueError(f"compute_dtype {compute_dtype!r}: None, float32 or bfloat16")
    return names[compute_dtype]

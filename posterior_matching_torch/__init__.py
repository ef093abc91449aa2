"""PyTorch / CUDA port of posterior_matching_tpu.

The package mirrors the JAX package's layout so each module's counterpart is
found by path. It imports no JAX: the reference package stays the oracle the
tests hold this one against, and the GPU path runs the hand-written Hopper
kernels in ``ops/csrc``.
"""
from posterior_matching_torch.runtime import resolve_device

__all__ = ["resolve_device"]

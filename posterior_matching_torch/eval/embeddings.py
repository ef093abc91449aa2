"""Image embeddings for PRD evaluation: the JAX package's random-conv
embedder in PyTorch.

Counterpart of ``posterior_matching_tpu/eval/embeddings.py``. The JAX
package embeds with the TF-Hub inception when it is cached on disk, else
with a deterministic random-projection conv feature extractor
(``:87-113``). The port has no TF-Hub: it always takes the random-conv
path, with the same weights (drawn from ``PRNGKey(20260816)`` by the
port's own numpy threefry, :mod:`._threefry`) and the same layers: four 4x4
stride-2 convolutions with JAX's ``"SAME"`` padding (asymmetric on an odd
side: 7 -> 4 pads one row above and two below), each followed by
``leaky_relu`` (slope 0.01), then the spatial mean and max concatenated
and projected to 2048.

``get_inception_embeddings(images, batch_size=32, verbose=True,
device=None) -> [N, 2048]`` keeps the JAX signature; the convolutions run
on ``device`` (the GPU unless ``"cpu"``).
"""
from __future__ import annotations

import functools
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from posterior_matching_torch.eval import _threefry
from posterior_matching_torch.runtime import resolve_device

_SEED = 20260816
_DIMS = ((3, 32), (32, 64), (64, 128), (128, 256))
_KERNEL, _STRIDE = 4, 2


@functools.lru_cache(maxsize=1)
def embedder_provenance() -> str:
    """Which embedder PRD numbers come from: always ``"random_conv"`` in the
    port (PRD values are internally consistent but not comparable to the
    reference protocol or the paper). Recorded in eval outputs."""
    warnings.warn(
        "TF-Hub inception is not cached; PRD will use the deterministic "
        "random-conv embedder. Precision/recall values are internally "
        "consistent but NOT comparable to the reference protocol. Set "
        "TFHUB_CACHE_DIR to a directory containing the tfgan inception "
        "module to match the reference.",
        stacklevel=2,
    )
    return "random_conv"


@functools.lru_cache(maxsize=1)
def random_conv_weights() -> Tuple[Tuple[np.ndarray, ...], np.ndarray]:
    """The four HWIO float32 kernels and the ``[512, 2048]`` projection of
    ``embeddings.py:89-96``."""
    keys = _threefry.split(_threefry.prng_key(_SEED), 5)
    kernels = tuple(
        _threefry.normal(k, (_KERNEL, _KERNEL, cin, cout)) / np.float32(np.sqrt(16 * cin))
        for k, (cin, cout) in zip(keys, _DIMS))
    proj = _threefry.normal(keys[4], (256 * 2, 2048)) / np.float32(np.sqrt(512))
    return kernels, proj


def _same_pad(n: int) -> Tuple[int, int]:
    """JAX's ``"SAME"`` padding of one side of length ``n``: ``(lo, hi)``."""
    total = max((-(-n // _STRIDE) - 1) * _STRIDE + _KERNEL - n, 0)
    return total // 2, total - total // 2


def _embed(x: torch.Tensor, kernels: List[torch.Tensor], proj: torch.Tensor) -> torch.Tensor:
    """uint8-valued ``[B, H, W, 3]`` -> ``[B, 2048]``."""
    h = x.permute(0, 3, 1, 2).float() / 255.0
    for w in kernels:
        top, bottom = _same_pad(h.shape[2])
        left, right = _same_pad(h.shape[3])
        h = F.conv2d(F.pad(h, (left, right, top, bottom)), w, stride=_STRIDE)
        h = F.leaky_relu(h, 0.01)
    return torch.cat([h.mean((2, 3)), h.amax((2, 3))], -1) @ proj


@torch.no_grad()
def get_inception_embeddings(images: np.ndarray, batch_size: int = 32, verbose: bool = True,
                             device: Optional[str] = None) -> np.ndarray:
    """``[N, H, W, C]`` images in [0, 1] -> ``[N, 2048]`` float32 embeddings
    (one channel is tiled to three; pixels truncated to uint8 on the host,
    as ``embeddings.py:122-124``). ``verbose`` is kept for the JAX
    signature."""
    dev = resolve_device(device)
    if images.shape[-1] == 1:
        images = np.tile(images, [1, 1, 1, 3])
    images_u8 = (np.asarray(images) * 255).astype(np.uint8)
    embedder_provenance()  # warn (once) that this is not the reference protocol
    kernels, proj = random_conv_weights()
    kernels = [torch.from_numpy(k).permute(3, 2, 0, 1).contiguous().to(dev) for k in kernels]
    proj = torch.from_numpy(proj).to(dev)
    out = [_embed(torch.from_numpy(images_u8[i:i + batch_size]).to(dev), kernels, proj)
           for i in range(0, len(images_u8), batch_size)]
    return torch.cat(out).cpu().numpy()

"""The PixelCNN's dropout masks and the trainer's per-step seeds, as the
program states them: a 32-bit integer hash (the "lowbias32" mixer) keyed by the
step's seed and the gated block's number, so that every implementation of a
block draws the same mask."""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_A, _B = 0x7FEB352D, 0x846CA68B


def mix32_int(x: int) -> int:
    x &= M32
    x ^= x >> 16
    x = (x * _A) & M32
    x ^= x >> 15
    x = (x * _B) & M32
    return x ^ (x >> 16)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` on int64 tensors of uint32 values, without overflow."""
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (hi + x * (c & 0xFFFF)) & M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _A)
    x = x ^ (x >> 15)
    x = _mul32(x, _B)
    return x ^ (x >> 16)


def derive_seed(seed: int, step: int, stream: int) -> int:
    """The trainer's 31-bit seed of ``stream`` (0 dropout, 1 the batch
    prologue's masks) at ``step``."""
    return mix32_int(mix32_int(mix32_int(seed) ^ stream) ^ step) & 0x7FFFFFFF


def keep_mask(seed: int, block_id: int, batch: int, h: int, w: int, c2: int, keep: float,
              device=None) -> torch.Tensor:
    """``[batch, h, w, c2]`` 0/1 keep mask of one gated block: element ``e`` of
    image ``i`` is kept when ``mix(mix(key ^ i) ^ e) < keep * 2^32``, with
    ``key = mix(mix(seed) ^ block_id)``."""
    key = mix32_int(mix32_int(seed) ^ (block_id & M32))
    img = mix32(torch.arange(batch, device=device, dtype=torch.int64) ^ key)
    elem = torch.arange(h * w * c2, device=device, dtype=torch.int64)
    bits = mix32(img[:, None] ^ elem[None, :])
    threshold = min(int(keep * 2.0 ** 32), 2 ** 32 - 1)
    return (bits < threshold).to(torch.float32).reshape(batch, h, w, c2)

"""Random weights drawn on the device from the run's seed, in two calls: one
normal draw and one uniform draw over all tensors, cut into views and scaled
tensor by tensor. The same seed gives the same weights to the program and to the
reference."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def draw(shapes: Dict[str, Tuple[Tuple[int, ...], str, float]], seed: int,
         device) -> Dict[str, torch.Tensor]:
    """``{name: (shape, kind, scale)}`` -> ``{name: tensor}``; kind ``normal``
    (scale times a standard normal), ``uniform`` (on [-scale, scale]) or
    ``zero``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    count = {k: sum(math.prod(s) for s, kind, _ in shapes.values() if kind == k)
             for k in ("normal", "uniform")}
    pools = {"normal": torch.randn(count["normal"], generator=gen, device=device),
             "uniform": torch.rand(count["uniform"], generator=gen, device=device)}
    used = {"normal": 0, "uniform": 0}
    out = {}
    for name, (shape, kind, scale) in shapes.items():
        if kind in ("zero", "one"):
            out[name] = torch.full(shape, float(kind == "one"), device=device)
            continue
        n = math.prod(shape)
        t = pools[kind][used[kind]:used[kind] + n].view(shape)
        used[kind] += n
        out[name] = t * scale if kind == "normal" else (2.0 * t - 1.0) * scale
    return out

"""The CelebA and MNIST mask mixtures, drawn on the device from an explicit generator: the
imputation traffic's mask generator, and the reference's copy of the masks that the
training prologue draws. A frozen copy of the program's generator, call for call,
so that one generator seed gives the same masks in both.

SIIDGM (pattern crops, Bernoulli(0.2) pixels, a centre square, four half images),
the six GCF face-part rectangles and a random rectangle, weights [1, 1, 2] over the
three groups, one component drawn per image. Masks are ``[B, H, W, 1]`` float32,
1 where a pixel is observed."""
from __future__ import annotations

import functools
from typing import Callable, Sequence

import numpy as np
import torch

MaskFn = Callable[[torch.Generator, Sequence[int]], torch.Tensor]
_CANDIDATES = 32


def _randint(gen, low, high, size):
    return torch.randint(low, high, size, generator=gen, device=gen.device)


def image_bernoulli_mask(gen, shape, p=0.2):
    b, h, w, _ = shape
    return (torch.rand((b, h, w, 1), generator=gen, device=gen.device) < p).float()


def _rect_to_mask(x1, y1, x2, y2, h, w):
    ys = torch.arange(h, device=x1.device)[None, :, None]
    xs = torch.arange(w, device=x1.device)[None, None, :]
    inside = ((ys >= y1[:, None, None]) & (ys <= y2[:, None, None])
              & (xs >= x1[:, None, None]) & (xs <= x2[:, None, None]))
    return (1.0 - inside.float())[..., None]


def _fallback_rectangle(h, w, min_prop, max_prop):
    target = min(max(min_prop, 0.0) + 1e-6, max_prop)
    area = max(1, int(np.ceil(target * h * w)))
    rh = min(h, int(np.ceil(np.sqrt(area))))
    rw = min(w, int(np.ceil(area / rh)))
    return 0, 0, rw - 1, rh - 1


def rectangle_mask(gen, shape, min_prop=0.3, max_prop=1.0):
    """The first of 32 random rectangles whose area is within [min_prop,
    max_prop] of the image, else a fixed valid one; hidden inside."""
    b, h, w, _ = shape
    xs = _randint(gen, 0, w, (b, _CANDIDATES, 2))
    ys = _randint(gen, 0, h, (b, _CANDIDATES, 2))
    x1, x2 = xs.min(-1).values, xs.max(-1).values
    y1, y2 = ys.min(-1).values, ys.max(-1).values
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    valid = (area >= min_prop * h * w) & (area <= max_prop * h * w)
    first = valid.int().argmax(-1, keepdim=True)
    any_valid = valid.any(-1)
    fb = _fallback_rectangle(h, w, min_prop, max_prop)
    pick = lambda v, f: torch.where(any_valid, v.gather(-1, first)[:, 0], f)  # noqa: E731
    return _rect_to_mask(pick(x1, fb[0]), pick(y1, fb[1]), pick(x2, fb[2]), pick(y2, fb[3]),
                         h, w)


def fixed_rectangle_mask(gen, shape, y1, x1, y2, x2):
    b, h, w, _ = shape
    mask = torch.ones(1, h, w, 1, device=gen.device)
    mask[:, y1:y2, x1:x2, :] = 0.0
    return mask.expand(b, h, w, 1)


def square_mask(gen, shape, size):
    """A random ``size`` x ``size`` square, its corner uniform in [0, W - size)
    x [0, H - size)."""
    b, h, w, _ = shape
    x = _randint(gen, 0, w - size, (b,))
    y = _randint(gen, 0, h - size, (b,))
    return _rect_to_mask(x, y, x + size - 1, y + size - 1, h, w)


def _cubic(x, a=-0.5):
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _resample_matrix(in_size, out_size):
    """PIL's bicubic resampling coefficients as an ``[out, in]`` matrix."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    mat = np.zeros((out_size, in_size))
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        wts = _cubic((np.arange(lo, hi) - center + 0.5) / filterscale)
        total = wts.sum()
        mat[xx, lo:hi] = wts / total if total != 0.0 else wts
    return mat


@functools.lru_cache(maxsize=2)
def pattern_canvas(size=2048, resolution=0.06, density=0.25, seed=0):
    """The thresholded bicubic-noise canvas (1 = hidden) and its summed-area
    table."""
    low_size = max(2, int(resolution * size))
    low = np.random.RandomState(seed).uniform(0, 1, size=(low_size, low_size)).astype(np.float32)
    mat = _resample_matrix(low_size, size)
    tmp = (low.astype(np.float64) @ mat.T).astype(np.float32)
    canvas = ((mat @ tmp.astype(np.float64)).astype(np.float32) < density).astype(np.uint8)
    sat = np.zeros((size + 1, size + 1), np.int32)
    sat[1:, 1:] = np.cumsum(np.cumsum(canvas, axis=0, dtype=np.int64), axis=1).astype(np.int32)
    return canvas, sat


def random_pattern_mask(gen, shape, canvas, sat, density=0.25, density_std=0.05):
    """The first of 32 random canvas crops whose hidden share is within
    ``density_std`` of ``density``, else the closest."""
    b, h, w, _ = shape
    size = canvas.shape[-1]
    xs = _randint(gen, 0, size - w + 1, (b, _CANDIDATES))
    ys = _randint(gen, 0, size - h + 1, (b, _CANDIDATES))
    count = sat[ys + h, xs + w] - sat[ys, xs + w] - sat[ys + h, xs] + sat[ys, xs]
    gap = (count.float() / np.float32(h * w) - density).abs()
    valid = gap < density_std
    idx = torch.where(valid.any(-1), valid.int().argmax(-1), gap.argmin(-1))[:, None]
    rows = ys.gather(1, idx)[:, 0][:, None] + torch.arange(h, device=canvas.device)
    cols = xs.gather(1, idx)[:, 0][:, None] + torch.arange(w, device=canvas.device)
    return (1.0 - canvas[rows[:, :, None], cols[:, None, :]].float())[..., None]


def mixture_mask(gen, shape, generators, weights):
    """One component per image, every component drawn batched."""
    b = shape[0]
    wts = torch.tensor(weights, dtype=torch.float32, device=gen.device)
    choice = torch.multinomial(wts / wts.sum(), b, replacement=True, generator=gen)
    masks = torch.stack([g(gen, shape) for g in generators], 1)
    return masks[torch.arange(b, device=gen.device), choice]


_GCF_RECTS = ((26, 17, 58, 36), (26, 29, 58, 48), (26, 15, 37, 50),
              (26, 15, 37, 34), (26, 31, 37, 50), (43, 20, 62, 44))


def celeb_a_mask_fn(device) -> MaskFn:
    """``(generator, [B, 64, 64, C]) -> [B, 64, 64, 1]`` masks, the canvas on
    ``device``."""
    canvas, sat = (torch.from_numpy(t).to(device) for t in pattern_canvas())
    fixed = functools.partial
    siidgm = [fixed(random_pattern_mask, canvas=canvas, sat=sat),
              fixed(image_bernoulli_mask, p=0.2),
              fixed(fixed_rectangle_mask, y1=16, x1=16, y2=48, x2=48),
              fixed(fixed_rectangle_mask, y1=0, x1=0, y2=64, x2=32),
              fixed(fixed_rectangle_mask, y1=0, x1=0, y2=32, x2=64),
              fixed(fixed_rectangle_mask, y1=0, x1=32, y2=64, x2=64),
              fixed(fixed_rectangle_mask, y1=32, x1=0, y2=64, x2=64)]
    siidgm_w = [2, 2, 2, 1, 1, 1, 1]
    gcf = [fixed(fixed_rectangle_mask, y1=a, x1=b, y2=c, x2=d) for a, b, c, d in _GCF_RECTS]
    gens = siidgm + gcf + [rectangle_mask]
    wts = ([1 / 4 * w / sum(siidgm_w) for w in siidgm_w] + [1 / 4 / len(gcf)] * len(gcf)
           + [2 / 4])
    return functools.partial(mixture_mask, generators=gens, weights=wts)


def mnist_mask_fn(device, dim=28) -> MaskFn:
    """Bernoulli(0.5) pixels, the four half images, a random half-size square
    and a random rectangle of 0.3-1 of the image, weights [2, 1, 1, 1, 1, 2, 2]."""
    half, fixed = dim // 2, functools.partial
    gens = [fixed(image_bernoulli_mask, p=0.5),
            fixed(fixed_rectangle_mask, y1=0, x1=0, y2=dim, x2=half),
            fixed(fixed_rectangle_mask, y1=0, x1=0, y2=half, x2=dim),
            fixed(fixed_rectangle_mask, y1=0, x1=half, y2=dim, x2=dim),
            fixed(fixed_rectangle_mask, y1=half, x1=0, y2=dim, x2=dim),
            fixed(square_mask, size=half), rectangle_mask]
    wts = [w / 10 for w in (2, 1, 1, 1, 1, 2, 2)]
    return functools.partial(mixture_mask, generators=gens, weights=wts)


MASKS = {"celeb_a": celeb_a_mask_fn, "CelebAMaskGenerator": celeb_a_mask_fn,
         "mnist": mnist_mask_fn, "MNISTMaskGenerator": mnist_mask_fn}


def mask_fn(name: str, device) -> MaskFn:
    """The mask generator a traffic file names."""
    if name not in MASKS:
        raise KeyError(f"unknown mask generator {name!r}; known: {sorted(MASKS)}")
    return MASKS[name](device)

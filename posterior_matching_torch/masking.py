"""On-device mask generation.

Counterpart of ``posterior_matching_tpu/masking.py`` for the feature-level
generators of PM-VAE (``uniform_mask`` and ``bernoulli_mask``, :58-95) and
for the generators the ``CelebAMaskGenerator`` (:447-452), ``MNISTMaskGenerator``
(:383-401, :460), ``OmniglotMaskGenerator`` and ``Cifar10MaskGenerator``
(:404-413, :464-471) mixtures draw from: random rectangles, fixed
rectangles, random squares, per-pixel Bernoulli, and crops of the
thresholded bicubic noise canvas (``random_pattern_mask``, :242-321, with
``update_freq``'s pool of canvases), flattened into one categorical drawn
per element or, with ``batch_level``, once a batch (:329-376). Every
generator is ``(generator, shape) -> mask`` with an explicit
``torch.Generator`` whose device the mask is drawn on; masks are float32, 1
where a feature is observed: the data's own shape for the feature-level
generators, ``[B, H, W, 1]`` for the image ones. The registry
(:func:`get_mask_generator`) holds every name of the JAX package's, and
refuses any other with its ``KeyError``.

The pattern canvas is rebuilt without PIL: :func:`_bicubic_resize`
reproduces ``PIL.Image.resize(..., BICUBIC)`` on a mode ``F`` image (PIL's
cubic kernel with a = -0.5, its support and rounding rules, a horizontal
pass then a vertical pass, each summed in float64 and stored as float32).
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from posterior_matching_torch import tracing
from posterior_matching_torch.runtime import resolve_device

MaskFn = Callable[[torch.Generator, Sequence[int]], torch.Tensor]

_REJECTION_CANDIDATES = 32


def _image_shape(shape: Sequence[int]) -> Tuple[int, int, int]:
    if len(shape) != 4:
        raise ValueError(f"expected shape [batch, height, width, channels], got {shape}")
    b, h, w, _ = shape
    return b, h, w


def _randint(gen: torch.Generator, low: int, high: int, size) -> torch.Tensor:
    return torch.randint(low, high, size, generator=gen, device=gen.device)


def uniform_mask(
    gen: torch.Generator, shape: Sequence[int],
    bounds: Optional[Tuple[float, float]] = None,
) -> torch.Tensor:
    """Per row, a count ``q`` uniform on ``{0..d-1}`` (with ``bounds``:
    ``int(d lo) + `` uniform on ``{0..int(d hi)-1}``, which can pass ``d
    hi``, as the reference's does), then a uniformly random subset of ``q``
    observed features: those whose iid uniform ranks below ``q``."""
    b, d = shape[0], int(np.prod(shape[1:]))
    if bounds is None:
        q = _randint(gen, 0, d, (b,))
    else:
        q = int(d * bounds[0]) + _randint(gen, 0, int(d * bounds[1]), (b,))
    u = torch.rand((b, d), generator=gen, device=gen.device)
    ranks = torch.argsort(torch.argsort(u, -1), -1)
    return (ranks < q[:, None]).float().reshape(tuple(shape))


def bernoulli_mask(gen: torch.Generator, shape: Sequence[int], p: float = 0.5) -> torch.Tensor:
    """iid Bernoulli(p) per feature."""
    return (torch.rand(tuple(shape), generator=gen, device=gen.device) < p).float()


def image_bernoulli_mask(
    gen: torch.Generator, shape: Sequence[int], p: float = 0.2
) -> torch.Tensor:
    """iid Bernoulli(p) per pixel."""
    b, h, w = _image_shape(shape)
    u = torch.rand((b, h, w, 1), generator=gen, device=gen.device)
    return (u < p).float()


def _rect_to_mask(x1, y1, x2, y2, h: int, w: int) -> torch.Tensor:
    """[B] inclusive rectangle corners -> [B, H, W, 1], 0 inside."""
    ys = torch.arange(h, device=x1.device)[None, :, None]
    xs = torch.arange(w, device=x1.device)[None, None, :]
    inside = (
        (ys >= y1[:, None, None]) & (ys <= y2[:, None, None])
        & (xs >= x1[:, None, None]) & (xs <= x2[:, None, None])
    )
    return (1.0 - inside.float())[..., None]


def _static_valid_rectangle(h, w, min_prop, max_prop):
    """A deterministic in-bounds rectangle for when every candidate fails."""
    target = min(max(min_prop, 0.0) + 1e-6, max_prop)
    area = max(1, int(np.ceil(target * h * w)))
    rh = min(h, int(np.ceil(np.sqrt(area))))
    rw = min(w, int(np.ceil(area / rh)))
    return 0, 0, rw - 1, rh - 1


def rectangle_mask(
    gen: torch.Generator,
    shape: Sequence[int],
    min_prop: float = 0.3,
    max_prop: float = 1.0,
) -> torch.Tensor:
    """Random rectangle with area in [min_prop, max_prop] of the image: the
    first valid of 32 candidates, else a fixed valid rectangle."""
    b, h, w = _image_shape(shape)
    k = _REJECTION_CANDIDATES
    xs = _randint(gen, 0, w, (b, k, 2))
    ys = _randint(gen, 0, h, (b, k, 2))
    x1, x2 = xs.min(-1).values, xs.max(-1).values
    y1, y2 = ys.min(-1).values, ys.max(-1).values
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    valid = (area >= min_prop * h * w) & (area <= max_prop * h * w)
    first = valid.int().argmax(-1, keepdim=True)
    any_valid = valid.any(-1)
    fallback = _static_valid_rectangle(h, w, min_prop, max_prop)

    def pick(v, f):
        return torch.where(any_valid, v.gather(-1, first)[:, 0], f)

    return _rect_to_mask(
        pick(x1, fallback[0]), pick(y1, fallback[1]),
        pick(x2, fallback[2]), pick(y2, fallback[3]), h, w,
    )


def fixed_rectangle_mask(
    gen: torch.Generator, shape: Sequence[int], y1: int, x1: int, y2: int, x2: int
) -> torch.Tensor:
    """Fixed rectangle, exclusive ends."""
    b, h, w = _image_shape(shape)
    mask = torch.ones(1, h, w, 1, device=gen.device)
    mask[:, y1:y2, x1:x2, :] = 0.0
    return mask.expand(b, h, w, 1)


def square_mask(gen: torch.Generator, shape: Sequence[int], size: int) -> torch.Tensor:
    """A random ``size`` x ``size`` square per image, its corner uniform in
    ``[0, W - size) x [0, H - size)`` (``masking.py:178-187``)."""
    b, h, w = _image_shape(shape)
    x = _randint(gen, 0, w - size, (b,))
    y = _randint(gen, 0, h - size, (b,))
    return _rect_to_mask(x, y, x + size - 1, y + size - 1, h, w)


# ---------------------------------------------------------------------------
# Pattern canvas
# ---------------------------------------------------------------------------


def _cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    x = np.abs(x)
    return np.where(
        x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
        np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0),
    )


def _resample_matrix(in_size: int, out_size: int) -> np.ndarray:
    """PIL's bicubic resampling coefficients (``precompute_coeffs``) as an
    ``[out, in]`` float64 matrix."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    mat = np.zeros((out_size, in_size))
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        w = _cubic((np.arange(xmin, xmax) - center + 0.5) / filterscale)
        total = w.sum()
        mat[xx, xmin:xmax] = w / total if total != 0.0 else w
    return mat


def _bicubic_resize(img: np.ndarray, out_size: int) -> np.ndarray:
    """``PIL.Image.fromarray(img, "F").resize((out, out), BICUBIC)``."""
    mh = _resample_matrix(img.shape[1], out_size)
    mv = _resample_matrix(img.shape[0], out_size)
    tmp = (img.astype(np.float64) @ mh.T).astype(np.float32)
    return (mv @ tmp.astype(np.float64)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def pattern_canvas(
    canvas_size: int, resolution: float, density: float, seed: int
) -> Tuple[np.ndarray, np.ndarray]:
    """The thresholded bicubic-noise canvas (uint8, 1 = hidden) and its
    summed-area table (``sat[i, j]`` = ones in ``canvas[:i, :j]``)."""
    low_size = max(2, int(resolution * canvas_size))
    low = np.random.RandomState(seed).uniform(
        0, 1, size=(low_size, low_size)
    ).astype(np.float32)
    canvas = (_bicubic_resize(low, canvas_size) < density).astype(np.uint8)
    sat = np.zeros((canvas_size + 1, canvas_size + 1), np.int32)
    sat[1:, 1:] = np.cumsum(
        np.cumsum(canvas, axis=0, dtype=np.int64), axis=1
    ).astype(np.int32)
    return canvas, sat


def pattern_pool(
    device, canvas_size: int = 2048, resolution: float = 0.06, density: float = 0.25,
    seed: int = 0, num_canvases: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The canvases of seeds ``seed .. seed + num_canvases - 1`` and their
    summed-area tables on ``device``: ``[S, S]`` and ``[S + 1, S + 1]`` for
    one canvas, ``[N, S, S]`` and ``[N, S + 1, S + 1]`` stacked for more.
    A 2048 canvas is 4.2 MB of uint8 and its table 16.8 MB of int32: 21 MB
    of device memory a canvas of the pool."""
    tables = [pattern_canvas(canvas_size, resolution, density, seed + i)
              for i in range(num_canvases)]
    canvas = np.stack([c for c, _ in tables])
    sat = np.stack([t for _, t in tables])
    if num_canvases == 1:
        canvas, sat = canvas[0], sat[0]
    return torch.from_numpy(canvas).to(device), torch.from_numpy(sat).to(device)


def random_pattern_mask(
    gen: torch.Generator,
    shape: Sequence[int],
    canvas: torch.Tensor,
    sat: torch.Tensor,
    density: float = 0.25,
    density_std: float = 0.05,
) -> torch.Tensor:
    """Crops of the pattern canvas with density rejection: the first of 32
    random crops whose hidden share is within ``density_std`` of
    ``density``, else the closest. Candidate densities come from four
    corners of the summed-area table; only the chosen crop is gathered.

    Given a pool of canvases (``canvas [N, S, S]``, ``sat [N, S + 1, S +
    1]`` from :func:`pattern_pool`: ``update_freq``, :func:`pattern_mask`),
    one canvas of the pool, its index uniform and drawn on the device
    before the crops, serves the whole call: the JAX package's stand-in for
    the reference regenerating its canvas every ``update_freq * max_size **
    2`` cropped points (``masking.py:242-272``)."""
    b, h, w = _image_shape(shape)
    dev = canvas.device
    if canvas.dim() == 3:
        pick = _randint(gen, 0, canvas.shape[0], (1,))
        canvas_at = lambda *ix: canvas[(pick, *ix)]
        sat_at = lambda *ix: sat[(pick, *ix)]
    else:
        canvas_at = lambda *ix: canvas[ix]
        sat_at = lambda *ix: sat[ix]
    size = canvas.shape[-1]
    k = _REJECTION_CANDIDATES
    xs = _randint(gen, 0, size - w + 1, (b, k))
    ys = _randint(gen, 0, size - h + 1, (b, k))
    count = (sat_at(ys + h, xs + w) - sat_at(ys, xs + w) - sat_at(ys + h, xs)
             + sat_at(ys, xs))
    coverage = count.float() / np.float32(h * w)
    gap = (coverage - density).abs()
    valid = gap < density_std
    idx = torch.where(
        valid.any(-1), valid.int().argmax(-1), gap.argmin(-1)
    )[:, None]
    x_sel = xs.gather(1, idx)[:, 0]
    y_sel = ys.gather(1, idx)[:, 0]
    rows = y_sel[:, None] + torch.arange(h, device=dev)
    cols = x_sel[:, None] + torch.arange(w, device=dev)
    picked = canvas_at(rows[:, :, None], cols[:, None, :]).float()
    return (1.0 - picked)[..., None]


def pattern_mask(
    device, max_size: int = 10000, resolution: float = 0.06, density: float = 0.25,
    density_std: float = 0.05, canvas_size: int = 2048, canvas_seed: int = 0,
    update_freq: Optional[float] = None, num_canvases: int = 4,
) -> MaskFn:
    """:func:`random_pattern_mask` with the JAX function's keywords
    (``masking.py:242-253``), its tables built on ``device``: one canvas,
    or with ``update_freq`` a pool of ``num_canvases`` (only the option's
    presence matters, as there). ``canvas_size`` plays ``max_size``'s role,
    as in the JAX package."""
    del max_size
    n = num_canvases if update_freq is not None and num_canvases > 1 else 1
    canvas, sat = pattern_pool(device, canvas_size, resolution, density, canvas_seed, n)
    return functools.partial(random_pattern_mask, canvas=canvas, sat=sat, density=density,
                             density_std=density_std)


# ---------------------------------------------------------------------------
# The CelebA mixture
# ---------------------------------------------------------------------------


def mixture_mask(
    gen: torch.Generator,
    shape: Sequence[int],
    generators: Sequence[MaskFn],
    weights: Sequence[float],
    batch_level: bool = False,
) -> torch.Tensor:
    """Every batch element picks a component independently, or with
    ``batch_level`` one component, drawn once, serves the whole batch
    (``masking.py:329-360``); all components are drawn batched and selected
    by index on the device."""
    b = shape[0]
    with tracing.span("sync"):   # the weights copied from the host
        w = torch.tensor(weights, dtype=torch.float32, device=gen.device)
    choice = torch.multinomial(w / w.sum(), 1 if batch_level else b, replacement=True,
                               generator=gen)
    masks = torch.stack([g(gen, shape) for g in generators], 1)
    if batch_level:
        return masks.index_select(1, choice)[:, 0]
    return masks[torch.arange(b, device=gen.device), choice]


def _flatten_mixture(generators, weights):
    """Nested ``(generators, weights)`` specs -> one categorical."""
    flat_g, flat_w = [], []
    total = float(sum(weights))
    for g, w in zip(generators, weights):
        if isinstance(g, tuple):
            for sg, sw in zip(*_flatten_mixture(*g)):
                flat_g.append(sg)
                flat_w.append(w / total * sw)
        else:
            flat_g.append(g)
            flat_w.append(w / total)
    return flat_g, flat_w


def _siidgm_spec(canvas: torch.Tensor, sat: torch.Tensor):
    fixed = functools.partial
    gens = [
        fixed(random_pattern_mask, canvas=canvas, sat=sat),
        fixed(image_bernoulli_mask, p=0.2),
        fixed(fixed_rectangle_mask, y1=16, x1=16, y2=48, x2=48),
        fixed(fixed_rectangle_mask, y1=0, x1=0, y2=64, x2=32),
        fixed(fixed_rectangle_mask, y1=0, x1=0, y2=32, x2=64),
        fixed(fixed_rectangle_mask, y1=0, x1=32, y2=64, x2=64),
        fixed(fixed_rectangle_mask, y1=32, x1=0, y2=64, x2=64),
    ]
    return gens, [2, 2, 2, 1, 1, 1, 1]


# GCF face-part rectangles (y1, x1, y2, x2), exclusive ends.
_GCF_RECTS = (
    (26, 17, 58, 36), (26, 29, 58, 48), (26, 15, 37, 50),
    (26, 15, 37, 34), (26, 31, 37, 50), (43, 20, 62, 44),
)


def celeb_a_mask_spec(
    device: torch.device, canvas_size: int = 2048
) -> Tuple[list, list]:
    """SIIDGM + GCF + rectangle with weights [1, 1, 2], flattened (the
    reference's CelebAMaskGenerator). The pattern canvas lives on
    ``device``."""
    canvas_t, sat_t = pattern_pool(device, canvas_size)
    gcf = (
        [functools.partial(fixed_rectangle_mask, y1=a, x1=b, y2=c, x2=d)
         for a, b, c, d in _GCF_RECTS],
        [1] * len(_GCF_RECTS),
    )
    return _flatten_mixture(
        [_siidgm_spec(canvas_t, sat_t), gcf, rectangle_mask], [1, 1, 2]
    )


def mnist_mask_spec(dim: int = 28, rect_kwargs: Optional[dict] = None,
                    bern_p: float = 0.5) -> Tuple[list, list]:
    """Bernoulli(``bern_p``), four half-image rectangles, a random half-size
    square and a random rectangle (of ``rect_kwargs``), weights [2, 1, 1, 1,
    1, 2, 2] (the reference's MNISTMaskGenerator, ``masking.py:383-401``)."""
    half = dim // 2
    fixed = functools.partial
    gens = [
        fixed(image_bernoulli_mask, p=bern_p),
        fixed(fixed_rectangle_mask, y1=0, x1=0, y2=dim, x2=half),
        fixed(fixed_rectangle_mask, y1=0, x1=0, y2=half, x2=dim),
        fixed(fixed_rectangle_mask, y1=0, x1=half, y2=dim, x2=dim),
        fixed(fixed_rectangle_mask, y1=half, x1=0, y2=dim, x2=dim),
        fixed(square_mask, size=half),
        fixed(rectangle_mask, **(rect_kwargs or {})),
    ]
    return gens, [2, 1, 1, 1, 1, 2, 2]


def omniglot_mask_spec() -> Tuple[list, list]:
    """The MNIST mixture with rectangles of 0.1-0.6 of the image (the
    reference's OmniglotMaskGenerator, ``masking.py:404-406``)."""
    return mnist_mask_spec(28, rect_kwargs=dict(min_prop=0.1, max_prop=0.6))


def cifar10_mask_spec() -> Tuple[list, list]:
    """The MNIST mixture at 32 pixels, Bernoulli(0.3), rectangles of
    0.1-0.5 of the image (the reference's Cifar10MaskGenerator,
    ``masking.py:409-413``)."""
    return mnist_mask_spec(32, rect_kwargs=dict(min_prop=0.1, max_prop=0.5), bern_p=0.3)


def _mixture(spec: Tuple[list, list]) -> MaskFn:
    return functools.partial(mixture_mask, generators=spec[0], weights=spec[1])


# name -> (device, **kwargs) -> mask function (``masking.py:455-476``); as
# there, the Omniglot and CIFAR-10 mixtures take no keyword.
_REGISTRY = {
    "BernoulliMaskGenerator": lambda dev, **kw: functools.partial(bernoulli_mask, **kw),
    "UniformMaskGenerator": lambda dev, **kw: functools.partial(uniform_mask, **kw),
    "ImageBernoulliMaskGenerator":
        lambda dev, **kw: functools.partial(image_bernoulli_mask, **kw),
    "RectangleMaskGenerator": lambda dev, **kw: functools.partial(rectangle_mask, **kw),
    "MNISTMaskGenerator": lambda dev, **kw: _mixture(mnist_mask_spec(**kw)),
    "OmniglotMaskGenerator": lambda dev, **kw: _mixture(omniglot_mask_spec()),
    "Cifar10MaskGenerator": lambda dev, **kw: _mixture(cifar10_mask_spec()),
    "CelebAMaskGenerator": lambda dev, **kw: _mixture(celeb_a_mask_spec(dev, **kw)),
}


def get_mask_generator(name: str, device: Optional[str] = None, **kwargs) -> MaskFn:
    """``(generator, shape) -> mask`` by the reference's generator name and
    keyword arguments (a config's ``mask_generator_kwargs``;
    ``masking.py:479-486``), with its tables on ``device`` (the GPU unless
    ``"cpu"``). An unknown name raises the registry's ``KeyError``, as
    the JAX function does."""
    factory = _REGISTRY[name]
    dev = resolve_device(device)
    # `bounds` may arrive as a list from a JSON round trip.
    if kwargs.get("bounds") is not None:
        kwargs["bounds"] = tuple(kwargs["bounds"])
    return factory(dev, **kwargs)


def add_mask(
    batch: dict, gen: torch.Generator, mask_fn: MaskFn,
    data_key: Optional[str] = None,
) -> dict:
    """Adds ``batch["mask"]``: ``[B, H, W, 1]`` for images, the data's own
    shape for feature vectors."""
    if data_key is None:
        data_key = "image" if "image" in batch else "features"
    x = batch[data_key]
    mask = mask_fn(gen, x.shape)
    if data_key == "image":
        mask = mask.reshape(*x.shape[:-1], 1)
    else:
        mask = mask.reshape(x.shape)
    return {**batch, "mask": mask}


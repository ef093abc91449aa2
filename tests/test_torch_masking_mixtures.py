"""The Omniglot and CIFAR-10 mask mixtures, ``batch_level`` mixtures and the
pattern canvas's ``update_freq`` pool, against the JAX package.

Masks are random, so they are held by distribution, as ``tests/test_masking.py``
holds the JAX generators: each mixture's component shares within 4 binomial
sigma of its weights, and its mean coverage against the JAX generator's.
The deterministic parts (the fixed rectangles, the weights, the pool's
canvases) match exactly, and without the new options the draws are the
parent implementation's bit for bit (its code is copied below).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from posterior_matching_tpu import masking as jax_masking
from posterior_matching_torch import masking
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N = 2048
# weights [2, 1, 1, 1, 1, 2, 2] / 10 (masking.py:383-413)
EXPECTED = {"bernoulli": 0.2, **{f"h{i}": 0.1 for i in range(4)}, "square": 0.2, "rect": 0.2}
SPECS = {
    "OmniglotMaskGenerator": (28, masking.omniglot_mask_spec, jax_masking.omniglot_mask_spec),
    "Cifar10MaskGenerator": (32, masking.cifar10_mask_spec, jax_masking.cifar10_mask_spec),
}


def classify(masks: np.ndarray, dim: int) -> dict:
    """Component shares of ``[N, dim, dim]`` MNIST-like masks: the fixed
    halves exactly, a hidden ``dim / 2`` square box is the square, any
    other hidden box the rectangle, the rest Bernoulli. (A random rectangle
    of exactly the square's shape is counted as the square: a share far
    below a sigma.)"""
    half = dim // 2
    halves = {}
    for i, (y1, x1, y2, x2) in enumerate([(0, 0, dim, half), (0, 0, half, dim),
                                          (0, half, dim, dim), (half, 0, dim, dim)]):
        m = np.ones((dim, dim), np.float32)
        m[y1:y2, x1:x2] = 0
        halves[f"h{i}"] = m
    counts = dict.fromkeys(EXPECTED, 0)
    for m in masks:
        name = next((k for k, f in halves.items() if np.array_equal(m, f)), None)
        if name is None:
            ys, xs = np.nonzero(m == 0)
            box = (m == 0)[ys.min():ys.max() + 1, xs.min():xs.max() + 1] if len(ys) else None
            if box is not None and box.all():
                name = "square" if box.shape == (half, half) else "rect"
            else:
                name = "bernoulli"
        counts[name] += 1
    return {k: v / len(masks) for k, v in counts.items()}


@pytest.mark.parametrize("name", list(SPECS))
def test_mixture_spec_matches_jax(name):
    """The same weights; the fixed rectangles equal mask for mask; the
    random components' keywords are the JAX spec's."""
    dim, port_spec, jax_spec = SPECS[name]
    (pg, pw), (jg, jw) = port_spec(), jax_spec()
    assert pw == jw
    shape = (3, dim, dim, 1)
    for p, j in zip(pg, jg):
        assert p.func.__name__ == j.func.__name__
        assert p.keywords == j.keywords
        if p.func is masking.fixed_rectangle_mask:
            np.testing.assert_array_equal(
                p(torch.Generator(), shape).numpy(),
                np.asarray(j(jax.random.PRNGKey(0), shape)))


@pytest.mark.parametrize("name", list(SPECS))
def test_mixture_shares_and_coverage(name):
    dim = SPECS[name][0]
    fn = masking.get_mask_generator(name, "cpu")
    m = fn(torch.Generator().manual_seed(0), (N, dim, dim, 1))
    assert m.shape == (N, dim, dim, 1) and m.dtype == torch.float32
    got = m[..., 0].numpy()
    assert set(np.unique(got)) <= {0.0, 1.0}
    shares = classify(got, dim)
    for comp, p in EXPECTED.items():
        sigma = np.sqrt(p * (1 - p) / N)
        assert abs(shares[comp] - p) < 4 * sigma, (comp, shares[comp], p)
    want = np.asarray(jax_masking.get_mask_generator(name)(jax.random.PRNGKey(1),
                                                           (N, dim, dim, 1)))[..., 0]
    port_hidden, jax_hidden = 1 - got.mean((1, 2)), 1 - want.mean((1, 2))
    sigma = np.sqrt(port_hidden.var() / N + jax_hidden.var() / N)
    assert abs(port_hidden.mean() - jax_hidden.mean()) < 5 * sigma


def test_registry_holds_every_jax_name():
    for name in jax_masking._REGISTRY:
        assert callable(masking.get_mask_generator(name, "cpu"))


def _ones(gen, shape):
    return torch.ones(tuple(shape))


def _zeros(gen, shape):
    return torch.zeros(tuple(shape))


def test_batch_level_draws_one_component_a_batch():
    """One component for the whole batch, at its weight over batches
    (within 4 binomial sigma); per element (the default) batches mix."""
    calls, p_ones = 400, 0.3
    gen = torch.Generator().manual_seed(2)
    means = np.array([
        float(masking.mixture_mask(gen, (16, 4, 4, 1), [_ones, _zeros],
                                   [p_ones, 1 - p_ones], batch_level=True).mean())
        for _ in range(calls)])
    assert set(np.unique(means)) <= {0.0, 1.0}
    assert abs(means.mean() - p_ones) < 4 * np.sqrt(p_ones * (1 - p_ones) / calls)
    mixed = [float(masking.mixture_mask(gen, (16, 4, 4, 1), [_ones, _zeros], [0.5, 0.5]).mean())
             for _ in range(10)]
    assert any(0.0 < v < 1.0 for v in mixed)
    # the real mixtures too: one component, so every mask of a batch equals
    # the first where the component is fixed, and their shares follow it
    gens, weights = masking.omniglot_mask_spec()
    for seed in range(6):
        m = masking.mixture_mask(torch.Generator().manual_seed(seed), (8, 28, 28, 1), gens,
                                 weights, batch_level=True)[..., 0].numpy()
        kinds = classify(m, 28)
        assert max(kinds.values()) == 1.0, kinds


def test_update_freq_pool_is_uniform_and_the_jax_canvases():
    """A crop as large as the canvas shows which canvas of the pool was
    drawn: over many calls each of 3 is drawn within 4 binomial sigma of
    1/3; the pool's canvases are the seeds the JAX pool builds."""
    size, pool = 64, 3
    fn = masking.pattern_mask("cpu", canvas_size=size, update_freq=1.0, num_canvases=pool)
    canvases = [masking.pattern_canvas(size, 0.06, 0.25, i)[0] for i in range(pool)]
    for i, c in enumerate(canvases):
        assert np.mean(c == jax_masking._PatternCanvas.get(size, 0.06, 0.25, i)) >= 0.999
    gen = torch.Generator().manual_seed(4)
    calls, counts = 600, np.zeros(pool)
    for _ in range(calls):
        m = fn(gen, (2, size, size, 1))[..., 0].numpy()
        hit = [i for i, c in enumerate(canvases) if np.array_equal(m[0], 1.0 - c)]
        assert len(hit) == 1 and np.array_equal(m[0], m[1])
        counts[hit[0]] += 1
    sigma = np.sqrt((1 / pool) * (1 - 1 / pool) / calls)
    assert np.all(np.abs(counts / calls - 1 / pool) < 4 * sigma), counts
    # without update_freq: the first canvas only
    one = masking.pattern_mask("cpu", canvas_size=size)
    m = one(gen, (1, size, size, 1))[0, ..., 0].numpy()
    np.testing.assert_array_equal(m, 1.0 - canvases[0])


# The parent implementation, copied: the defaults must draw what it drew.
def _parent_pattern(gen, shape, canvas, sat, density=0.25, density_std=0.05):
    b, h, w, _ = shape
    size = canvas.shape[0]
    xs = torch.randint(0, size - w + 1, (b, 32), generator=gen)
    ys = torch.randint(0, size - h + 1, (b, 32), generator=gen)
    count = sat[ys + h, xs + w] - sat[ys, xs + w] - sat[ys + h, xs] + sat[ys, xs]
    gap = (count.float() / np.float32(h * w) - density).abs()
    valid = gap < density_std
    idx = torch.where(valid.any(-1), valid.int().argmax(-1), gap.argmin(-1))[:, None]
    x_sel, y_sel = xs.gather(1, idx)[:, 0], ys.gather(1, idx)[:, 0]
    rows = y_sel[:, None] + torch.arange(h)
    cols = x_sel[:, None] + torch.arange(w)
    return (1.0 - canvas[rows[:, :, None], cols[:, None, :]].float())[..., None]


def _parent_mixture(gen, shape, generators, weights):
    w = torch.tensor(weights, dtype=torch.float32)
    choice = torch.multinomial(w / w.sum(), shape[0], replacement=True, generator=gen)
    masks = torch.stack([g(gen, shape) for g in generators], 1)
    return masks[torch.arange(shape[0]), choice]


def test_defaults_draw_what_the_parent_drew():
    canvas, sat = masking.pattern_pool("cpu", 256)
    shape = (6, 32, 32, 1)
    for seed in range(3):
        got = masking.random_pattern_mask(torch.Generator().manual_seed(seed), shape, canvas, sat)
        want = _parent_pattern(torch.Generator().manual_seed(seed), shape, canvas, sat)
        assert torch.equal(got, want)
    parent_spec = (
        [functools.partial(_parent_pattern, canvas=canvas, sat=sat), masking.rectangle_mask,
         functools.partial(masking.image_bernoulli_mask, p=0.2)], [2, 1, 1])
    port_spec = ([functools.partial(masking.random_pattern_mask, canvas=canvas, sat=sat),
                  masking.rectangle_mask, parent_spec[0][2]], [2, 1, 1])
    for seed in range(3):
        got = masking.mixture_mask(torch.Generator().manual_seed(seed), shape, *port_spec)
        want = _parent_mixture(torch.Generator().manual_seed(seed), shape, *parent_spec)
        assert torch.equal(got, want)
    # the MNIST mixture's rectangle, now a partial without keywords
    gens, weights = masking.mnist_mask_spec()
    old = [*gens[:-1], masking.rectangle_mask]
    got = masking.mixture_mask(torch.Generator().manual_seed(5), (64, 28, 28, 1), gens, weights)
    want = _parent_mixture(torch.Generator().manual_seed(5), (64, 28, 28, 1), old, weights)
    assert torch.equal(got, want)

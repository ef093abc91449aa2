"""The port's CelebA mask mixture against the JAX package's.

Masks are random, so the mixture is held by distribution, as
``tests/test_masking.py`` holds the JAX generators: the share of each
component (fixed rectangles are recognised exactly, random rectangles by
shape, Bernoulli and pattern masks by coverage) against the mixture weights,
and the mean coverage against the JAX generator's. The pattern canvas, built
here without PIL, must match the JAX package's PIL-built canvas cell for cell
on at least 99.9% of cells.
"""
import jax
import numpy as np
import pytest
import torch

from posterior_matching_tpu import masking as jax_masking
from posterior_matching_torch import masking
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N = 2048
SHAPE = (N, 64, 64, 3)
SIIDGM_FIXED = [(16, 16, 48, 48), (0, 0, 64, 32), (0, 0, 32, 64), (0, 32, 64, 64), (32, 0, 64, 64)]
GCF_FIXED = [(26, 17, 58, 36), (26, 29, 58, 48), (26, 15, 37, 50),
             (26, 15, 37, 34), (26, 31, 37, 50), (43, 20, 62, 44)]
# flattened weights: SIIDGM [2,2,2,1,1,1,1]/10 x 1/4, GCF 1/6 x 1/4, rect 1/2
EXPECTED = {
    "pattern": 0.05, "bernoulli": 0.05, "rect": 0.5,
    **{f"s{i}": (0.05 if i == 0 else 0.025) for i in range(5)},
    **{f"g{i}": 1 / 24 for i in range(6)},
}


def _rect(y1, x1, y2, x2):
    m = np.ones((64, 64), np.float32)
    m[y1:y2, x1:x2] = 0
    return m


def classify(masks: np.ndarray) -> dict:
    """Component shares of a batch of CelebA-mixture masks [N, 64, 64]."""
    fixed = {f"s{i}": _rect(*r) for i, r in enumerate(SIIDGM_FIXED)}
    fixed.update({f"g{i}": _rect(*r) for i, r in enumerate(GCF_FIXED)})
    counts = dict.fromkeys(EXPECTED, 0)
    for m in masks:
        name = next((k for k, f in fixed.items() if np.array_equal(m, f)), None)
        if name is None:
            hidden = m == 0
            ys, xs = np.nonzero(hidden)
            box = hidden[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
            if box.all():
                name = "rect"
            elif hidden.mean() > 0.6:
                name = "bernoulli"
            else:
                name = "pattern"
        counts[name] += 1
    return {k: v / len(masks) for k, v in counts.items()}


@pytest.fixture(scope="module")
def port_masks():
    mask_fn = masking.get_mask_generator("CelebAMaskGenerator", device="cpu")
    gen = torch.Generator().manual_seed(0)
    m = mask_fn(gen, SHAPE)
    assert m.shape == (N, 64, 64, 1) and m.dtype == torch.float32
    return m[..., 0].numpy()


def test_celeb_a_component_shares(port_masks):
    assert set(np.unique(port_masks)) <= {0.0, 1.0}
    shares = classify(port_masks)
    for name, p in EXPECTED.items():
        sigma = np.sqrt(p * (1 - p) / N)
        assert abs(shares[name] - p) < 5 * sigma, (name, shares[name], p)


def test_celeb_a_coverage_matches_jax(port_masks):
    jax_fn = jax_masking.get_mask_generator("CelebAMaskGenerator")
    want = np.asarray(jax_fn(jax.random.PRNGKey(3), SHAPE))[..., 0]
    port_hidden = 1 - port_masks.mean((1, 2))
    jax_hidden = 1 - want.mean((1, 2))
    # the two means differ by sampling noise only: 5 sigma of the difference
    sigma = np.sqrt(port_hidden.var() / N + jax_hidden.var() / N)
    assert abs(port_hidden.mean() - jax_hidden.mean()) < 5 * sigma
    # pattern crops hold their target density in both
    shares = classify(port_masks)
    pattern = [m for m in port_masks if classify(m[None])["pattern"] == 1]
    assert shares["pattern"] > 0
    assert all(abs((1 - m.mean()) - 0.25) < 0.08 for m in pattern)


@pytest.mark.parametrize("size", [128, 256, 512])
def test_pattern_canvas_matches_pil(size):
    got, sat = masking.pattern_canvas(size, 0.06, 0.25, 0)
    want = jax_masking._PatternCanvas.get(size, 0.06, 0.25, 0)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.mean(got == want) >= 0.999
    assert sat[-1, -1] == int(got.sum())


def test_add_mask_shapes():
    mask_fn = masking.get_mask_generator("CelebAMaskGenerator", device="cpu")
    batch = {"image": torch.zeros(4, 64, 64, 3)}
    out = masking.add_mask(batch, torch.Generator().manual_seed(1), mask_fn)
    assert out["mask"].shape == (4, 64, 64, 1)
    assert out["image"] is batch["image"]


# ---------------------------------------------------------------------------
# The MNIST mixture
# ---------------------------------------------------------------------------

MNIST_SHAPE = (N, 28, 28, 1)
MNIST_HALVES = [(0, 0, 28, 14), (0, 0, 14, 28), (0, 14, 28, 28), (14, 0, 28, 28)]
# weights [2, 1, 1, 1, 1, 2, 2] / 10 (masking.py:383-401)
MNIST_EXPECTED = {"bernoulli": 0.2, **{f"h{i}": 0.1 for i in range(4)},
                  "square": 0.2, "rect": 0.2}


def classify_mnist(masks: np.ndarray) -> dict:
    """Component shares of MNIST-mixture masks [N, 28, 28]: the fixed halves
    exactly, a 14 x 14 hidden box is the square (a random rectangle covers at
    least 0.3 of the image, more than 196 pixels), any other hidden box the
    rectangle, the rest Bernoulli."""
    halves = {}
    for i, (y1, x1, y2, x2) in enumerate(MNIST_HALVES):
        m = np.ones((28, 28), np.float32)
        m[y1:y2, x1:x2] = 0
        halves[f"h{i}"] = m
    counts = dict.fromkeys(MNIST_EXPECTED, 0)
    for m in masks:
        name = next((k for k, f in halves.items() if np.array_equal(m, f)), None)
        if name is None:
            hidden = m == 0
            ys, xs = np.nonzero(hidden)
            box = hidden[ys.min():ys.max() + 1, xs.min():xs.max() + 1] if len(ys) else None
            if box is not None and box.all():
                name = "square" if box.shape == (14, 14) else "rect"
            else:
                name = "bernoulli"
        counts[name] += 1
    return {k: v / len(masks) for k, v in counts.items()}


@pytest.fixture(scope="module")
def mnist_masks():
    mask_fn = masking.get_mask_generator("MNISTMaskGenerator", device="cpu")
    m = mask_fn(torch.Generator().manual_seed(0), MNIST_SHAPE)
    assert m.shape == (N, 28, 28, 1) and m.dtype == torch.float32
    return m[..., 0].numpy()


def test_mnist_component_shares(mnist_masks):
    assert set(np.unique(mnist_masks)) <= {0.0, 1.0}
    shares = classify_mnist(mnist_masks)
    for name, p in MNIST_EXPECTED.items():
        sigma = np.sqrt(p * (1 - p) / N)
        assert abs(shares[name] - p) < 5 * sigma, (name, shares[name], p)


def test_mnist_coverage_matches_jax(mnist_masks):
    jax_fn = jax_masking.get_mask_generator("MNISTMaskGenerator")
    want = np.asarray(jax_fn(jax.random.PRNGKey(3), MNIST_SHAPE))[..., 0]
    port_hidden = 1 - mnist_masks.mean((1, 2))
    jax_hidden = 1 - want.mean((1, 2))
    sigma = np.sqrt(port_hidden.var() / N + jax_hidden.var() / N)
    assert abs(port_hidden.mean() - jax_hidden.mean()) < 5 * sigma
    # both draw the same components in the same shares
    port_shares, jax_shares = classify_mnist(mnist_masks), classify_mnist(want)
    for name, p in MNIST_EXPECTED.items():
        sigma = np.sqrt(2 * p * (1 - p) / N)
        assert abs(port_shares[name] - jax_shares[name]) < 5 * sigma, name


def test_square_mask_range():
    """Corners uniform over [0, 28 - 14): every square lies inside the
    image, and both extreme corners occur."""
    m = masking.square_mask(torch.Generator().manual_seed(2), (4000, 28, 28, 1), 14)[..., 0]
    hidden = (m == 0).numpy()
    assert (hidden.sum((1, 2)) == 196).all()
    rows = hidden.any(2).argmax(1)
    cols = hidden.any(1).argmax(1)
    assert rows.min() == 0 and rows.max() == 13 and cols.min() == 0 and cols.max() == 13


# ---------------------------------------------------------------------------
# PM-VAE's feature-level generators
# ---------------------------------------------------------------------------

FEATURE_CASES = [
    ("BernoulliMaskGenerator", {}, (N, 8)),
    ("BernoulliMaskGenerator", {"p": 0.3}, (N, 21)),
    ("UniformMaskGenerator", {}, (N, 8)),
    # a list, as a JSON round trip gives it; counts int(d lo) + U{0..int(d hi)-1}
    ("UniformMaskGenerator", {"bounds": [0.5, 0.5]}, (N, 10)),
    ("UniformMaskGenerator", {"bounds": (0.0, 0.2)}, (N, 16, 16, 1)),
]


@pytest.mark.parametrize("name,kwargs,shape", FEATURE_CASES,
                         ids=lambda c: str(c) if not isinstance(c, tuple) else None)
def test_feature_masks_match_jax_in_distribution(name, kwargs, shape):
    """Bernoulli and uniform-count masks: the data's own shape, 0/1 values;
    the distribution of observed counts per row within 0.07 of the JAX
    generator's in Kolmogorov-Smirnov distance (2048 rows each: the 0.1%
    critical value is 0.061), the uniform counts over the same range; every
    feature observed at the same rate (a uniformly random subset), within
    five standard errors of the overall rate."""
    gen = torch.Generator().manual_seed(3)
    got = masking.get_mask_generator(name, device="cpu", **kwargs)(gen, shape).numpy()
    want = np.asarray(jax_masking.get_mask_generator(name, **dict(kwargs))(
        jax.random.PRNGKey(3), shape))
    assert got.shape == want.shape == shape and got.dtype == np.float32
    assert set(np.unique(got)) <= {0.0, 1.0}
    d = int(np.prod(shape[1:]))
    counts = lambda m: m.reshape(len(m), -1).sum(1).astype(int)
    cg, cw = counts(got), counts(want)
    cdf = lambda c: np.cumsum(np.bincount(c, minlength=d + 1)) / N
    assert np.abs(cdf(cg) - cdf(cw)).max() < 0.07
    if name == "UniformMaskGenerator":
        assert (cg.min(), cg.max()) == (cw.min(), cw.max())
    rate = got.reshape(N, -1).mean(0)
    p = rate.mean()
    assert np.abs(rate - p).max() < 5 * np.sqrt(p * (1 - p) / N) + 1e-6
    np.testing.assert_allclose(p, want.mean(), atol=0.02)


def test_uniform_mask_bounds_quirk():
    """With bounds the count is ``int(d lo) + randint(0, int(d hi))``, so it
    passes ``d hi``: at d = 10 and bounds (0.5, 0.5) every count in 5..9
    appears, as in the reference."""
    gen = torch.Generator().manual_seed(0)
    m = masking.uniform_mask(gen, (N, 10), bounds=(0.5, 0.5))
    assert sorted(set(m.sum(1).int().tolist())) == [5, 6, 7, 8, 9]

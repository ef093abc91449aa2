"""The port's eval metrics and registry masks against the JAX package's.

- The numpy threefry (``eval/_threefry.py``): ``PRNGKey``, ``split`` and
  32-bit ``bits`` equal to ``jax.random``'s bit for bit, ``uniform`` equal,
  ``normal`` to 1e-6 absolute (XLA's float32 ``log1p`` rounds its last bit
  otherwise than numpy's), the random-conv embedder's five arrays too.
- ``get_inception_embeddings`` against the JAX package's random-conv path
  (``TFHUB_CACHE_DIR`` an empty directory) within 1e-4 of the embeddings'
  scale, at 64x64x3, 28x28x1 (where "SAME" pads 7 -> 4 asymmetrically) and
  16x16x1.
- ``compute_prd`` and ``prd_to_max_f_beta_pair`` (copied numpy) equal to
  1e-12; ``compute_prd_from_embedding`` on well-separated Gaussian blobs,
  as many clusters as blobs, equal to the JAX package's (sklearn's
  MiniBatchKMeans) to 1e-9: both find the blobs, and PRD does not depend on
  how the clusters are numbered.
- ``RectangleMaskGenerator`` and ``ImageBernoulliMaskGenerator`` from the
  registry, with and without keyword arguments, by distribution: the
  observed fraction's mean and quantiles against the JAX generator's.

PRD's cases are ``tests/test_torch_eval_prd.py``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posterior_matching_tpu import masking as jax_masking
from posterior_matching_tpu.eval import embeddings as jax_embeddings
from posterior_matching_torch import masking
from posterior_matching_torch.eval import _threefry, embeddings
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NORMAL_TOL = 1e-6
EMBED_TOL = 1e-4   # of max |embedding|


@pytest.mark.parametrize("seed", [0, 20260816, 2**32 + 5])
def test_threefry_keys_and_bits_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(_threefry.prng_key(seed), np.asarray(key))
    for num in (2, 5):
        np.testing.assert_array_equal(_threefry.split(_threefry.prng_key(seed), num),
                                      np.asarray(jax.random.split(key, num)))
    np.testing.assert_array_equal(_threefry.random_bits(_threefry.prng_key(seed), (3, 5, 7)),
                                  np.asarray(jax.random.bits(key, (3, 5, 7))))
    np.testing.assert_array_equal(_threefry.uniform(_threefry.prng_key(seed), (999,), -2.0, 3.0),
                                  np.asarray(jax.random.uniform(key, (999,), jnp.float32,
                                                                -2.0, 3.0)))


@pytest.mark.parametrize("shape", [(4, 4, 3, 32), (512, 2048), (7,)])
def test_threefry_normal_matches_jax(shape):
    key = jax.random.split(jax.random.PRNGKey(20260816), 5)[4]
    got = _threefry.normal(np.asarray(key), shape)
    want = np.asarray(jax.random.normal(key, shape))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=NORMAL_TOL)


def test_embedder_weights_match_jax():
    kernels, proj = embeddings.random_conv_weights()
    keys = jax.random.split(jax.random.PRNGKey(20260816), 5)
    for k, w, (cin, cout) in zip(keys, kernels, embeddings._DIMS):
        want = jax.random.normal(k, (4, 4, cin, cout)) / np.sqrt(16 * cin)
        np.testing.assert_allclose(w, np.asarray(want), rtol=0, atol=NORMAL_TOL)
    want = jax.random.normal(keys[4], (512, 2048)) / np.sqrt(512)
    np.testing.assert_allclose(proj, np.asarray(want), rtol=0, atol=NORMAL_TOL)


def test_same_padding_is_jax_s():
    assert [embeddings._same_pad(n) for n in (64, 28, 14, 7, 4, 2, 1)] == [
        (1, 1), (1, 1), (1, 1), (1, 2), (1, 1), (1, 1), (1, 2)]


@pytest.fixture
def jax_random_conv(tmp_path, monkeypatch):
    """The JAX embedder with no TF-Hub module on disk: its random-conv path."""
    monkeypatch.setenv("TFHUB_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax_embeddings, "_tfhub_module_cached", lambda: False)
    jax_embeddings._try_tfhub.cache_clear()
    jax_embeddings.embedder_provenance.cache_clear()
    yield jax_embeddings.get_inception_embeddings
    jax_embeddings._try_tfhub.cache_clear()
    jax_embeddings.embedder_provenance.cache_clear()


@pytest.mark.parametrize("shape", [(5, 64, 64, 3), (6, 28, 28, 1), (4, 16, 16, 1)])
def test_embeddings_match_jax(jax_random_conv, shape):
    images = np.random.RandomState(2).rand(*shape).astype(np.float32)
    with pytest.warns(UserWarning, match="random-conv"):
        want = jax_random_conv(images, batch_size=4)
    got = embeddings.get_inception_embeddings(images, batch_size=4, device="cpu")
    assert got.shape == want.shape == (shape[0], 2048) and got.dtype == np.float32
    assert np.abs(got - want).max() <= EMBED_TOL * np.abs(want).max()
    assert embeddings.embedder_provenance() == jax_embeddings.embedder_provenance() \
        == "random_conv"


N = 4096
SHAPE = (N, 16, 16, 1)


def _observed(mask) -> np.ndarray:
    return np.asarray(mask).reshape(N, -1).mean(-1)


@pytest.mark.parametrize("name,kwargs", [
    ("RectangleMaskGenerator", {}), ("RectangleMaskGenerator", {"min_prop": 0.1, "max_prop": 0.5}),
    ("ImageBernoulliMaskGenerator", {}), ("ImageBernoulliMaskGenerator", {"p": 0.7})])
def test_registry_masks_match_jax_by_distribution(name, kwargs):
    fn = masking.get_mask_generator(name, "cpu", **kwargs)
    got = _observed(fn(torch.Generator().manual_seed(0), SHAPE))
    want = _observed(jax_masking.get_mask_generator(name, **kwargs)(jax.random.PRNGKey(0),
                                                                   SHAPE))
    # means agree to 5 sigma of the difference, quantiles to a few pixels
    sigma = np.sqrt(got.var() / N + want.var() / N)
    assert abs(got.mean() - want.mean()) < 5 * sigma + 1e-12
    np.testing.assert_allclose(np.quantile(got, [0.1, 0.25, 0.5, 0.75, 0.9]),
                               np.quantile(want, [0.1, 0.25, 0.5, 0.75, 0.9]), atol=4 / 256)


def test_registry_refuses_unported_generators():
    # every JAX name is ported: an unknown one raises the registry's
    # KeyError, as the JAX package's get_mask_generator does
    with pytest.raises(KeyError, match="NoSuchMaskGenerator"):
        masking.get_mask_generator("NoSuchMaskGenerator", "cpu")
    with pytest.raises(KeyError, match="NoSuchMaskGenerator"):
        jax_masking.get_mask_generator("NoSuchMaskGenerator")
    with pytest.raises(TypeError):
        masking.get_mask_generator("RectangleMaskGenerator", "cpu", size=3)(
            torch.Generator(), (2, 8, 8, 1))

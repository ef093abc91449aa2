"""The port's codebook search against the JAX package's.

``nearest_codebook_indices_plain`` equals the JAX Pallas kernel run through
the interpreter and the XLA path, on seeded latents and on an input with
exact ties (duplicated codes: the lower index wins in all three).
``VQVAE.encoding_indices`` (encoder, pre-VQ conv, search) equals the JAX
module's through ``convert.py``. Indices are compared exactly; the seeded
inputs have no near-ties at float32 rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posterior_matching_tpu.models.vqvae import VQVAE as JaxVQVAE
from posterior_matching_tpu.ops.vq import (
    nearest_codebook_indices_pallas,
    nearest_codebook_indices_xla,
)
from posterior_matching_torch.convert import to_torch, vqvae_state_dict
from posterior_matching_torch.models.vqvae import VQVAE
from posterior_matching_torch.ops.vq import nearest_codebook_indices_plain
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _jax_both(z, cb):
    pallas = nearest_codebook_indices_pallas(jnp.asarray(z), jnp.asarray(cb),
                                             tile_n=128, interpret=True)
    xla = nearest_codebook_indices_xla(jnp.asarray(z), jnp.asarray(cb))
    return np.asarray(pallas), np.asarray(xla)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "exact_ties"])
def test_search_matches_jax(ties):
    rng = np.random.RandomState(1)
    cb = rng.randn(128, 16).astype(np.float32)
    if ties:
        cb[64:] = cb[:64]   # codes k and k + 64 are equal
        z = cb[rng.randint(0, 64, 256)] + 0.01 * rng.randn(256, 16).astype(np.float32)
    else:
        z = rng.randn(256, 16).astype(np.float32)
    got = nearest_codebook_indices_plain(torch.from_numpy(z), torch.from_numpy(cb))
    assert got.dtype == torch.int32
    pallas, xla = _jax_both(z, cb)
    np.testing.assert_array_equal(got.numpy(), xla)
    np.testing.assert_array_equal(got.numpy(), pallas)
    if ties:
        assert (got.numpy() < 64).all()


def test_encoding_indices_match_jax():
    cfg = dict(output_channels=3, embedding_dim=8, num_embeddings=16,
               hidden_units=8, residual_blocks=2, residual_hidden_units=4)
    jm = JaxVQVAE(**cfg)
    x = np.random.RandomState(2).rand(3, 16, 16, 3).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    port = VQVAE(**cfg)
    port.load_state_dict(to_torch(vqvae_state_dict(
        jax.device_get(variables["params"]), jax.device_get(variables["vq_ema"]))))
    want = jm.apply(variables, jnp.asarray(x), method=jm.encoding_indices)
    got = port.encoding_indices(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    z = jm.apply(variables, jnp.asarray(x), method=jm.encode)
    np.testing.assert_allclose(port.encode(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(z), rtol=0, atol=1e-5)
    out = port.vq(port.encode(torch.from_numpy(x)))
    want_vq = jm.apply(variables, z, method=lambda m, z: m.vq(z))
    np.testing.assert_allclose(out["loss"].item(), float(want_vq["loss"]), rtol=1e-5)
    np.testing.assert_allclose(out["perplexity"].item(), float(want_vq["perplexity"]), rtol=1e-5)
    np.testing.assert_allclose(out["quantize"].detach().numpy(),
                               np.asarray(want_vq["quantize"]), rtol=0, atol=1e-6)

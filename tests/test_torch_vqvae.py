"""The port's VQ-VAE decode path and partial encoder against the JAX modules.

Weights go through ``convert.py``, so these also pin the HWIO -> torch
layouts and flax's SAME-padded transposed convolution
(``transpose_kernel=False``), which ``decode_indices`` runs twice. Inputs
are numpy-made; tolerance 1e-5 absolute (float32 convolutions summed in
another order, outputs of order 1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posterior_matching_tpu.models.vqvae import VQVAE as JaxVQVAE
from posterior_matching_tpu.models.vqvae import (
    VQVAEPartialEncoder as JaxPartialEncoder,
)
from posterior_matching_torch.convert import (
    partial_encoder_state_dict,
    to_torch,
    vqvae_state_dict,
)
from posterior_matching_torch.models.vqvae import VQVAE, VQVAEPartialEncoder

ATOL = 1e-5
CFG = dict(
    output_channels=3, embedding_dim=8, num_embeddings=16, hidden_units=8,
    residual_blocks=2, residual_hidden_units=4,
)


@pytest.mark.parametrize("hw", [(16, 16), (12, 20)])
def test_decode_indices_matches_jax(hw):
    jax_model = JaxVQVAE(**CFG)
    x = jnp.zeros((1, *hw, 3))
    variables = jax_model.init(jax.random.PRNGKey(0), x)
    port = VQVAE(**CFG)
    port.load_state_dict(
        to_torch(vqvae_state_dict(variables["params"], variables["vq_ema"]))
    )
    codes = np.random.RandomState(1).randint(0, 16, (3, hw[0] // 4, hw[1] // 4))
    want = jax_model.apply(
        variables, jnp.asarray(codes), method=jax_model.decode_indices
    )
    got = port.decode_indices(torch.from_numpy(codes))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("hw", [(16, 16), (8, 12)])
def test_partial_encoder_matches_jax(hw):
    jax_enc = JaxPartialEncoder(
        conditional_dim=6, hidden_units=8, residual_blocks=2,
        residual_hidden_units=4,
    )
    rng = np.random.RandomState(2)
    x = rng.rand(2, *hw, 3).astype(np.float32)
    b = (rng.rand(2, *hw, 1) > 0.5).astype(np.float32)
    xob = np.concatenate([x * b, b], -1)
    variables = jax_enc.init(jax.random.PRNGKey(0), jnp.asarray(xob))
    port = VQVAEPartialEncoder(
        in_channels=4, image_hw=hw, conditional_dim=6, hidden_units=8,
        residual_blocks=2, residual_hidden_units=4,
    )
    port.load_state_dict(to_torch(partial_encoder_state_dict(variables["params"])))
    want = jax_enc.apply(variables, jnp.asarray(xob))
    got = port(torch.from_numpy(xob))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)

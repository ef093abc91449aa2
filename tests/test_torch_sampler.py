"""The port's row sampler (plain path) against the JAX row-kernel sampler.

Both get the same numpy-drawn Gumbel noise ``[H, W, n, K]``; the JAX side runs
its Pallas kernels in interpret mode, as ``tests/test_sampler_chain.py`` does.
In float32 the samples must be equal and the logits agree to 1e-4 absolute
(float32 rounding along a chain of a few dozen matmuls of width <= 12F). One
case runs at 128 filters, the only width the port's row kernel is built
for, so the plain version that the kernel is held against on the card is
itself held against JAX at that width, with a sample count (9) that leaves
the kernel's 8-sample blocks ragged.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posterior_matching_tpu.models.pixelcnn import PixelCNN as JaxPixelCNN
from posterior_matching_tpu.ops.sampler_chain import pixelcnn_sample_rowkernel
from posterior_matching_torch.convert import pixel_cnn_state_dict, to_torch
from posterior_matching_torch.models.pixelcnn import PixelCNN
from posterior_matching_torch.ops import sampler_chain

LOGITS_ATOL = 1e-4


def _models(num_resnet, num_indices, image_shape, cond_dim, batch, num_filters=8):
    jax_model = JaxPixelCNN(
        num_indices=num_indices, image_shape=image_shape, dropout=0.0,
        num_resnet=num_resnet, num_hierarchies=1, num_filters=num_filters,
    )
    x0 = jnp.zeros((batch, *image_shape), jnp.int32)
    cond = (
        None if cond_dim is None
        else np.random.RandomState(7).randn(batch, cond_dim).astype(np.float32)
    )
    variables = jax_model.init(jax.random.PRNGKey(0), x0, cond)
    port = PixelCNN(
        num_indices=num_indices, image_shape=image_shape, dropout=0.0,
        num_resnet=num_resnet, num_filters=num_filters, conditional_dim=cond_dim,
    )
    port.load_state_dict(to_torch(pixel_cnn_state_dict(variables["params"])))
    return jax_model, variables, port, cond


@pytest.mark.parametrize(
    "num_resnet,cond_dim,num_filters,image_shape,batch",
    [pytest.param(r, c, 8, (5, 6), 2, id=f"{r}-{cid}")
     for r in (1, 3) for c, cid in ((10, "cond"), (None, "uncond"))]
    + [pytest.param(1, 10, 128, (3, 4), 3, id="1-cond-128filters")],
)
def test_plain_sampler_matches_jax_rowkernel(num_resnet, cond_dim, num_filters,
                                             image_shape, batch):
    num_indices, num_samples = 12, 3
    jax_model, variables, port, cond = _models(
        num_resnet, num_indices, image_shape, cond_dim, batch, num_filters
    )
    n = num_samples * (batch if cond is not None else 1)
    noise = np.random.RandomState(3).gumbel(
        size=(*image_shape, n, num_indices)
    ).astype(np.float32)

    js, jl = pixelcnn_sample_rowkernel(
        jax_model, variables["params"], jax.random.PRNGKey(0), num_samples,
        conditional_input=None if cond is None else jnp.asarray(cond),
        interpret=True, noise=jnp.asarray(noise), return_logits=True,
    )
    ts, tl = sampler_chain.pixelcnn_sample(
        port, num_samples,
        None if cond is None else torch.from_numpy(cond),
        noise=torch.from_numpy(noise), return_logits=True,
    )
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOGITS_ATOL)


def test_cpu_wrappers_take_the_plain_path_and_count_nothing():
    _, _, port, cond = _models(1, 12, (3, 4), 10, 1)
    before = (sampler_chain.vrow.launches, sampler_chain.row.launches)
    gen = torch.Generator().manual_seed(0)
    out = sampler_chain.pixelcnn_sample(
        port, 2, torch.from_numpy(cond), generator=gen
    )
    assert out.shape == (2, 1, 3, 4)
    assert int(out.min()) >= 0 and int(out.max()) < 12
    assert (sampler_chain.vrow.launches, sampler_chain.row.launches) == before


def test_sampler_wants_exactly_one_noise_source():
    _, _, port, cond = _models(1, 12, (3, 4), 10, 1)
    with pytest.raises(ValueError, match="exactly one"):
        sampler_chain.pixelcnn_sample(port, 2, torch.from_numpy(cond))

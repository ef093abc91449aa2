"""The port's row sampler (plain path) against the JAX row-kernel sampler.

Both get the same numpy-drawn Gumbel noise ``[H, W, n, K]``; the JAX side runs
its Pallas kernels in interpret mode, as ``tests/test_sampler_chain.py`` does.
In float32 the samples must be equal and the logits agree to 1e-4 absolute
(float32 rounding along a chain of a few dozen matmuls of width <= 12F). Two
cases run at the widths the port's kernels are built for, so the plain
version that the kernels are held against on the card is itself held
against JAX there: 128 filters, with a sample count (9) that leaves the row
kernel's 8-sample blocks ragged, and ``pm_vqvae_digits16``'s geometry (4x4
codes, 64 filters, 128 codes, a 256-wide condition, two resnet levels).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posterior_matching_tpu.models.pixelcnn import PixelCNN as JaxPixelCNN
from posterior_matching_tpu.ops.sampler_chain import pixelcnn_sample_rowkernel
from posterior_matching_torch.convert import pixel_cnn_state_dict, pixel_cnn_tree, to_torch
from posterior_matching_torch.models.pixelcnn import PixelCNN
from posterior_matching_torch.ops import sampler_chain
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LOGITS_ATOL = 1e-4


def _models(num_resnet, num_indices, image_shape, cond_dim, batch, num_filters=8):
    """The JAX PixelCNN, its variables, the port's PixelCNN with the same
    weights and a seeded condition. The weights are the port's seeded
    initialisation carried to JAX by ``convert.pixel_cnn_tree`` (JAX's
    eager ``init`` with a condition takes tens of seconds), its structure
    held against ``jax.eval_shape`` of that ``init``."""
    jax_model = JaxPixelCNN(
        num_indices=num_indices, image_shape=image_shape, dropout=0.0,
        num_resnet=num_resnet, num_hierarchies=1, num_filters=num_filters,
    )
    x0 = jnp.zeros((batch, *image_shape), jnp.int32)
    cond = (
        None if cond_dim is None
        else np.random.RandomState(7).randn(batch, cond_dim).astype(np.float32)
    )
    torch.manual_seed(0)
    port = PixelCNN(
        num_indices=num_indices, image_shape=image_shape, dropout=0.0,
        num_resnet=num_resnet, num_filters=num_filters, conditional_dim=cond_dim,
    )
    variables = {"params": pixel_cnn_tree(port.state_dict())}
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), x0, cond)
    assert (jax.tree.map(lambda a: a.shape, shapes["params"])
            == jax.tree.map(lambda a: a.shape, variables["params"]))
    port.load_state_dict(to_torch(pixel_cnn_state_dict(variables["params"])))
    return jax_model, variables, port, cond


@pytest.mark.parametrize(
    "num_resnet,cond_dim,num_filters,image_shape,batch,num_indices",
    [pytest.param(r, c, 8, (5, 6), 2, 12, id=f"{r}-{cid}")
     for r in (1, 3) for c, cid in ((10, "cond"), (None, "uncond"))]
    + [pytest.param(1, 10, 128, (3, 4), 3, 12, id="1-cond-128filters"),
       pytest.param(2, 256, 64, (4, 4), 2, 128, id="2-cond-digits16")],
)
def test_plain_sampler_matches_jax_rowkernel(num_resnet, cond_dim, num_filters,
                                             image_shape, batch, num_indices):
    num_samples = 3
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

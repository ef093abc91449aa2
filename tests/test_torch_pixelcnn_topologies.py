"""The PixelCNN's other topologies against the JAX module's unfused path.

Two hierarchies at the (3, 3) receptive field on a 4x4 grid (a strided
down-sampling conv and a transposed up-sampling conv in each stack, one
more gated block in the second hierarchy's down pass), and one hierarchy at
(5, 5), each with a condition and without: none of them takes the fused
chain in either package (``fused_chain_topology``, JAX's
``_use_fused_chain``). The JAX side is ``PixelCNN(fused_chain=False)``,
applied to the port's seeded weights carried to its tree by
``convert.pixel_cnn_tree`` (whose structure and shapes are those of JAX's
``init``), its gradients carried back by ``pixel_cnn_state_dict``. At
dropout 0, as ``test_torch_pixelcnn.py``: logits
within 1e-5, the gradient of ``log_prob`` with respect to every parameter
and to the condition within 1e-4 x the gradient's scale. The naive raster
sampler (one full forward a pixel; the hierarchies with a condition, (5, 5)
without) gets the Gumbel noise the JAX ``pixelcnn_sample`` draws from its
key, and its samples must equal JAX's;
``pm_vqvae_impute`` on a hierarchical model (``convert.random_pm_vqvae_
tree``'s weights, the tree of JAX's ``init``) warns, takes that sampler and
equals the JAX ``pm_vqvae_impute`` to 1e-4, as ``test_torch_pm_vqvae.py``
holds the row sampler's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posterior_matching_tpu.models.pixelcnn import PixelCNN as JaxPixelCNN
from posterior_matching_tpu.models.pixelcnn import pixelcnn_sample as jax_pixelcnn_sample
from posterior_matching_tpu.models.pm_vqvae import PMVQVAE as JaxPMVQVAE
from posterior_matching_tpu.models.pm_vqvae import pm_vqvae_impute as jax_pm_vqvae_impute
from posterior_matching_torch import convert
from posterior_matching_torch.models.pixelcnn import (
    PixelCNN, fused_chain_topology, pixelcnn_sample_naive,
)
from posterior_matching_torch.models.pm_vqvae import impute_sampler, pm_vqvae_impute
from test_torch_pm_vqvae import VQ_CONFIG, jax_key_noise
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

COND = 6
TOPOLOGIES = {
    "hier2": dict(num_hierarchies=2, receptive_field_dims=(3, 3)),
    "rf55": dict(num_hierarchies=1, receptive_field_dims=(5, 5)),
}
CASES = [pytest.param(name, cond, id=f"{name}-{'cond' if cond else 'uncond'}")
         for name in TOPOLOGIES for cond in (True, False)]


def _shapes(tree):
    return jax.tree.map(np.shape, tree)


def _case(name, with_cond):
    kw = dict(num_indices=12, image_shape=(4, 4), num_resnet=1, num_filters=8, dropout=0.0,
              **TOPOLOGIES[name])
    rng = np.random.RandomState(0)
    x = rng.randint(0, 12, (3, 4, 4)).astype(np.int32)
    cond = rng.randn(3, COND).astype(np.float32) if with_cond else None
    jm = JaxPixelCNN(fused_chain=False, **kw)
    torch.manual_seed(0)
    port = PixelCNN(**kw, conditional_dim=COND if with_cond else None)
    params = convert.pixel_cnn_tree(port.state_dict())
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x),
                          None if cond is None else jnp.asarray(cond))["params"]
    assert _shapes(params) == jax.tree.map(lambda a: a.shape, want)
    return jm, params, port, x, cond


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("name,with_cond", CASES)
def test_logits_and_gradients_match_jax(name, with_cond):
    jm, params, port, x, cond = _case(name, with_cond)
    assert not fused_chain_topology(port, _t(cond))
    # the JAX tree carries back to the port's state dict as it came
    for key, v in convert.pixel_cnn_state_dict(params).items():
        np.testing.assert_array_equal(v, port.state_dict()[key].numpy(), err_msg=key)

    jc = None if cond is None else jnp.asarray(cond)
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x), jc)
    got = port(torch.from_numpy(x), _t(cond))
    assert got.dtype == torch.float32 and got.shape == want.shape == (3, 4, 4, 12)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    weights = jnp.arange(1.0, 4.0)

    def f(p, c):
        return jnp.sum(jm.apply({"params": p}, jnp.asarray(x), c, method=jm.log_prob) * weights)

    if cond is None:
        jp, jcg = jax.jit(jax.grad(f))(params, None), None
    else:
        jp, jcg = jax.jit(jax.grad(f, argnums=(0, 1)))(params, jc)
    tcond = None if cond is None else torch.tensor(cond, requires_grad=True)
    (port.log_prob(torch.from_numpy(x), tcond) * torch.arange(1.0, 4.0)).sum().backward()
    want_g = convert.pixel_cnn_state_dict(jax.device_get(jp))
    grads = dict(port.named_parameters())
    assert set(want_g) == set(grads)
    for key, w in want_g.items():
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(grads[key].grad.numpy(), w, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=key)
    if cond is not None:
        np.testing.assert_allclose(tcond.grad.numpy(), np.asarray(jcg), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(jcg).max()))


@pytest.mark.parametrize("name,with_cond", [CASES[0], CASES[3]])
def test_naive_sampler_matches_jax(name, with_cond):
    jm, params, port, _, cond = _case(name, with_cond)
    key, num_samples = jax.random.PRNGKey(7), 2
    n = num_samples * (3 if with_cond else 1)
    want = jax_pixelcnn_sample(
        lambda codes, c: jm.apply({"params": params}, codes, c), key, num_samples, (4, 4),
        conditional_input=None if cond is None else jnp.asarray(cond))
    noise = jax_key_noise(key, 4, 4, n, 12).reshape(16, n, 12)
    got = pixelcnn_sample_naive(port, num_samples, _t(cond), noise=torch.from_numpy(noise))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pm_vqvae_impute_takes_the_naive_sampler():
    pc_config = {"image_shape": [4, 4], "num_resnet": 1, "num_hierarchies": 2,
                 "num_filters": 8, "dropout": 0.0, "num_indices": 16}
    model = JaxPMVQVAE.from_config(COND, VQ_CONFIG, pc_config)
    rng = np.random.RandomState(0)
    x = rng.rand(2, 16, 16, 3).astype(np.float32)
    b = (rng.rand(2, 16, 16, 1) > 0.5).astype(np.float32)
    params, state = convert.random_pm_vqvae_tree(COND, VQ_CONFIG, pc_config, seed=0)
    variables = {"params": params, **state}
    want_shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(x), jnp.asarray(b),
        method=lambda m, x, b: (m(x, b, training=False),
                                m.decode_code_samples(jnp.zeros((1, 2, 4, 4), jnp.int32)))))
    assert _shapes(variables) == jax.tree.map(lambda a: a.shape, want_shapes)
    key = jax.random.PRNGKey(5)
    with pytest.warns(UserWarning, match="naive full-forward raster sampler"):
        want = np.asarray(jax_pm_vqvae_impute(model, variables, jnp.asarray(x),
                                              jnp.asarray(b), key, num_samples=2))
    host = jax.tree.map(np.asarray, variables)
    port = convert.pm_vqvae_from_jax(host["params"], {"vq_ema": host["vq_ema"]}, COND,
                                     VQ_CONFIG, pc_config, device="cpu")
    assert impute_sampler(port.pixel_cnn, "cuda") == ("naive", None)
    with pytest.raises(ValueError, match="naive sampler"):
        impute_sampler(port.pixel_cnn, "cpu", "bfloat16")
    noise = torch.from_numpy(jax_key_noise(key, 4, 4, 4, 16))
    with pytest.warns(UserWarning, match="naive full-forward raster sampler"):
        got = pm_vqvae_impute(port, torch.from_numpy(x), torch.from_numpy(b), 2, noise=noise)
    assert got.shape == want.shape == (2, 2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)

"""The port's fused ``PosteriorMatchingVDVAE`` against the JAX package's
``fused_chain="interpret"`` on ``tests/test_decoder_chain.py``'s geometry (split
from ``tests/test_torch_decoder_chain.py``, whose models it uses, so that the
suite's workers run its interpret-mode JAX compile beside the rest).

The JAX normals are recorded from a jitted unfused JAX run by an ordered
debug callback (the fused JAX run draws the same bits through each block's
own ``make_rng("sample")``): values rtol 2e-4 (atol 2e-4), gradients rtol
5e-3, atol 1e-4, that file's tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posterior_matching_torch import convert
from posterior_matching_torch.train.trainer import pm_vdvae_loss
from posterior_matching_tpu.distributions import normal as jax_normal
from posterior_matching_tpu.models.vdvae import PosteriorMatchingVDVAE as JaxVDVAE
from test_torch_decoder_chain import (  # noqa: F401 (fixtures)
    KW,
    models,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture
def record(monkeypatch):
    """The JAX side's standard normals in call order (a jitted ``apply`` of
    the unfused model, each draw sent out by an ordered debug callback: one
    posterior sample per decoder block; the same bits as an eager apply, in
    a quarter of its time)."""
    store = []

    def diag_sample(self, key, sample_shape=()):
        eps = jax.random.normal(key, tuple(sample_shape) + self.loc.shape, self.loc.dtype)
        jax.debug.callback(lambda e: store.append(np.array(e)), eps, ordered=True)
        return self.loc + self.scale_diag * eps

    monkeypatch.setattr(jax_normal.MultivariateNormalDiag, "sample", diag_sample)
    return store


def _jax_loss(model, x, b):
    def f(params):
        out = model.apply({"params": params}, x, b, rngs={"sample": jax.random.PRNGKey(7)})
        return -jnp.mean(out["reconstruction_ll"] - out["kl"]) + jnp.mean(out["pm_kl"]), out
    return f


def test_fused_model_matches_jax_fused(models, record):
    tree, fused, _, x, b = models
    jax.jit(_jax_loss(JaxVDVAE(fused_chain=False, **KW), x, b))(tree)   # records the normals
    jax.effects_barrier()
    assert len(record) == 9
    eps = [torch.from_numpy(np.array(e)) for e in record]
    (loss_j, out_j), grads_j = jax.jit(jax.value_and_grad(
        _jax_loss(JaxVDVAE(fused_chain="interpret", **KW), x, b), has_aux=True))(tree)

    out = fused(torch.from_numpy(x), torch.from_numpy(b), iter(eps))
    for key in ("reconstruction_ll", "kl", "pm_kl"):
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(out_j[key]),
                                   rtol=2e-4, atol=2e-4, err_msg=key)
    names, params = zip(*fused.named_parameters())
    loss = pm_vdvae_loss(fused, {"image": torch.from_numpy(x), "mask": torch.from_numpy(b)},
                         iter(eps))
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=2e-4)
    want = convert.pm_vdvae_state_dict(jax.device_get(grads_j))
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name], rtol=5e-3, atol=1e-4, err_msg=name)

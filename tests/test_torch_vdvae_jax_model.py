"""The port's PM-VDVAE against the JAX package's on the tiny hierarchy, with
the JAX side's recorded normals (split from ``tests/test_torch_vdvae.py``,
whose models, recording and tolerances it uses, so that the suite's workers
run its JAX applies beside the rest): the forward's outputs, one imputation,
one pass of the decoder log-likelihoods, and the training step's loss and
gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from posterior_matching_torch import convert
from posterior_matching_torch.train.trainer import pm_vdvae_loss
from test_torch_vdvae import (  # noqa: F401 (fixtures)
    MODE_TOL,
    _noise,
    models,
    record,
    t,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_forward_matches_jax(models, record):
    jm, tree, port, x, b = models
    want = jax.jit(lambda p: jm.apply({"params": p}, x, b,
                                      rngs={"sample": jax.random.PRNGKey(2)}))(tree)
    jax.effects_barrier()
    assert len(record) == 6   # one posterior sample per decoder block
    with torch.no_grad():
        got = port(t(x), t(b), _noise(record))
    for k in ("reconstruction_ll", "kl", "pm_kl"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=MODE_TOL, err_msg=k)
    assert got["reconstruction"].shape == x.shape


def test_impute_once_matches_jax(models, record):
    jm, tree, port, x, b = models
    v = {"params": tree}
    macts = jm.apply(v, x, b, method=jm.encode_masked)
    px_z = jm.apply(v, macts, method=lambda m, a: m.decoder.forward_partial_posterior(a),
                    rngs={"sample": jax.random.PRNGKey(3)})
    eps = list(record)
    want = np.asarray(jm.apply(v, x, b, macts, method=jm.impute_once,
                               rngs={"sample": jax.random.PRNGKey(3)}))
    with torch.no_grad():
        pmacts = port.encode_masked(t(x), t(b))
        for res in macts:
            np.testing.assert_allclose(pmacts[res].numpy(), np.asarray(macts[res]),
                                       rtol=MODE_TOL, atol=MODE_TOL)
        got_px = port.decoder.forward_partial_posterior(pmacts, _noise(eps))
        got = port.impute_once(t(x), t(b), pmacts, _noise(eps)).numpy()
        unrounded = port.decoder.out_net(got_px).mean_unrounded().numpy()
    scale = float(np.abs(px_z).max())
    np.testing.assert_allclose(got_px.numpy(), np.asarray(px_z), rtol=MODE_TOL,
                               atol=MODE_TOL * scale)
    # the stitched values: observed pixels exact, the rest equal but where
    # the unrounded mean sits on a rounding boundary
    obs = np.broadcast_to(b == 1, x.shape)
    np.testing.assert_array_equal(got[obs], x[obs])
    safe = np.abs(unrounded % 1 - 0.5) > 1e-2
    np.testing.assert_array_equal(got[safe], want[safe])


def test_decode_lls_once_matches_jax(models, record):
    jm, tree, port, x, b = models
    v = {"params": tree}
    acts, macts = jm.apply(v, x, b, method=jm.encode_pair)
    want = jm.apply(v, x, b, acts, macts, method=jm.decode_lls_once,
                    rngs={"sample": jax.random.PRNGKey(4)})
    assert len(record) == 12  # posterior, then masked posterior, per block
    with torch.no_grad():
        pa, pma = port.encode_pair(t(x), t(b))
        got = port.decode_lls_once(t(x), t(b), pa, pma, _noise(record))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=MODE_TOL)


def test_training_step_matches_jax_grad(models, record):
    """The loss of ``train_pm_vdvae.py:135-150`` and its gradient with
    respect to every parameter, with the same normals (the jitted gradient
    records them)."""
    jm, tree, port, x, b = models

    def loss_fn(params):
        out = jm.apply({"params": params}, x, b, rngs={"sample": jax.random.PRNGKey(8)})
        return -jnp.mean(out["reconstruction_ll"] - out["kl"]) + jnp.mean(out["pm_kl"])

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(tree)
    jax.effects_barrier()
    assert len(record) == 6
    want = convert.pm_vdvae_state_dict(jax.device_get(grads_j))
    names, params = zip(*port.named_parameters())
    loss = pm_vdvae_loss(port, {"image": t(x), "mask": t(b)}, _noise(record), True)
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        w = want[name]
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * scale, err_msg=name)

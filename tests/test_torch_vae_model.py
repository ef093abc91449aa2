"""The port's PM-VAE models (the UCI MLP and the conv families) against the
JAX package's, with the JAX side's recorded draws (split from
``tests/test_torch_vae.py``, whose helpers and tolerances it uses, so that
the suite's workers run its JAX applies beside the rest): the forward, the
imputation, the importance-sampled log-likelihood, the expected information
gains, the training loss's gradients and an optimizer step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import train_pm_vae as jax_train
from ml_collections import ConfigDict

from posterior_matching_torch import convert
from posterior_matching_torch.models import heads
from posterior_matching_torch.train.optim import ClippedAdam
from posterior_matching_torch.train.schedules import exponential_decay
from posterior_matching_torch.train.trainer import pm_vae_loss_fn
from posterior_matching_tpu.distributions import normal as jax_normal
from posterior_matching_tpu.distributions.normal import MultivariateNormalDiag as JaxDiag
from posterior_matching_tpu.distributions.normal import MultivariateNormalTriL as JaxTriL
from posterior_matching_tpu.models import heads as jax_heads
from posterior_matching_tpu.models.vae import PosteriorMatchingVAE as JaxVAE
from test_torch_vae import (
    BETA,
    _data,
    GRAD_TOL,
    MODELS,
    TOL,
    apply,
    close,
    flat,
    init_shapes,
    randomize,
    t,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    cfg, shape = MODELS[request.param]
    x, b = _data(shape)
    jm = JaxVAE.from_config(cfg)
    params = randomize(init_shapes(jm, x, b), 7, std=0.2)
    port = convert.pm_vae_from_jax(params, cfg, device="cpu")
    assert port.data_shape == shape
    return request.param, jm, params, port, x, b


@pytest.fixture
def record(monkeypatch):
    """The JAX side's standard normals in call order, handed out by an
    ordered callback (under ``jit`` as well)."""
    store = []

    def keep(eps):
        jax.debug.callback(lambda e: store.append(np.array(e)), eps, ordered=True)
        return eps

    def eps_of(self, key, sample_shape):
        return keep(jax.random.normal(key, tuple(sample_shape) + self.loc.shape, self.loc.dtype))

    def tril_sample(self, key, sample_shape=()):
        eps = eps_of(self, key, sample_shape)
        return self.loc + jnp.einsum("...ij,...j->...i", self.scale_tril, eps,
                                     precision=jax.lax.Precision.HIGHEST)

    monkeypatch.setattr(JaxTriL, "sample", tril_sample)
    monkeypatch.setattr(JaxDiag, "sample",
                        lambda self, key, sample_shape=(): self.loc + self.scale_diag * eps_of(
                            self, key, sample_shape))
    monkeypatch.setattr(jax_normal.Normal, "sample",
                        lambda self, key, sample_shape=(): self.loc + self.scale * eps_of(
                            self, key, sample_shape))
    return store


@pytest.fixture
def agmm_samples(monkeypatch):
    """Replaces both packages' autoregressive GMM samples with one tensor
    of the requested shape (normals from a fixed seed)."""
    def draw(sample_shape, self_b, d):
        rng = np.random.RandomState(11)
        return rng.randn(*sample_shape, self_b, d).astype(np.float32)

    monkeypatch.setattr(jax_heads.AutoregressiveGMM, "sample", lambda self, key, sample_shape=():
                        jnp.asarray(draw(sample_shape, self.context.shape[0], self.event_size)))
    monkeypatch.setattr(heads.AutoregressiveGMM, "sample", lambda self, noise, sample_shape=():
                        t(draw(sample_shape, self.context.shape[0], self.event_size)))


def _noise(store):
    return iter([t(e) for e in store])


def test_forward_matches_jax(model, record):
    kind, jm, params, port, x, b = model
    want = jax.block_until_ready(apply(jm, params, x, b, key=jax.random.PRNGKey(2)))
    assert len(record) == 1
    with torch.no_grad():
        got = port(t(x), t(b), _noise(record))
    for k in ("reconstruction_ll", "kl", "matching_ll"):
        close(got[k], want[k], what=k)


def test_impute_matches_jax(model, record, agmm_samples):
    kind, jm, params, port, x, b = model
    want = jax.block_until_ready(apply(jm, params, x, b, num_samples=4, method=jm.impute,
                                       key=jax.random.PRNGKey(3)))
    with torch.no_grad():
        got = port.impute(t(x), t(b), _noise(record), num_samples=4)
    close(got, want, what="impute")
    observed = np.broadcast_to(b[None] != 0, got.shape)
    np.testing.assert_array_equal(got.numpy()[observed],
                                  np.broadcast_to((x * b)[None], got.shape)[observed])


def test_is_log_prob_matches_jax(model, record, agmm_samples):
    kind, jm, params, port, x, b = model
    want = jax.block_until_ready(apply(jm, params, x, b, num_samples=6, method=jm.is_log_prob,
                                       key=jax.random.PRNGKey(4)))
    with torch.no_grad():
        got = port.is_log_prob(t(x), t(b), _noise(record), num_samples=6)
    close(got[0], want[0], what="log p(x)")
    close(got[1], want[1], what="log p(x_u | x_o)")


def test_expected_info_gains_match_jax(model, record):
    kind, jm, params, port, x, b = model
    gains = lambda: apply(jm, params, x[0], b[0], num_samples=5,
                          method=jm.expected_info_gains, key=jax.random.PRNGKey(5))
    if kind == "conv_agmm":
        with pytest.raises(NotImplementedError):
            gains()
        with pytest.raises(NotImplementedError), torch.no_grad():
            port.expected_info_gains(t(x[0]), t(b[0]), torch.Generator().manual_seed(0), 5)
        return
    want = np.asarray(gains())
    with torch.no_grad():
        got = port.expected_info_gains(t(x[0]), t(b[0]), _noise(record), num_samples=5).numpy()
    observed = b[0].reshape(-1) != 0
    assert np.all(np.isneginf(got[observed])) and np.all(np.isneginf(want[observed]))
    close(got[~observed], want[~observed], what="info gains")


def _train_config(cfg, weight_decay=1e-5):
    return {"model": cfg, "beta": dict(BETA), "matching_coef": 0.7,
            "lr_schedule": {"init_value": 0.01, "decay_rate": 0.9, "transition_steps": 3},
            "weight_decay": weight_decay}


def test_loss_gradients_match_jax_build_loss_fn(model, record):
    """The JAX CLI's loss at step 6 (beta 0.8, matching_coef 0.7) and its
    gradient with respect to every parameter, with the same normals (an
    eager call records them; the jitted gradient draws the same from the
    same key)."""
    kind, jm, params, port, x, b = model
    config = _train_config(dict(MODELS[kind][0]))
    data_key = "features" if kind == "uci" else "image"
    batch = {data_key: x, "mask": b}
    loss_fn = jax_train.build_loss_fn(jm, ConfigDict(config), data_key)
    key = jax.random.PRNGKey(6)
    f = lambda p: loss_fn(p, {}, key, 6, batch, True)[:2]
    (loss_j, aux_j), grads_j = jax.block_until_ready(
        jax.jit(jax.value_and_grad(f, has_aux=True))(params))
    assert len(record) == 1
    want = flat(grads_j)
    names, ps = zip(*port.named_parameters())
    loss, metrics = pm_vae_loss_fn(config, data_key)(
        port, {data_key: t(x), "mask": t(b)}, _noise(record), True, 6)
    grads = torch.autograd.grad(loss, ps)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=TOL)
    np.testing.assert_allclose(metrics["beta"].item(), float(aux_j["beta"]), rtol=1e-7)
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        close(g, want[name], tol=GRAD_TOL, what=name)


def test_optimizer_step_matches_jax_build_optimizer(model):
    """One update of every parameter from the same gradients, by the port's
    chain (``ClippedAdam`` without a clip) and the JAX CLI's optax chain, at
    a weight decay of 0.1 so that the decay mask shows; the scalar
    ``log_scale`` of the UCI model's likelihood head is decayed on both
    sides, the biases on neither."""
    kind, jm, params, port, x, b = model
    config = _train_config(dict(MODELS[kind][0]), weight_decay=0.1)
    tx, schedule = jax_train.build_optimizer(ConfigDict(config))
    grads = randomize(params, 8, std=1.0)
    upd, _ = jax.jit(lambda g, p: tx.update(g, tx.init(p), p))(grads, params)
    want = flat(jax.tree_util.tree_map(lambda p, u: p + u, params, upd))
    tp = {n: p.detach().clone() for n, p in port.named_parameters()}
    opt = ClippedAdam(tp, exponential_decay(**config["lr_schedule"]), None, 0.1)
    opt.step({n: t(g) for n, g in flat(grads).items()})
    assert set(tp) == set(want)
    for name, p in tp.items():
        close(p, want[name], what=name)
    if kind == "uci":
        assert tp["decoder_dist.log_scale"].ndim == 0
        sd = flat(params)
        moved = lambda n: float(np.abs(tp[n].numpy() - sd[n]).max())
        assert moved("decoder_dist.log_scale") > 0

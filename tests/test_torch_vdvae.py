"""The port's PM-VDVAE against the JAX package's, on a tiny hierarchy.

One seeded tree (``convert.random_pm_vdvae_tree``, non-zero everywhere) and
the same numpy images and masks go through both packages. The JAX side's
standard normals are recorded by replacing ``MultivariateNormalDiag.sample``
and ``MultivariateNormalTriL.sample`` in this test only (eager ``apply``),
and handed to the port in the same order.

Tolerances: the distributions' values within 1e-5 relative and gradients
within 1e-5 of each gradient's scale (the JAX side solves by unrolled
substitution with a hand-written adjoint, the port by LAPACK and autograd);
the model's modes within 1e-4 relative (twenty-odd float32 convolutions and
a triangular solve per block, summed in another order); the training step's
loss within 1e-5 relative and its gradients within 1e-4 of each gradient's
scale; the optimizer within 1e-6 relative of optax after three updates.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from posterior_matching_tpu.distributions import _math as jax_math
from posterior_matching_tpu.distributions import logistic as jax_logistic
from posterior_matching_tpu.distributions import normal as jax_normal
from posterior_matching_tpu.models.vdvae import PosteriorMatchingVDVAE as JaxVDVAE
from posterior_matching_torch import convert
from posterior_matching_torch.distributions import (
    MultivariateNormalDiag,
    MultivariateNormalTriL,
    QuantizedLogisticMixture,
    fill_scale_tril,
    kl_diag_tril,
)
from posterior_matching_torch.models.vdvae import (
    get_width_settings,
    parse_layer_string,
    vdvae_impute,
    vdvae_is_log_probs,
)
from posterior_matching_torch.train.optim import ClippedAdam
from posterior_matching_torch.train.schedules import linear_schedule
from posterior_matching_torch.train.trainer import pm_vdvae_loss
from posterior_matching_torch.utils import logmeanexp

TINY_CONFIG = {
    "image_shape": (8, 8, 1),
    "encoder_blocks": "8x2,8d2,4x1,4d4,1x1",
    "decoder_blocks": "1x1,4m1,4x1,8m4,8x2",
    "latent_dim": 4,
    "width": 16,
    "bottleneck_multiple": 0.25,
    "no_bias_above": 64,
    "num_mixtures": 3,
}
MODE_TOL = 1e-4


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ---------------------------------------------------------------------------
# Distributions
# ---------------------------------------------------------------------------


def _tril_case(seed, batch=(3, 5), k=4):
    rng = np.random.RandomState(seed)
    raw = rng.randn(*batch, k * (k + 1) // 2).astype(np.float32) * 0.5
    loc_p, loc_q = rng.randn(2, *batch, k).astype(np.float32)
    scale_p = np.exp(0.3 * rng.randn(*batch, k)).astype(np.float32)
    return raw, loc_p, scale_p, loc_q


def test_fill_scale_tril_matches_jax():
    raw = _tril_case(0)[0]
    want = np.asarray(jax_math.fill_scale_tril(jnp.asarray(raw), 4))
    np.testing.assert_allclose(fill_scale_tril(t(raw), 4).numpy(), want, rtol=1e-5, atol=1e-7)


def test_kl_diag_tril_values_and_gradients_match_jax():
    raw, loc_p, scale_p, loc_q = _tril_case(1)

    def jax_kl(loc_p, scale_p, loc_q, raw):
        return jax_math.kl_diag_tril(loc_p, scale_p, loc_q, jax_math.fill_scale_tril(raw, 4))

    args = [jnp.asarray(a) for a in (loc_p, scale_p, loc_q, raw)]
    want = np.asarray(jax_kl(*args))
    wgrads = jax.grad(lambda *a: jnp.sum(jax_kl(*a) * jnp.arange(1.0, 16.0).reshape(3, 5)),
                      argnums=(0, 1, 2, 3))(*args)
    leaves = [t(a).requires_grad_(True) for a in (loc_p, scale_p, loc_q, raw)]
    got = kl_diag_tril(*leaves[:3], fill_scale_tril(leaves[3], 4))
    grads = torch.autograd.grad((got * torch.arange(1.0, 16.0).reshape(3, 5)).sum(), leaves)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)
    for g, w in zip(grads, wgrads):   # 1e-5 of the gradient's scale
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_normals_log_prob_and_kl_match_jax():
    raw, loc_p, scale_p, loc_q = _tril_case(2)
    x = np.random.RandomState(3).randn(3, 5, 4).astype(np.float32)
    tril = jax_math.fill_scale_tril(jnp.asarray(raw), 4)
    jq = jax_normal.MultivariateNormalTriL(jnp.asarray(loc_q), tril)
    jp = jax_normal.MultivariateNormalDiag(jnp.asarray(loc_p), jnp.asarray(scale_p))
    q = MultivariateNormalTriL(t(loc_q), fill_scale_tril(t(raw), 4))
    p = MultivariateNormalDiag(t(loc_p), t(scale_p))
    np.testing.assert_allclose(q.log_prob(t(x)).numpy(), np.asarray(jq.log_prob(jnp.asarray(x))),
                               rtol=1e-5)
    np.testing.assert_allclose(p.log_prob(t(x)).numpy(), np.asarray(jp.log_prob(jnp.asarray(x))),
                               rtol=1e-5)
    p2 = jax_normal.MultivariateNormalDiag(jnp.asarray(loc_q), jnp.asarray(scale_p[::-1].copy()))
    np.testing.assert_allclose(
        p.kl_divergence(MultivariateNormalDiag(t(loc_q), t(scale_p[::-1]))).numpy(),
        np.asarray(jp.kl_divergence(p2)), rtol=1e-5)
    np.testing.assert_allclose(p.kl_divergence(q).numpy(), np.asarray(jp.kl_divergence(jq)),
                               rtol=1e-5)


@pytest.mark.parametrize("channels", [1, 3])
def test_dmol_log_prob_and_mean_match_jax(channels):
    rng = np.random.RandomState(channels)
    m, shape = 3, (2, 5, 6)
    logits = rng.randn(*shape, m).astype(np.float32)
    locs = np.tanh(rng.randn(*shape, m, channels)).astype(np.float32)
    scales = (np.exp(rng.randn(*shape, m, channels) - 3)).astype(np.float32)
    coeffs = (np.tanh(rng.randn(*shape, m, 3)).astype(np.float32) if channels == 3 else None)
    # pixels on both edge bins and in the middle
    x = rng.randint(0, 256, (*shape, channels)).astype(np.float32)
    x[0, 0, :2] = 0.0
    x[0, 1, :2] = 255.0
    jd = jax_logistic.QuantizedLogisticMixture(
        jnp.asarray(logits), jnp.asarray(locs), jnp.asarray(scales),
        None if coeffs is None else jnp.asarray(coeffs), num_channels=channels)
    d = QuantizedLogisticMixture(t(logits), t(locs), t(scales),
                                 None if coeffs is None else t(coeffs), num_channels=channels)
    for indep in (True, False):
        np.testing.assert_allclose(d.log_prob(t(x), independent=indep).numpy(),
                                   np.asarray(jd.log_prob(jnp.asarray(x), independent=indep)),
                                   rtol=1e-5)
    # the rounded mean equals JAX's away from rounding boundaries
    unrounded = d.mean_unrounded().numpy()
    safe = np.abs(unrounded % 1 - 0.5) > 1e-3
    np.testing.assert_array_equal(d.mean().numpy()[safe], np.asarray(jd.mean())[safe])


def test_dmol_unrounded_mean_matches_jax_formula(monkeypatch):
    """``mean_unrounded`` against the JAX ``mean`` with ``jnp.round``
    replaced by the identity, in this test only."""
    rng = np.random.RandomState(9)
    logits = rng.randn(4, 3, 5).astype(np.float32)
    locs = np.tanh(rng.randn(4, 3, 5, 3)).astype(np.float32)
    coeffs = np.tanh(rng.randn(4, 3, 5, 3)).astype(np.float32)
    scales = np.ones_like(locs)
    jd = jax_logistic.QuantizedLogisticMixture(jnp.asarray(logits), jnp.asarray(locs),
                                               jnp.asarray(scales), jnp.asarray(coeffs),
                                               num_channels=3)
    monkeypatch.setattr(jax_logistic.jnp, "round", lambda a: a)
    want = np.asarray(jd.mean())
    d = QuantizedLogisticMixture(t(logits), t(locs), t(scales), t(coeffs), num_channels=3)
    np.testing.assert_allclose(d.mean_unrounded().numpy(), want, rtol=1e-5, atol=1e-4)


def test_layer_string_helpers():
    assert parse_layer_string("28x2,28d2,3m1") == [(28, None), (28, None), (28, 2), (3, 1)]
    widths = get_width_settings(128, "28:64,14:96")
    assert widths[28] == 64 and widths[14] == 96 and widths[7] == 128


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, (2, 8, 8, 1)).astype(np.float32)
    b = rng.binomial(1, 0.7, (2, 8, 8, 1)).astype(np.float32)
    tree = convert.random_pm_vdvae_tree(TINY_CONFIG, seed=4)
    port = convert.pm_vdvae_from_jax(tree, TINY_CONFIG, device="cpu")
    return JaxVDVAE.from_config(TINY_CONFIG), tree, port, x, b


@pytest.fixture
def record(monkeypatch):
    """Records the JAX side's standard normals in call order, where they are
    concrete (eager ``apply``; under ``jit`` they are traced and the same
    keys draw the same normals)."""
    store = []

    def keep(eps):
        if not isinstance(eps, jax.core.Tracer):
            store.append(np.asarray(eps))

    def diag_sample(self, key, sample_shape=()):
        eps = jax.random.normal(key, tuple(sample_shape) + self.loc.shape, self.loc.dtype)
        keep(eps)
        return self.loc + self.scale_diag * eps

    def tril_sample(self, key, sample_shape=()):
        eps = jax.random.normal(key, tuple(sample_shape) + self.loc.shape, self.loc.dtype)
        keep(eps)
        return self.loc + jnp.einsum("...ij,...j->...i", self.scale_tril, eps,
                                     precision=jax.lax.Precision.HIGHEST)

    monkeypatch.setattr(jax_normal.MultivariateNormalDiag, "sample", diag_sample)
    monkeypatch.setattr(jax_normal.MultivariateNormalTriL, "sample", tril_sample)
    return store


def _noise(store):
    return iter([t(e) for e in store])


def test_random_tree_has_the_jax_structure_and_no_zeros(models):
    jm, tree, _, x, b = models
    init = jax.eval_shape(jm.init, {"params": jax.random.PRNGKey(0),
                                    "sample": jax.random.PRNGKey(1)}, x, b)
    shapes = lambda tr: jax.tree_util.tree_map(lambda a: tuple(a.shape), tr)
    assert shapes(init["params"]) == shapes(tree)
    assert all(np.all(a != 0) for a in jax.tree_util.tree_leaves(tree))


def test_forward_matches_jax(models, record):
    jm, tree, port, x, b = models
    want = jm.apply({"params": tree}, x, b, rngs={"sample": jax.random.PRNGKey(2)})
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


def test_sample_is_in_range(models):
    _, _, port, _, _ = models
    with torch.no_grad():
        s = port.sample(3, torch.Generator().manual_seed(0))
    assert s.shape == (3, 8, 8, 1) and s.min() >= 0 and s.max() <= 255


def test_pm_kl_gradient_only_reaches_the_masked_path(models):
    """pm_kl sees the posterior through a stop-gradient
    (``tests/test_vdvae.py:67``): no gradient reaches the full encoder."""
    _, _, port, x, b = models
    out = port(t(x), t(b), torch.Generator().manual_seed(3))
    names, params = zip(*port.named_parameters())
    grads = torch.autograd.grad(out["pm_kl"].mean(), params, allow_unused=True)
    norm = lambda prefix: sum(float(g.abs().sum()) for n, g in zip(names, grads)
                              if n.startswith(prefix) and g is not None)
    assert norm("encoder.") == 0.0
    assert norm("masked_encoder.") > 0.0


# ---------------------------------------------------------------------------
# The multi-sample entry points (inside the port: JAX's lax.scan draws its own
# keys)
# ---------------------------------------------------------------------------


def test_vdvae_impute_is_repeated_impute_once(models):
    _, _, port, x, b = models
    got = vdvae_impute(port, t(x), t(b), 3, generator=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        macts = port.encode_masked(t(x), t(b))
        want = torch.stack([port.impute_once(t(x), t(b), macts, gen) for _ in range(3)], 1)
    assert got.shape == (2, 3, 8, 8, 1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    obs = (t(b) == 1).expand_as(t(x))
    for s in range(3):
        torch.testing.assert_close(got[:, s][obs], t(x)[obs], rtol=0, atol=0)


@pytest.mark.parametrize("chunk", [None, 8, 3])
def test_vdvae_is_log_probs_is_logmeanexp_of_decode_lls_once(models, chunk):
    """Without a chunk, or with one that holds the batch, one pass; with 3,
    the 4 instances run as chunks [0, 1, 2] and [3, 0, 1] (padded with the
    first instances), each chunk drawing its noise after the one before."""
    _, _, port, x, b = models
    x4, b4 = t(np.concatenate([x, x[::-1]])), t(np.concatenate([b, b[::-1]]))
    px, ac = vdvae_is_log_probs(port, x4, b4, 4, batch_chunk=chunk,
                                generator=torch.Generator().manual_seed(6))
    gen = torch.Generator().manual_seed(6)
    chunks = [(x4, b4)] if chunk in (None, 8) else [
        (x4[:3], b4[:3]), (torch.cat([x4[3:], x4[:2]]), torch.cat([b4[3:], b4[:2]]))]
    want_px, want_ac = [], []
    with torch.no_grad():
        for xc, bc in chunks:
            acts, macts = port.encode_pair(xc, bc)
            lls = [port.decode_lls_once(xc, bc, acts, macts, gen) for _ in range(4)]
            p = logmeanexp(torch.stack([a for a, _ in lls]))
            po = logmeanexp(torch.stack([o for _, o in lls]))
            want_px.append(p)
            want_ac.append(p - po)
    assert px.shape == ac.shape == (4,)
    torch.testing.assert_close(px, torch.cat(want_px)[:4], rtol=0, atol=0)
    torch.testing.assert_close(ac, torch.cat(want_ac)[:4], rtol=0, atol=0)
    assert torch.isfinite(px).all() and torch.isfinite(ac).all()


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def test_training_step_matches_jax_grad(models, record):
    """The loss of ``train_pm_vdvae.py:135-150`` and its gradient with
    respect to every parameter, with the same normals (an eager forward
    records them; the jitted gradient draws the same from the same key)."""
    jm, tree, port, x, b = models

    def loss_fn(params):
        out = jm.apply({"params": params}, x, b, rngs={"sample": jax.random.PRNGKey(8)})
        return -jnp.mean(out["reconstruction_ll"] - out["kl"]) + jnp.mean(out["pm_kl"])

    loss_fn(tree)
    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(tree)
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


def test_clipped_adam_matches_optax():
    """``ClippedAdam`` against the optax chain of ``train_pm_vdvae.py:
    175-181`` on the same gradients, with a weight decay and a warm-up so
    that the decay mask and the schedule are exercised; the second update's
    gradients have a global norm above the clip, the others below."""
    rng = np.random.RandomState(11)
    params = {"k": rng.randn(3, 4).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
    grads = [{n: (s * rng.randn(*p.shape)).astype(np.float32) for n, p in params.items()}
             for s in (1.0, 300.0, 2.0)]
    schedule = optax.linear_schedule(0.0, 1e-2, 2)
    tx = optax.chain(
        optax.clip_by_global_norm(200.0), optax.scale_by_adam(),
        optax.add_decayed_weights(0.1, mask=lambda p: jax.tree.map(lambda x: x.ndim != 1, p)),
        optax.scale_by_schedule(schedule), optax.scale(-1.0))
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    state = tx.init(jp)
    tp = {n: t(v) for n, v in params.items()}
    opt = ClippedAdam(tp, linear_schedule(0.0, 1e-2, 2), 200.0, 0.1)
    for g in grads:
        upd, state = tx.update({n: jnp.asarray(v) for n, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step({n: t(v) for n, v in g.items()})
        for n in params:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), rtol=1e-6, atol=1e-7,
                                       err_msg=n)
    assert opt.count == 3

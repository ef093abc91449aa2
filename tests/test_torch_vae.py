"""The port's PM-VAE against the JAX package's, on the CPU at toy widths.

- Every network and head against flax at 1e-5 of scale, on the same
  weights (random, biases too): residual MLPs with and without LayerNorm,
  a conv encoder ending at 4x4 (the heads flatten it in NHWC order), conv
  decoders with k = 5, s = 2 transposed convs (SAME padding (3, 2)), and
  all six heads; ``conv_transpose_padding`` against ``lax``'s own.
- ``GMM1D.sample`` with the JAX side's component draws and normals handed
  over exactly; ``AutoregressiveGMM.sample``, whose JAX loop draws inside
  ``fori_loop``, by its consistency with the teacher-forced conditionals of
  ``log_prob`` and in distribution against JAX samples.
- ``PosteriorMatchingVAE`` on three toy models (UCI-style MLPs with a TriL
  partial posterior; a conv model with the autoregressive GMM partial
  posterior; a conv model with a TriL one): the forward's three outputs,
  ``impute``, ``is_log_prob`` and ``expected_info_gains`` at 1e-5 of scale
  with the JAX side's standard normals recorded by replacing the
  distributions' ``sample`` and handed to the port as an iterator; the
  autoregressive GMM's samples, which cannot be recorded, are replaced on
  both sides by the same tensor.
- The loss of the JAX CLI's ``build_loss_fn`` and its gradients within
  1e-4 of scale; one optimizer step against ``build_optimizer`` within
  1e-5 of scale (the weight decay on every tensor but the 1-D ones, the
  scalar ``log_scale`` included); the beta schedules against
  ``get_beta_schedule``; the initial tree's structure against the JAX
  init's.

The models' cases against JAX (forward, imputation, log-likelihood, info
gains, the loss's gradients, an optimizer step) are
``tests/test_torch_vae_model.py``'s.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

os.environ.setdefault("PM_TPU_COMPILE_CACHE", "0")
import train_pm_vae as jax_train  # noqa: E402
from posterior_matching_tpu.distributions import mixture as jax_mixture  # noqa: E402
from posterior_matching_tpu.distributions import normal as jax_normal  # noqa: E402
from posterior_matching_tpu.distributions.normal import (  # noqa: E402
    MultivariateNormalDiag as JaxDiag,
)
from posterior_matching_tpu.distributions.normal import (  # noqa: E402
    MultivariateNormalTriL as JaxTriL,
)
from posterior_matching_tpu.models import heads as jax_heads  # noqa: E402
from posterior_matching_tpu.models import networks as jax_networks  # noqa: E402
from posterior_matching_tpu.models.vae import PosteriorMatchingVAE as JaxVAE  # noqa: E402
from posterior_matching_tpu.train.schedules import get_beta_schedule as jax_beta  # noqa: E402
from posterior_matching_torch import convert  # noqa: E402
from posterior_matching_torch.distributions import GMM1D, MultivariateNormalDiag  # noqa: E402
from posterior_matching_torch.models import heads, networks  # noqa: E402
from posterior_matching_torch.train.optim import ClippedAdam  # noqa: E402
from posterior_matching_torch.train.schedules import (  # noqa: E402
    exponential_decay,
    get_beta_schedule,
)
from posterior_matching_torch.train.trainer import pm_vae_loss_fn  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5       # forward values, relative to the tensor's scale
GRAD_TOL = 1e-4  # gradients, relative to the tensor's scale


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


def randomize(tree, seed, std=0.3):
    """A tree of the structure and shapes of ``tree`` (arrays or shape
    structs) with every leaf drawn N(0, std^2) (biases too, so their paths
    are tested)."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(std * rng.randn(*a.shape), np.float32), tree)


def init_shapes(jm, *args):
    """The shapes of a flax module's parameters, traced, not computed."""
    keys = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}
    return jax.eval_shape(jm.init, keys, *args).get("params", {})


def apply(jm, params, *args, method=None, key=None, **kwargs):
    """``jm.apply`` jitted (one compile, not one per op), with ``key`` as
    the ``sample`` stream."""
    rngs = None if key is None else {"sample": key}
    f = lambda p, *a: jm.apply({"params": p}, *a, method=method, rngs=rngs, **kwargs)
    return jax.jit(f)(params, *args)


def flat(tree):
    return convert.pm_vae_state_dict(jax.device_get(tree))


# ---------------------------------------------------------------------------
# Networks and heads
# ---------------------------------------------------------------------------

NETWORKS = [
    ("ResidualMLP", {"residual_blocks": 2, "hidden_units": 16}, (5,)),
    ("ResidualMLP", {"residual_blocks": 1, "hidden_units": 16, "layer_norm": True,
                     "dropout": 0.5, "activate_final": False}, (6,)),
    ("ConvEncoder", {"conv_layers": [(4, 3, 1), (8, 5, 2), (8, 1, 1)]}, (8, 8, 2)),
    ("ConvEncoder", {"conv_layers": [(4, 5, 1), (4, 5, 2), (8, 7, 1)]}, (14, 14, 1)),
    ("ConvDecoder", {"conv_layers": [(8, 4, 1), (4, 5, 2), (1, 3, 1)]}, (3,)),
    ("ConvDecoder", {"conv_layers": [(4, 7, 1), (4, 5, 2), (2, 5, 1), (1, 5, 2)]}, (3,)),
]


@pytest.mark.parametrize("kind,cfg,in_shape", NETWORKS,
                         ids=[f"{k}-{i}" for i, (k, _, _) in enumerate(NETWORKS)])
def test_network_matches_flax(kind, cfg, in_shape):
    x = np.random.RandomState(0).randn(3, *in_shape).astype(np.float32)
    jm = jax_networks.get_network(kind, dict(cfg))
    params = randomize(init_shapes(jm, x), 1)
    want = apply(jm, params, x)
    port = networks.get_network(kind, dict(cfg), in_shape)
    port.load_state_dict(convert.to_torch(flat(params)))
    assert tuple(port.out_shape) == want.shape[1:]
    with torch.no_grad():
        close(port(t(x)), want, what=kind)


@pytest.mark.parametrize("k,s", [(k, s) for k in range(1, 9) for s in (1, 2, 3)])
def test_conv_transpose_padding_is_lax_s(k, s):
    from jax._src.lax.convolution import _conv_transpose_padding

    for padding in ("SAME", "VALID"):
        assert networks.conv_transpose_padding(k, s, padding) == \
            tuple(_conv_transpose_padding(k, s, padding))


HEADS = [
    ("Bernoulli", {}, (4, 4, 1)),
    ("IdentityGaussian", {"event_size": 5}, (6,)),
    ("DiagonalGaussian", {"event_size": 3}, (4, 4, 3)),
    ("TriLGaussian", {"event_size": 4}, (4, 4, 3)),
    ("OneDimensionalGMM", {"event_size": 3, "num_components": 2}, (6,)),
    ("AutoregressiveGMM", {"event_size": 3, "num_components": 2, "residual_blocks": 1,
                           "hidden_units": 8}, (4, 4, 2)),
]


@pytest.mark.parametrize("kind,cfg,in_shape", HEADS, ids=[h[0] for h in HEADS])
def test_head_matches_flax(kind, cfg, in_shape):
    """The distribution's parameters, ``log_prob`` at a value, and its mean
    and entropy where it has them; features with H, W > 1 are flattened in
    NHWC order."""
    rng = np.random.RandomState(2)
    x = rng.randn(3, *in_shape).astype(np.float32)
    if kind == "Bernoulli":
        value = (rng.rand(*x.shape) > 0.5).astype(np.float32)
    else:
        value = rng.randn(3, cfg["event_size"]).astype(np.float32)
    gaussian = kind in ("IdentityGaussian", "DiagonalGaussian", "TriLGaussian")

    def values(dist, prior):
        out = {"log_prob": dist.log_prob(value_of(value))}
        if kind != "AutoregressiveGMM":
            out["mean"] = dist.mean()
        if gaussian:
            out["entropy"] = dist.entropy()
        if kind == "TriLGaussian":
            out["scale_tril"] = dist.scale_tril
            out["kl"] = dist.kl_divergence(prior)
        return out

    jm = jax_heads.get_distribution(kind, dict(cfg))
    params = randomize(init_shapes(jm, x), 3)
    value_of = jnp.asarray
    want = jax.jit(lambda p: values(jm.apply({"params": p}, x),
                                    JaxDiag(jnp.zeros(4), jnp.ones(4))))(params)
    port = heads.get_distribution(kind, dict(cfg), in_shape)
    port.load_state_dict(convert.to_torch(flat(params)))
    value_of = t
    with torch.no_grad():
        got = values(port(t(x)), MultivariateNormalDiag(torch.zeros(4), torch.ones(4)))
    assert set(got) == set(want)
    for k in got:
        close(got[k], want[k], what=k)
    if kind == "AutoregressiveGMM":
        with pytest.raises(NotImplementedError):
            port(t(x)).entropy()


def test_gmm1d_sample_matches_jax_with_its_draws():
    """The JAX sample's component indices and normals (from its two keys)
    handed to the port's ``sample`` give the JAX sample."""
    rng = np.random.RandomState(4)
    logits, means = rng.randn(2, 5, 3).astype(np.float32), rng.randn(2, 5, 3).astype(np.float32)
    scales = np.exp(rng.randn(2, 5, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)

    def draws(key):
        k_comp, k_norm = jax.random.split(key)
        return (jax_mixture.GMM1D(logits, means, scales).sample(key, (4,)),
                jax.random.categorical(k_comp, logits, axis=-1, shape=(4, 2, 5)),
                jax.random.normal(k_norm, (4, 2, 5)))

    want, comp, eps = jax.jit(draws)(key)
    got = GMM1D(t(logits), t(means), t(scales)).sample(
        iter([torch.from_numpy(np.array(comp)), t(eps)]), (4,))
    close(got, want, what="sample")
    # and from a generator: the right shape, finite
    drawn = GMM1D(t(logits), t(means), t(scales)).sample(torch.Generator().manual_seed(0), (4,))
    assert drawn.shape == (4, 2, 5) and torch.isfinite(drawn).all()


AGMM = {"event_size": 3, "num_components": 3, "residual_blocks": 1, "hidden_units": 8}


@pytest.fixture(scope="module")
def agmm():
    x = np.random.RandomState(5).randn(2, 4).astype(np.float32)
    jm = jax_heads.get_distribution("AutoregressiveGMM", dict(AGMM))
    params = randomize(init_shapes(jm, x), 6, std=0.5)
    port = heads.get_distribution("AutoregressiveGMM", dict(AGMM), (4,))
    port.load_state_dict(convert.to_torch(flat(params)))
    return jm.apply({"params": params}, x), port(t(x))


def test_agmm_sample_follows_its_teacher_forced_conditionals(agmm):
    """Each dimension of a sample is its step's component mean plus scale
    times the normal it was given, where the step's mixture is the one
    ``log_prob``'s batched forward gives that dimension at the sample."""
    _, dist = agmm
    d, n, b = AGMM["event_size"], 5, 2
    g = torch.Generator().manual_seed(1)
    comps = [torch.randint(0, AGMM["num_components"], (n, b), generator=g) for _ in range(d)]
    eps = [torch.randn(n, b, generator=g) for _ in range(d)]
    draws = [a for pair in zip(comps, eps) for a in pair]
    with torch.no_grad():
        x = dist.sample(iter(draws), (n,))
        assert x.shape == (n, b, d)
        masks = (torch.arange(d)[None, :] < torch.arange(d)[:, None]).float()
        v = x[..., None, :]
        ctx = dist.context[..., None, :].expand(n, b, d, dist.context.shape[-1])
        gmm = heads._agmm_net_out(dist.net_params, v * masks, masks.expand(n, b, d, d), ctx, d,
                                  AGMM["num_components"])
        for i in range(d):
            c = comps[i][..., None]
            mu = gmm.means[:, :, i, i].gather(-1, c)[..., 0]
            sd = gmm.scales[:, :, i, i].gather(-1, c)[..., 0]
            close(x[..., i], mu + sd * eps[i], what=f"dim {i}")
        # the sum of the steps' log-likelihoods is log_prob's
        lls = gmm.log_prob(v)
        close(dist.log_prob(x), torch.diagonal(lls, dim1=-2, dim2=-1).sum(-1), what="log_prob")


def test_agmm_sample_matches_jax_in_distribution(agmm):
    """4000 draws on each side: per-dimension means within five standard
    errors, standard deviations within 10%, and the correlation of the
    first two dimensions within 0.1."""
    want_d, dist = agmm
    n = 4000
    want = np.asarray(jax.jit(lambda d: d.sample(jax.random.PRNGKey(9), (n,)))(want_d))
    with torch.no_grad():
        got = dist.sample(torch.Generator().manual_seed(9), (n,)).numpy()
    assert got.shape == want.shape == (n, 2, AGMM["event_size"])
    se = want.std(0) / np.sqrt(n)
    assert np.all(np.abs(got.mean(0) - want.mean(0)) < 5 * np.sqrt(2) * se)
    np.testing.assert_allclose(got.std(0), want.std(0), rtol=0.1)
    corr = lambda a: np.corrcoef(a[:, 0, 0], a[:, 0, 1])[0, 1]
    assert abs(corr(got) - corr(want)) < 0.1


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

UCI = {
    "latent_dim": 4, "encoder_net": "ResidualMLP", "decoder_net": "ResidualMLP",
    "decoder_dist": "IdentityGaussian", "posterior_dist": "TriLGaussian",
    "decoder_dist_config": {"event_size": 5},
    "masked_posterior_dist": "AutoregressiveGMM",
    "masked_posterior_config": {"hidden_units": 8, "residual_blocks": 3},
    "encoder_net_config": {"residual_blocks": 2, "hidden_units": 16, "layer_norm": True},
    "decoder_net_config": {"residual_blocks": 1, "hidden_units": 16, "layer_norm": True},
    "matching_ll_stop_gradients": True,
}
_CONV = {
    "latent_dim": 3, "encoder_net": "ConvEncoder", "decoder_net": "ConvDecoder",
    "posterior_dist": "TriLGaussian", "decoder_dist": "Bernoulli",
    "encoder_net_config": {"conv_layers": [(4, 3, 1), (8, 5, 2), (8, 1, 1)]},
    "decoder_net_config": {"conv_layers": [(8, 4, 1), (4, 5, 2), (1, 3, 1)]},
}
CONV_AGMM = {**_CONV, "partial_posterior_dist": "AutoregressiveGMM",
             "partial_posterior_dist_config": {"num_components": 3, "residual_blocks": 1,
                                               "hidden_units": 8}}
CONV_TRIL = dict(_CONV)
MODELS = {"uci": (UCI, (5,)), "conv_agmm": (CONV_AGMM, (8, 8, 1)),
          "conv_tril": (CONV_TRIL, (8, 8, 1))}


BETA = {"schedule": "cyclic", "low_value": 0.0, "high_value": 1.0, "period": 10, "delay": 2}


@pytest.mark.parametrize("cfg", [
    None, {},
    dict(BETA),
    {"schedule": "cyclic", "low_value": 0.2, "high_value": 0.9, "period": 7, "delay": 0},
    {"schedule": "monotonic", "low_value": 0.0, "high_value": 1.0, "transition_steps": 20,
     "transition_begin": 5},
    {"schedule": "monotonic", "low_value": 0.5, "high_value": 1.0, "transition_steps": 0,
     "transition_begin": 0},
], ids=["none", "empty", "cyclic", "cyclic-no-delay", "monotonic", "monotonic-constant"])
def test_beta_schedule_matches_jax(cfg):
    got, want = get_beta_schedule(cfg), jax_beta(cfg)
    for step in range(0, 60):
        np.testing.assert_allclose(got(step), float(want(jnp.asarray(step))), rtol=1e-6,
                                   atol=1e-7, err_msg=str(step))


def _data(shape, seed=0, n=3):
    rng = np.random.RandomState(seed)
    if len(shape) == 1:
        x = rng.randn(n, *shape).astype(np.float32)
    else:
        x = (rng.rand(n, *shape) > 0.5).astype(np.float32)
    b = (rng.rand(n, *shape) > 0.4).astype(np.float32)
    return x, b


@pytest.mark.parametrize("kind", list(MODELS))
def test_init_tree_has_the_jax_structure(kind):
    """The tree of ``init_pm_vae_tree`` has the JAX init's paths and shapes,
    kernels drawn (not zero, spread about 1/sqrt(fan_in)) and biases and
    ``log_scale`` zero, as the JAX init makes them."""
    cfg, shape = MODELS[kind]
    x, b = _data(shape)
    init = init_shapes(JaxVAE.from_config(cfg), x, b)
    tree = convert.init_pm_vae_tree(cfg, seed=3)
    shapes = lambda tr: jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), tr)
    assert shapes(init) == shapes(tree)
    for name, a in flat(tree).items():
        if name.endswith("kernel") or name.endswith("_w"):
            fan_in = int(np.prod(a.shape[:-1]))
            assert 0.5 < a.std() * np.sqrt(fan_in) < 1.2 and np.abs(a).max() <= 2 / np.sqrt(fan_in)
        else:
            assert not np.any(a), name


def test_dropout_keeps_its_rate_and_scale():
    x = torch.ones(200, 500)
    out = networks.dropout(x, 0.3, torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.005
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 1 / 0.7))
    assert networks.dropout(x, 0.0, None) is x
    with pytest.raises(ValueError):
        networks.dropout(x, 0.5, None)


def test_training_noise_is_added_in_training_only():
    """PM-VAE's prologue: the training one adds ``training_noise`` times
    standard normals to ``features`` and draws the mask; the validation
    one only draws the mask (``datasets.py:429-465``)."""
    from posterior_matching_torch.masking import get_mask_generator
    from posterior_matching_torch.train.trainer import pm_vae_prologue

    data = {"training_noise": 0.001}
    mask_fn = get_mask_generator("BernoulliMaskGenerator", "cpu")
    x = torch.randn(4096, 8)
    train = pm_vae_prologue(data, mask_fn, True)({"features": x}, torch.Generator().manual_seed(0))
    val = pm_vae_prologue(data, mask_fn, False)({"features": x}, torch.Generator().manual_seed(0))
    noise = train["features"] - x
    assert abs(noise.std().item() - 0.001) < 2e-5 and abs(noise.mean().item()) < 2e-5
    assert torch.equal(val["features"], x)
    for out in (train, val):
        assert out["mask"].shape == x.shape and abs(out["mask"].mean().item() - 0.5) < 0.01

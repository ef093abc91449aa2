"""The port's lookahead posterior and acquisition engine against the JAX
package's, on the CPU at toy widths.

- ``LookaheadPosterior``'s training log-likelihood on a conv PM-VAE of
  4x4 images (16 features) and an MLP one of 6 features, with the JAX
  side's draws recorded and handed to the port in its order (the partial
  posterior's normals, the subsampled feature indices, the one-step
  normals): values at 1e-5 of scale, the gradient of its negated mean
  within 1e-4 of scale on the ``lookahead_*`` parameters and zero on the
  PM-VAE's on both sides; an instance whose subsampled features are all
  observed scores 0. ``expected_info_gains`` (no draws) at 1e-5 of scale,
  ``-inf`` where the mask observes.
- ``train_lookahead_posterior.py``'s freezing predicate against the JAX
  trainer's labels, and one ``lookahead_trainer`` step against the JAX
  ``Trainer`` with the CLI's loss and optimizer (the MLP model), every
  parameter within 1e-5 of scale, the PM-VAE unchanged.
- The acquisition engine on the conv model: whole trajectories (two instances, 4 steps a rollout, 4 samples), the JAX side
  run eagerly one instance at a time (``jax.disable_jit``) with its
  normals recorded, the port batched over the instances with them: the
  masks and actions equal, the RMSE curve, the action distributions and
  the reconstructions at 1e-5 of scale; and one eval step on two other
  instances, with a mask observing some features already.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

os.environ.setdefault("PM_TPU_COMPILE_CACHE", "0")
from posterior_matching_tpu import acquisition as jax_acq  # noqa: E402
from posterior_matching_tpu.data.datasets import ArrayDataset as JaxArrayDataset  # noqa: E402
from posterior_matching_tpu.distributions.normal import (  # noqa: E402
    MultivariateNormalTriL as JaxTriL,
)
from posterior_matching_tpu.models.lookahead import LookaheadPosterior as JaxLookahead  # noqa
from posterior_matching_tpu.train import Trainer as JaxTrainer  # noqa: E402
from posterior_matching_torch import acquisition, convert  # noqa: E402
from posterior_matching_torch.train.trainer import lookahead_loss_fn, lookahead_trainer  # noqa
from test_torch_vade import jax_trainable  # noqa: E402
from test_torch_vae import GRAD_TOL, close, randomize, t  # noqa: E402

CONV_PM_VAE = {"latent_dim": 3, "encoder_net": "ConvEncoder", "decoder_net": "ConvDecoder",
               "posterior_dist": "TriLGaussian", "decoder_dist": "Bernoulli",
               "encoder_net_config": {"conv_layers": [(4, 3, 1), (4, 3, 2)]},
               "decoder_net_config": {"conv_layers": [(4, 2, 1), (4, 3, 2), (1, 3, 1)]}}
MLP_PM_VAE = {"latent_dim": 2, "encoder_net": "ResidualMLP", "decoder_net": "ResidualMLP",
              "posterior_dist": "TriLGaussian", "decoder_dist": "IdentityGaussian",
              "decoder_dist_config": {"event_size": 6},
              "encoder_net_config": {"residual_blocks": 1, "hidden_units": 8},
              "decoder_net_config": {"residual_blocks": 1, "hidden_units": 8}}
MODELS = {"conv": (CONV_PM_VAE, (4, 4, 1), 5), "mlp": (MLP_PM_VAE, (6,), 3)}
MODEL_SAMPLES = 3


def data(shape, seed=0, n=3):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, *shape).astype(np.float32) if len(shape) > 1 else \
        rng.randn(n, *shape).astype(np.float32)
    return x, (rng.rand(n, *shape) > 0.6).astype(np.float32)


def _touch(m, x, b):
    return m(x, b), m.expected_info_gains(x[0], b[0])


def init_shapes(jm, x, b):
    """The shapes of a JAX lookahead posterior's parameters, the PM-VAE's
    encoder (which only the info gains reach) included, as a PM-VAE run
    warm-starts them."""
    keys = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}
    return jax.eval_shape(lambda k: jm.init(k, x, b, method=_touch), keys)["params"]


def lookahead_config(shape, subsample):
    return {"num_features": int(np.prod(shape)), "lookahead_subsample": subsample,
            "model_samples": MODEL_SAMPLES}


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    pm_cfg, shape, subsample = MODELS[request.param]
    cfg = lookahead_config(shape, subsample)
    x, b = data(shape)
    jm = JaxLookahead.from_config(cfg, pm_cfg)
    params = randomize(init_shapes(jm, x, b), 3, std=0.3)
    port = convert.lookahead_from_jax(params, cfg, pm_cfg, device="cpu")
    return request.param, jm, params, port, x, b


@pytest.fixture
def record(monkeypatch):
    """The JAX side's TriL normals and ``jax.random.choice`` indices, in
    call order (under ``jit`` too)."""
    store = []
    keep = lambda a: jax.debug.callback(lambda e: store.append(np.array(e)), a, ordered=True)

    def tril_sample(self, key, sample_shape=()):
        eps = jax.random.normal(key, tuple(sample_shape) + self.loc.shape, self.loc.dtype)
        keep(eps)
        return self.loc + jnp.einsum("...ij,...j->...i", self.scale_tril, eps,
                                     precision=jax.lax.Precision.HIGHEST)

    choice = jax.random.choice

    def recorded_choice(*args, **kwargs):
        inds = choice(*args, **kwargs)
        keep(inds)
        return inds

    monkeypatch.setattr(JaxTriL, "sample", tril_sample)
    monkeypatch.setattr(jax.random, "choice", recorded_choice)
    return store


def draws(store):
    return iter([torch.from_numpy(e) if e.dtype.kind == "i" else t(e) for e in store])


def flat(tree):
    return convert.lookahead_state_dict(jax.device_get(tree))


def test_forward_and_gradients_match_jax(model, record):
    kind, jm, params, port, x, b = model
    loss = lambda p: jm.apply({"params": p}, x, b, rngs={"sample": jax.random.PRNGKey(4)})
    lls = jax.block_until_ready(jax.jit(loss)(params))
    grads_j = flat(jax.jit(jax.grad(lambda p: -jnp.mean(loss(p))))(params))
    assert len(record) == 6 and record[1].shape == (MODELS[kind][2],)
    got = port(t(x), t(b), draws(record[:3]))
    close(got, lls, what="lookahead ll")
    names, ps = zip(*port.named_parameters())
    grads = torch.autograd.grad(-got.mean(), ps, allow_unused=True)
    assert set(names) == set(grads_j)
    for name, g in zip(names, grads):
        if "lookahead" in name:
            close(g, grads_j[name], tol=GRAD_TOL, what=name)
        else:
            assert g is None and not np.any(grads_j[name]), name


def test_no_valid_feature_scores_zero(model):
    """An instance that already observes every subsampled feature."""
    kind, jm, params, port, x, b = model
    f, s = port.num_features, port.lookahead_subsample
    b = b.copy()
    b[0] = 1.0
    g = torch.Generator().manual_seed(0)
    inds = torch.randperm(f, generator=g)[:s]
    lat = port.pm_vae.latent_dim
    noise = iter([torch.randn(MODEL_SAMPLES, len(x), lat, generator=g), inds,
                  torch.randn(MODEL_SAMPLES * len(x) * s, lat, generator=g)])
    out = port(t(x), t(b), noise)
    assert out[0].item() == 0.0 and torch.isfinite(out).all()
    grads = torch.autograd.grad(out.sum(), list(port.lookahead_block.parameters()))
    assert all(torch.isfinite(gr).all() for gr in grads)


def test_expected_info_gains_match_jax(model):
    kind, jm, params, port, x, b = model
    want = np.asarray(jax.jit(lambda p: jm.apply({"params": p}, x[0], b[0],
                                                 method=jm.expected_info_gains))(params))
    with torch.no_grad():
        got = port.expected_info_gains(t(x[0]), t(b[0])).numpy()
        batch = port.batch_lookahead_gains(t(x), t(b)).numpy()
    observed = b[0].reshape(-1) != 0
    assert np.all(np.isneginf(got[observed])) and np.all(np.isneginf(want[observed]))
    close(got[~observed], want[~observed], what="lookahead info gains")
    np.testing.assert_array_equal(batch[0], got)


def test_trainer_freezes_and_steps_as_jax(record):
    """``"lookahead" in module_name`` trains ``lookahead_encoder_net`` and
    ``lookahead_block`` only; one step against the JAX ``Trainer``."""
    pm_cfg, shape, subsample = MODELS["mlp"]
    cfg = lookahead_config(shape, subsample)
    x, b = data(shape, seed=1, n=4)
    jm = JaxLookahead.from_config(cfg, pm_cfg)
    params = randomize(init_shapes(jm, x, b), 6, std=0.3)
    config = {"lr_schedule": {"init_value": 0.01, "decay_rate": 0.9, "transition_steps": 3}}
    pred = lambda module, name, value: "lookahead" in module
    want_trainable = jax_trainable(params, pred)

    def loss_fn(p, state, key, step, batch, is_training):
        lls = jm.apply({"params": p}, batch["features"], batch["mask"], is_training=is_training,
                       rngs={"sample": jax.random.split(key)[0]})
        return -jnp.mean(lls), {}, state

    def init_fn(key, batch):
        return jm.init({"params": key, "sample": key}, batch["features"], batch["mask"])["params"], {}

    tx = optax.chain(optax.scale_by_adam(),
                     optax.scale_by_schedule(optax.exponential_decay(**config["lr_schedule"])),
                     optax.scale(-1.0))
    trainer = JaxTrainer(loss_fn, init_fn, tx, num_devices=1, seed=0, trainable_predicate=pred)
    batch = {"features": x, "mask": b}
    ts = trainer.fit(JaxArrayDataset(batch, 4), 1, validation_freq=1, initial_params=params,
                     log_fn=lambda s: None)
    want = flat(ts.params)

    port = convert.lookahead_from_jax(params, cfg, pm_cfg, device="cpu")
    port_trainer = lookahead_trainer(port, config, data_key="features", device="cpu")
    step_draws = record[-3:]
    port_trainer.loss_fn = lambda m, bt, seed, training: lookahead_loss_fn("features")(
        m, bt, draws(step_draws), training)
    port_trainer.init()
    assert set(port_trainer.optimizer.params) == want_trainable
    assert want_trainable and all(n.startswith("lookahead_") for n in want_trainable)
    port_trainer.train_step(batch)
    start = flat(params)
    for name, w in want.items():
        close(port.state_dict()[name], w, what=name)
        if name not in want_trainable:
            np.testing.assert_array_equal(port.state_dict()[name].numpy(), start[name], name)


# ---------------------------------------------------------------------------
# The acquisition engine
# ---------------------------------------------------------------------------

ACQ_SAMPLES, EPISODE = 4, 4


@pytest.fixture(scope="module")
def acq_model():
    pm_cfg, shape, subsample = MODELS["conv"]
    cfg = lookahead_config(shape, subsample)
    x, b = data(shape, seed=2, n=2)
    jm = JaxLookahead.from_config(cfg, pm_cfg)
    params = randomize(init_shapes(jm, x, b), 8, std=0.4)
    port = convert.lookahead_from_jax(params, cfg, pm_cfg, device="cpu")
    return jm, params, port, x, b


def _stack(per_instance):
    """Per-instance draws ``[S, 1, L]`` -> the batch's ``[S, N, L]``, draw
    by draw."""
    return [t(np.concatenate(ds, axis=1)) for ds in zip(*per_instance)]


def test_trajectories_match_jax(acq_model, record):
    """Both rollouts of ``EPISODE`` steps from nothing observed."""
    jm, params, port, x, b = acq_model
    eval_fn = jax_acq.make_acquisition_eval_fn(jm, {"params": params}, ACQ_SAMPLES)
    collect = jax_acq.make_collect_trajectory_fn(eval_fn, EPISODE)
    want, per_instance = [], []
    with jax.disable_jit():
        for i in range(len(x)):
            record.clear()
            want.append(jax.device_get(collect(x[i], jax.random.PRNGKey(10 + i))))
            per_instance.append(list(record))
    assert all(len(r) == 2 * 2 * EPISODE for r in per_instance)
    got = acquisition.make_collect_trajectory_fn(
        acquisition.make_acquisition_eval_fn(port, ACQ_SAMPLES), EPISODE)(
        t(x), iter(_stack(per_instance)))
    for r, rollout in enumerate(("sampling", "lookahead")):
        g = {k: v.numpy() for k, v in got[r].items()}
        for i in range(len(x)):
            w = want[i][r]
            for k in ("sampling_action", "lookahead_action", "mask"):
                np.testing.assert_array_equal(g[k][i], np.asarray(w[k]), err_msg=f"{rollout} {k}")
            for k in ("rmse", "sampling_probs", "lookahead_probs", "reconstruction"):
                close(g[k][i], w[k], what=f"{rollout} {k}")
            assert g["mask"][i].shape == (EPISODE, *x.shape[1:])
            actions = g[f"{rollout}_action"][i]
            assert len(set(actions.tolist())) == EPISODE    # a new feature each step
            np.testing.assert_array_equal(g["mask"][i][-1].reshape(-1)[actions[:-1]], 1.0)


def test_eval_step_matches_jax(acq_model, record):
    jm, params, port, x, b = acq_model
    eval_fn = jax_acq.make_acquisition_eval_fn(jm, {"params": params}, ACQ_SAMPLES)
    want, per_instance = [], []
    with jax.disable_jit():
        for i in range(len(x)):
            record.clear()
            want.append(eval_fn(x[i] * b[i], b[i], jax.random.PRNGKey(i)))
            per_instance.append(list(record))
    assert all(len(r) == 2 for r in per_instance)
    got = acquisition.make_acquisition_eval_fn(port, ACQ_SAMPLES)(
        t(x * b), t(b), iter(_stack(per_instance)))
    for i in range(len(x)):
        for k in ("sampling_action", "lookahead_action"):
            assert int(got[k][i]) == int(want[i][k]), k
        for k in ("sampling_probs", "lookahead_probs", "reconstruction"):
            close(got[k][i], want[i][k], what=k)

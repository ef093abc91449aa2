"""The port's VaDE and PM-VaDE against the JAX package's, on the CPU at toy
widths, and the trainer changes that came with them.

- ``pretrain_loss``, ``elbo``, ``predict_cluster``, ``posterior_matching_ll``
  and ``partial_predict_cluster`` of an MLP PM-VaDE (residual MLPs, an
  ``IdentityGaussian`` likelihood, the TriL partial posterior) and a conv
  PM-VaDE (Bernoulli likelihood, the autoregressive GMM partial posterior)
  at 1e-5 of scale, with the JAX side's standard normals recorded by
  replacing the distributions' ``sample`` and handed to the port as an
  iterator (the autoregressive GMM's samples, drawn inside ``fori_loop``,
  replaced on both sides by one tensor).
- The gradient of ``-mean(elbo)`` with respect to every parameter within
  1e-4 of scale, ``logits`` included: both sides keep the reference's raw
  logits in the prior term, so adding a constant to them adds it to the
  bound. The matching loss's gradient is zero outside ``partial_*`` on both
  sides.
- The trainers' freezing predicates against the JAX trainer's labels, and
  one step of each VaDE trainer (pretraining, ELBO at ``adam.eps`` 1e-4,
  PM-VaDE with its frozen prior) against the JAX ``Trainer`` with the CLI's
  loss and optimizer, every parameter within 1e-5 of scale.
- ``init_vade_tree`` has the JAX init's structure; ``batch_process`` gives
  the JAX function's concatenation; Adam at ``eps`` 1e-4 is optax's, and
  ``pm_vae_trainer`` takes that option and refuses any other.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

os.environ.setdefault("PM_TPU_COMPILE_CACHE", "0")
from posterior_matching_tpu.data.datasets import ArrayDataset as JaxArrayDataset  # noqa: E402
from posterior_matching_tpu.distributions.normal import (  # noqa: E402
    MultivariateNormalDiag as JaxDiag,
)
from posterior_matching_tpu.distributions.normal import (  # noqa: E402
    MultivariateNormalTriL as JaxTriL,
)
from posterior_matching_tpu.models import heads as jax_heads  # noqa: E402
from posterior_matching_tpu.models.vade import PosteriorMatchingVADE as JaxPMVADE  # noqa: E402
from posterior_matching_tpu.models.vade import VADE as JaxVADE  # noqa: E402
from posterior_matching_tpu.train import Trainer as JaxTrainer  # noqa: E402
from posterior_matching_tpu.train.trainer import _path_to_names  # noqa: E402
from posterior_matching_tpu.utils import batch_process as jax_batch_process  # noqa: E402
from posterior_matching_torch import convert  # noqa: E402
from posterior_matching_torch.data.datasets import ArrayDataset  # noqa: E402
from posterior_matching_torch.models import heads  # noqa: E402
from posterior_matching_torch.models.vade import VADE  # noqa: E402
from posterior_matching_torch.train.optim import Adam, trainable_names  # noqa: E402
from posterior_matching_torch.train.trainer import (  # noqa: E402
    Trainer,
    pm_vade_loss_fn,
    pm_vade_trainer,
    pm_vae_trainer,
    vade_loss_fn,
    vade_pretrain_loss_fn,
    vade_pretrain_trainer,
    vade_trainer,
)
from posterior_matching_torch.utils import batch_process  # noqa: E402
from test_torch_vae import GRAD_TOL, TOL, close, randomize, t  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MLP = {"num_components": 3, "latent_dim": 2, "encoder_net": "ResidualMLP",
       "decoder_net": "ResidualMLP", "decoder_dist": "IdentityGaussian",
       "decoder_dist_config": {"event_size": 5},
       "encoder_net_config": {"residual_blocks": 1, "hidden_units": 8},
       "decoder_net_config": {"residual_blocks": 1, "hidden_units": 8}}
CONV = {"num_components": 3, "latent_dim": 3, "encoder_net": "ConvEncoder",
        "decoder_net": "ConvDecoder", "decoder_dist": "Bernoulli",
        "encoder_net_config": {"conv_layers": [(4, 3, 1), (8, 5, 2), (8, 1, 1)]},
        "decoder_net_config": {"conv_layers": [(8, 4, 1), (4, 5, 2), (1, 3, 1)]},
        "partial_posterior_dist": "AutoregressiveGMM",
        "partial_posterior_dist_config": {"num_components": 2, "residual_blocks": 1,
                                          "hidden_units": 8}}
MODELS = {"mlp": (MLP, (5,)), "conv": (CONV, (8, 8, 1))}
SAMPLES = 4


def data(shape, seed=0, n=4):
    rng = np.random.RandomState(seed)
    if len(shape) == 1:
        x = rng.randn(n, *shape).astype(np.float32)
    else:
        x = (rng.rand(n, *shape) > 0.5).astype(np.float32)
    return x, (rng.rand(n, *shape) > 0.4).astype(np.float32)


def _touch(m, x, b=None):
    out = [m.elbo(x)]
    if b is not None:
        out.append(m.posterior_matching_ll(x, b))
    return out


def jax_shapes(jm, x, b=None):
    """The shapes of a JAX VaDE's parameters, every module reached."""
    keys = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}
    init = functools.partial(jm.init, method=_touch)
    return jax.eval_shape(init, keys, x, b)["params"]


def flat(tree):
    return convert.vade_state_dict(jax.device_get(tree))


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    cfg, shape = MODELS[request.param]
    x, b = data(shape)
    jm = JaxPMVADE.from_config(cfg)
    params = randomize(jax_shapes(jm, x, b), 7, std=0.3)
    port = convert.vade_from_jax(params, cfg, device="cpu")
    assert port.data_shape == shape and hasattr(port, "partial_encoder_net")
    return request.param, jm, params, port, x, b


@pytest.fixture
def record(monkeypatch):
    """The JAX side's standard normals in call order (under ``jit`` too),
    and both packages' autoregressive GMM samples replaced by one tensor
    of the requested shape."""
    store = []

    def eps_of(self, key, sample_shape):
        eps = jax.random.normal(key, tuple(sample_shape) + self.loc.shape, self.loc.dtype)
        jax.debug.callback(lambda e: store.append(np.array(e)), eps, ordered=True)
        return eps

    def tril_sample(self, key, sample_shape=()):
        return self.loc + jnp.einsum("...ij,...j->...i", self.scale_tril,
                                     eps_of(self, key, sample_shape),
                                     precision=jax.lax.Precision.HIGHEST)

    def agmm(sample_shape, b, d):
        return np.random.RandomState(11).randn(*sample_shape, b, d).astype(np.float32)

    monkeypatch.setattr(JaxTriL, "sample", tril_sample)
    monkeypatch.setattr(JaxDiag, "sample", lambda self, key, sample_shape=():
                        self.loc + self.scale_diag * eps_of(self, key, sample_shape))
    monkeypatch.setattr(jax_heads.AutoregressiveGMM, "sample", lambda self, key, sample_shape=():
                        jnp.asarray(agmm(sample_shape, self.context.shape[0], self.event_size)))
    monkeypatch.setattr(heads.AutoregressiveGMM, "sample", lambda self, noise, sample_shape=():
                        t(agmm(sample_shape, self.context.shape[0], self.event_size)))
    return store


def noise(store):
    return iter([t(e) for e in store])


def _methods(m, x, b):
    return {"pretrain_loss": m.pretrain_loss(x), "elbo": m.elbo(x),
            "predict_cluster": m.predict_cluster(x, SAMPLES),
            "posterior_matching_ll": m.posterior_matching_ll(x, b),
            "partial_predict_cluster": m.partial_predict_cluster(x, b, SAMPLES)}


def test_methods_match_jax(model, record):
    kind, jm, params, port, x, b = model
    want = jax.block_until_ready(jax.jit(lambda p: jm.apply(
        {"params": p}, x, b, method=_methods, rngs={"sample": jax.random.PRNGKey(2)}))(params))
    assert len(record) == (4 if kind == "mlp" else 3)   # the AGMM's sample is replaced
    eps = noise(record)
    xt, bt = t(x), t(b)
    with torch.no_grad():
        got = {"pretrain_loss": port.pretrain_loss(xt), "elbo": port.elbo(xt, eps),
               "predict_cluster": port.predict_cluster(xt, eps, SAMPLES),
               "posterior_matching_ll": port.posterior_matching_ll(xt, bt, eps),
               "partial_predict_cluster": port.partial_predict_cluster(xt, bt, eps, SAMPLES)}
    for k in want:
        close(got[k], want[k], what=k)
    for k in ("predict_cluster", "partial_predict_cluster"):
        assert got[k].shape == (len(x), 3)
        close(got[k].sum(-1), np.ones(len(x)), what=f"{k} sums to 1")


def test_elbo_gradients_match_jax(model, record):
    """Every parameter's gradient of ``-mean(elbo)``, and the raw-logits
    quirk: a constant added to ``logits`` adds itself to the bound (the
    log-softmax would cancel it)."""
    kind, jm, params, port, x, b = model
    loss = lambda p: -jnp.mean(jm.apply({"params": p}, x, method=jm.elbo,
                                        rngs={"sample": jax.random.PRNGKey(3)}))
    loss_j, grads_j = jax.block_until_ready(jax.jit(jax.value_and_grad(loss))(params))
    assert len(record) == 1
    want = flat(grads_j)
    names, ps = zip(*port.named_parameters())
    got = -port.elbo(t(x), noise(record)).mean()
    np.testing.assert_allclose(got.item(), float(loss_j), rtol=TOL)
    grads = torch.autograd.grad(got, ps, allow_unused=True)
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        close(torch.zeros_like(ps[names.index(name)]) if g is None else g, want[name],
              tol=GRAD_TOL, what=name)
    assert float(np.abs(want["logits"]).max()) > 0
    with torch.no_grad():
        base = port.elbo(t(x), noise(record))
        port.logits.add_(1.5)
        shifted = port.elbo(t(x), noise(record))
        port.logits.sub_(1.5)
    close(shifted - base, np.full(len(x), 1.5, np.float32), what="raw logits")


def test_matching_gradient_is_zero_outside_the_partial_encoder(model, record):
    kind, jm, params, port, x, b = model
    loss = lambda p: -jnp.mean(jm.apply({"params": p}, x, b, method=jm.posterior_matching_ll,
                                        rngs={"sample": jax.random.PRNGKey(4)}))
    want = flat(jax.jit(jax.grad(loss))(params))
    names, ps = zip(*port.named_parameters())
    grads = torch.autograd.grad(pm_vade_loss_fn("features")(
        port, {"features": t(x), "mask": t(b)}, noise(record), True), ps, allow_unused=True)
    for name, g in zip(names, grads):
        if name.startswith("partial_"):
            close(g, want[name], tol=GRAD_TOL, what=name)
        else:
            assert not np.any(want[name]), name
            assert g is None or not torch.any(g), name


def jax_trainable(params, predicate):
    labels = jax.tree_util.tree_map_with_path(
        lambda path, v: predicate("/".join(_path_to_names(path)[:-1]),
                                  _path_to_names(path)[-1], v), params)
    return {n for n, v in convert.vade_state_dict(labels).items() if bool(v)}


@pytest.mark.parametrize("kind", list(MODELS))
def test_pm_vade_freezes_what_jax_freezes(kind):
    """``train_pm_vade.py``'s predicate (``"partial_" in module_name``)
    freezes the prior's top-level ``logits``, ``mu`` and ``log_scale`` (path
    ``""``) with the VaDE; the port's freezes the same names."""
    cfg, shape = MODELS[kind]
    x, b = data(shape)
    params = jax_shapes(JaxPMVADE.from_config(cfg), x, b)
    want = jax_trainable(params, lambda module, name, value: "partial_" in module)
    port = convert.vade_from_jax(randomize(params, 0), cfg, device="cpu")
    trainer = pm_vade_trainer(port, {"lr_schedule": {"init_value": 1e-3, "decay_rate": 0.9,
                                                     "transition_steps": 10}}, device="cpu")
    trainer.init()
    assert set(trainer.optimizer.params) == want
    assert {"logits", "mu", "log_scale"}.isdisjoint(want) and want
    assert set(trainable_names([n for n, _ in port.named_parameters()])) >= want


def _jax_optimizer(config, kind):
    if kind == "pretrain":
        return optax.adam(config["pretrain_lr"])
    return optax.chain(optax.scale_by_adam(**config.get("adam", {})),
                       optax.scale_by_schedule(optax.exponential_decay(**config["lr_schedule"])),
                       optax.scale(-1.0))


TRAIN = {"pretrain_lr": 0.01, "adam": {"eps": 1e-4},
         "lr_schedule": {"init_value": 0.01, "decay_rate": 0.9, "staircase": False,
                         "transition_steps": 3}}


@pytest.mark.parametrize("kind", ["pretrain", "vade", "pm_vade"])
def test_trainer_step_matches_jax_trainer(kind, record):
    """One step of the port's trainer and of the JAX ``Trainer`` with the
    JAX CLI's loss, optimizer and freezing (``train_vade.py:60-78,132-139,
    180-185``, ``train_pm_vade.py:64-100``) from the same weights: every
    parameter within 1e-5 of scale, the frozen ones unchanged."""
    cfg, shape = MODELS["mlp"]
    x, b = data(shape, seed=1, n=8)
    partial = kind == "pm_vade"
    jm = (JaxPMVADE if partial else JaxVADE).from_config(cfg)
    params = randomize(jax_shapes(jm, x, b if partial else None), 5, std=0.3)
    config = dict(TRAIN, model=cfg) if kind == "vade" else {k: v for k, v in TRAIN.items()
                                                            if k != "adam"}
    batch = {"features": x, "mask": b}

    def loss_fn(p, state, key, step, batch, is_training):
        rngs = {"sample": jax.random.split(key)[0]}
        if kind == "pretrain":
            return jm.apply({"params": p}, batch["features"], method=jm.pretrain_loss), {}, state
        if kind == "vade":
            out = jm.apply({"params": p}, batch["features"], method=jm.elbo, rngs=rngs)
        else:
            out = jm.apply({"params": p}, batch["features"], batch["mask"],
                           method=jm.posterior_matching_ll, rngs=rngs)
        return -jnp.mean(out), {}, state

    def init_fn(key, batch):
        return jm.init({"params": key, "sample": key}, batch["features"],
                       batch["mask"] if partial else None, method=_touch)["params"], {}

    pred = (lambda module, name, value: "partial_" in module) if partial else None
    trainer = JaxTrainer(loss_fn, init_fn, _jax_optimizer(config, kind), num_devices=1, seed=0,
                         trainable_predicate=pred)
    ts = trainer.fit(JaxArrayDataset(batch, 8), 1, validation_freq=1, initial_params=params,
                     log_fn=lambda s: None)
    want = flat(ts.params)

    port = convert.vade_from_jax(params, cfg, device="cpu")
    make = {"pretrain": vade_pretrain_trainer, "vade": vade_trainer,
            "pm_vade": pm_vade_trainer}[kind]
    port_trainer = make(port, config, data_key="features", device="cpu")
    if kind != "pretrain":
        eps = t(record[-1])
        loss = (vade_loss_fn if kind == "vade" else pm_vade_loss_fn)("features")
        port_trainer.loss_fn = lambda m, bt, seed, training: loss(m, bt, iter([eps]), training)
    port_trainer.init()
    assert port_trainer.optimizer.eps == (1e-4 if kind == "vade" else 1e-8)
    port_trainer.train_step(batch)
    got = port.state_dict()
    assert set(got) == set(want)
    start = flat(params)
    for name, w in want.items():
        close(got[name], w, what=name)
        if partial and not name.startswith("partial_"):
            np.testing.assert_array_equal(got[name].numpy(), start[name], err_msg=name)


def test_only_the_pretrain_trainer_zeroes_unused_gradients():
    """The pretraining loss does not reach the prior: its trainer gives
    ``logits``, ``mu`` and ``log_scale`` zero gradients, so they stay put
    as in JAX; a ``Trainer`` without ``zero_unused_grads`` raises."""
    cfg, shape = MODELS["mlp"]
    x, _ = data(shape)
    tree = convert.init_vade_tree(cfg, seed=3)
    batch = {"features": x}
    strict = Trainer(convert.vade_from_jax(tree, cfg, device="cpu"),
                     vade_pretrain_loss_fn("features"),
                     optimizer=lambda params: Adam(params, lambda count: 0.01), device="cpu")
    with pytest.raises(RuntimeError):
        strict.train_step(batch)
    port = convert.vade_from_jax(tree, cfg, device="cpu")
    trainer = vade_pretrain_trainer(port, {"pretrain_lr": 0.01}, data_key="features",
                                    device="cpu")
    trainer.train_step(batch)
    assert set(trainer.optimizer.params) == {n for n, _ in port.named_parameters()}
    for name in ("logits", "mu", "log_scale"):
        np.testing.assert_array_equal(port.state_dict()[name].numpy(), tree[name], err_msg=name)


@pytest.mark.parametrize("kind", list(MODELS))
def test_init_tree_has_the_jax_structure(kind):
    """``init_vade_tree`` (VaDE and PM-VaDE): the JAX init's paths and
    shapes, ``logits`` zero, ``mu`` and ``log_scale`` drawn N(0, 1)."""
    cfg, shape = MODELS[kind]
    x, b = data(shape)
    shapes = lambda tr: jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), tr)
    for partial, jm in ((False, JaxVADE), (True, JaxPMVADE)):
        want = jax_shapes(jm.from_config(cfg), x, b if partial else None)
        tree = convert.init_vade_tree(cfg, seed=3, partial=partial)
        assert shapes(tree) == shapes(want)
        assert not np.any(tree["logits"])
        model = convert.vade_from_jax(tree, cfg, device="cpu")
        assert isinstance(model, VADE) and hasattr(model, "partial_encoder_net") == partial
    big = convert.init_vade_tree(dict(cfg, num_components=50, latent_dim=20), seed=4)
    for name in ("mu", "log_scale"):
        assert abs(big[name].mean()) < 0.1 and abs(big[name].std() - 1) < 0.1


def test_batch_process_matches_jax():
    rng = np.random.RandomState(0)
    arrays = {"features": rng.randn(20, 3).astype(np.float32), "label": np.arange(20)}
    jax_fn = lambda batch: {"y": batch["features"] * 2.0, "n": (batch["label"] + 1,)}
    want = jax_batch_process(jax_fn, JaxArrayDataset(arrays, 6, drop_remainder=False))
    got = batch_process(jax_fn, ArrayDataset(arrays, 6, drop_remainder=False), device="cpu")
    np.testing.assert_array_equal(got["y"], want["y"])
    np.testing.assert_array_equal(got["n"][0], want["n"][0])
    # a fresh generator a batch: different draws, repeatable from the seed
    draw = lambda batch, gen: torch.rand(len(batch["features"]), generator=gen)
    a = batch_process(draw, ArrayDataset(arrays, 5), torch.Generator().manual_seed(1))
    b = batch_process(draw, ArrayDataset(arrays, 5), torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (20,) and len(np.unique(a)) == 20
    with pytest.raises(ValueError):
        batch_process(jax_fn, [])


def test_adam_eps_matches_optax():
    """One step at ``eps`` 1e-4 with gradients of order 1e-4, where ``eps``
    matters, against ``optax.scale_by_adam(eps=1e-4)`` under a constant
    schedule; ``pm_vae_trainer`` takes ``adam.eps`` and refuses any other
    Adam option."""
    rng = np.random.RandomState(2)
    params = {"w": rng.randn(4, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32)}
    grads = {k: (1e-4 * rng.randn(*v.shape)).astype(np.float32) for k, v in params.items()}
    tx = optax.chain(optax.scale_by_adam(eps=1e-4), optax.scale(-0.01))
    upd, _ = tx.update(grads, tx.init(params))
    tp = {k: t(v) for k, v in params.items()}
    Adam(tp, lambda count: 0.01, eps=1e-4).step({k: t(v) for k, v in grads.items()})
    for k in params:
        close(tp[k], params[k] + np.asarray(upd[k]), what=k)
    moved = lambda eps: float(np.abs(np.asarray(optax.chain(
        optax.scale_by_adam(eps=eps), optax.scale(-0.01)).update(grads, tx.init(params))[0]["w"])
    ).max())
    assert moved(1e-4) < 0.7 * moved(1e-8)

    from posterior_matching_torch.models.vae import PosteriorMatchingVAE

    vae = PosteriorMatchingVAE.from_config(
        {"latent_dim": 2, "encoder_net": "ResidualMLP", "decoder_net": "ResidualMLP",
         "posterior_dist": "TriLGaussian", "decoder_dist": "IdentityGaussian",
         "decoder_dist_config": {"event_size": 3},
         "encoder_net_config": {"hidden_units": 4}, "decoder_net_config": {"hidden_units": 4}},
        device="cpu")
    lr = {"lr_schedule": {"init_value": 1e-3, "decay_rate": 0.9, "transition_steps": 10}}
    trainer = pm_vae_trainer(vae, dict(lr, adam={"eps": 1e-4}), device="cpu")
    trainer.init()
    assert trainer.optimizer.eps == 1e-4
    with pytest.raises(NotImplementedError):
        pm_vae_trainer(vae, dict(lr, adam={"eps": 1e-4, "b1": 0.8}), device="cpu")


def test_exponential_decay_matches_optax():
    """The VaDE configs' schedules name ``staircase``, always False."""
    from posterior_matching_torch.train.schedules import exponential_decay

    cfg = {"init_value": 0.002, "decay_rate": 0.9, "transition_steps": 7,
           "staircase": False}
    got, want = exponential_decay(**cfg), optax.exponential_decay(**cfg)
    for step in range(40):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)


def test_exponential_decay_refuses_staircase():
    from posterior_matching_torch.train.schedules import exponential_decay

    with pytest.raises(NotImplementedError):
        exponential_decay(0.002, 7, 0.9, staircase=True)

"""Resume across the two packages: the batch stream's fast-forward, the
optimizer state in optax's layout, and the trainers continuing each other's
checkpoints, on the CPU at toy sizes.

- ``ArrayDataset.skip_stream(n)`` leaves the stream where a replay of ``n``
  batches leaves it (within an epoch, at and across epoch boundaries,
  shuffled), and where the JAX ``ArrayDataset``'s ``skip_stream`` leaves
  the JAX stream, and gathers and transforms no batch on the way.
- For each optax chain the JAX CLIs build (``optax.adam``; ``scale_by_adam``
  with the schedule; PM-VAE's with the masked decayed weights; PM-VDVAE's
  with the clip; under ``multi_transform`` where a trainable predicate
  freezes a subtree), the state a port trainer writes, read by the JAX
  package's plain ``pickle.load``, has the tree structure, leaf shapes and
  dtypes of the JAX package's own ``init`` of that chain.
- At trainer level, with a small deterministic MLP (``tests/
  test_resume.py``'s): the JAX trainer trains 10 steps and saves, the port
  resumes to 20 and equals the JAX trainer's straight 20 steps within 1e-5
  of scale (parameters, ``mu``, ``nu``, count); and the reverse, the port's
  checkpoint continued by the JAX ``Trainer.fit(resume_from=...)``; a
  frozen subtree and the clipped chain among the cases.
- A ``packed_chain`` checkpoint (``PackedChainCodec``'s stacked moments):
  the port's unpacking inverts the JAX package's ``pack_chain_params``
  exactly; a tiny PM-VQVAE trained packed by the JAX trainer resumes in
  the port as its canonical twin does (``tests/test_torch_resume_packed.py``,
  a file of its own so that the suite's workers run its interpret-mode JAX
  training beside the rest).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from torch import nn

from posterior_matching_tpu.data.datasets import ArrayDataset as JaxArrayDataset
from posterior_matching_tpu.models.pixelcnn import pack_chain_params
from posterior_matching_tpu.train import Trainer as JaxTrainer
from posterior_matching_tpu.train.state import load_train_state as jax_load
from posterior_matching_tpu.train.state import save_train_state as jax_save
from posterior_matching_torch import convert
from posterior_matching_torch.config import CONFIGS
from posterior_matching_torch.data.datasets import ArrayDataset
from posterior_matching_torch.train import trainer as tr
from posterior_matching_torch.train.optim import Adam, ClippedAdam
from posterior_matching_torch.train.schedules import exponential_decay
from posterior_matching_torch.train.state import TrainState, load_train_state, save_train_state
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _stream(ds, n):
    out = []
    while len(out) < n:
        for b in ds:
            out.append(b["features"])
            if len(out) == n:
                break
    return out


@pytest.mark.parametrize("skip", [0, 3, 7, 8, 20, 23])
def test_skip_stream_matches_replay_and_jax(skip):
    x = np.arange(56 * 3, dtype=np.float32).reshape(56, 3)   # 7 batches an epoch
    ref = _stream(ArrayDataset({"features": x}, 8, shuffle=True, seed=5), 26)
    ds = ArrayDataset({"features": x}, 8, shuffle=True, seed=5)
    ds.skip_stream(skip)
    jds = JaxArrayDataset({"features": x}, 8, shuffle=True, seed=5)
    jds.skip_stream(skip)
    got, jax_got = _stream(ds, 26 - skip), _stream(jds, 26 - skip)
    for i, (g, j) in enumerate(zip(got, jax_got)):
        np.testing.assert_array_equal(g, ref[skip + i])
        np.testing.assert_array_equal(g, j)


def test_skip_stream_gathers_nothing():
    x = np.arange(56 * 3, dtype=np.float32).reshape(56, 3)
    calls = []
    ds = ArrayDataset({"features": x}, 8, shuffle=True, seed=5,
                      transform=lambda b: (calls.append(1), b)[1])
    ds.skip_stream(100 * 7 + 3)
    assert calls == []
    first = next(iter(ds))["features"]
    assert len(calls) == 1
    fresh = ArrayDataset({"features": x}, 8, shuffle=True, seed=5)
    np.testing.assert_array_equal(first, _stream(fresh, 100 * 7 + 4)[-1])


# ---------------------------------------------------------------------------
# The optimizer state's layout against the JAX package's init
# ---------------------------------------------------------------------------

VQ = {"output_channels": 1, "embedding_dim": 8, "num_embeddings": 16, "hidden_units": 8,
      "residual_blocks": 1, "residual_hidden_units": 8, "decay": 0.99, "use_ema": True,
      "commitment_cost": 0.25}
PC = {"image_shape": (4, 4), "num_resnet": 2, "num_hierarchies": 1, "num_filters": 8,
      "dropout": 0.0, "num_indices": 16}
ENC = [(4, 5, 1), (4, 5, 2), (8, 5, 1), (8, 5, 2), (8, 7, 1)]
DEC = [(8, 7, 1), (8, 5, 2), (4, 5, 1), (4, 5, 2), (4, 5, 1), (1, 5, 1)]


def _decay_mask(params):
    return jax.tree.map(lambda x: x.ndim != 1, params)


def _scheduled(config):
    return optax.chain(optax.scale_by_adam(**config.get("adam", {})),
                       optax.scale_by_schedule(optax.exponential_decay(**config["lr_schedule"])),
                       optax.scale(-1.0))


def _vade_model(name="vade_mnist"):
    model = CONFIGS[name]()["model"]
    model["encoder_net_config"]["conv_layers"] = ENC
    model["decoder_net_config"]["conv_layers"] = DEC
    return model


def _case(name):
    """A port trainer of a toy model of ``name``'s CLI and the optax chain
    that the JAX CLI builds for it (and its trainable predicate)."""
    cpu = {"device": "cpu"}
    if name == "vqvae":
        config = CONFIGS["vqvae_mnist"]()
        model = convert.vqvae_from_jax(*convert.init_vqvae_tree(VQ, 0), VQ, **cpu)
        return tr.vqvae_trainer(model, config, **cpu), optax.adam(config["learning_rate"]), None
    if name == "pm_vqvae":
        config = CONFIGS["pm_vqvae_mnist"]()
        params, state = convert.random_pm_vqvae_tree(16, VQ, PC, seed=0)
        model = convert.pm_vqvae_from_jax(params, state, 16, VQ, PC, **cpu)
        return (tr.pm_vqvae_trainer(model, config, **cpu), _scheduled(config),
                lambda module, leaf: not module.startswith("vqvae"))
    if name == "pm_vdvae":
        config = CONFIGS["pm_vdvae_mnist"]()
        model_cfg = dict(config["model"], width=16, latent_dim=4, num_mixtures=2,
                         encoder_blocks="28x2,28d4,7x2,7d7,1x2",
                         decoder_blocks="1x2,7m1,7x2,28m7,28x2")
        model = convert.pm_vdvae_from_jax(convert.init_pm_vdvae_tree(model_cfg, 0), model_cfg,
                                          **cpu)
        tx = optax.chain(optax.clip_by_global_norm(config["gradient_clip"]),
                         optax.scale_by_adam(),
                         optax.add_decayed_weights(config.get("weight_decay", 0.0),
                                                   mask=_decay_mask),
                         optax.scale_by_schedule(lambda count: config["lr"]), optax.scale(-1.0))
        return tr.pm_vdvae_trainer(model, config, **cpu), tx, None
    if name == "pm_vae":
        config = CONFIGS["pm_vae_gas"]()
        config["model"]["encoder_net_config"]["hidden_units"] = 16
        config["model"]["decoder_net_config"]["hidden_units"] = 16
        model = convert.pm_vae_from_jax(convert.init_pm_vae_tree(config["model"], 0),
                                        config["model"], **cpu)
        tx = optax.chain(optax.scale_by_adam(**config.get("adam", {})),
                         optax.add_decayed_weights(config.get("weight_decay", 0.0),
                                                   mask=_decay_mask),
                         optax.scale_by_schedule(optax.exponential_decay(**config["lr_schedule"])),
                         optax.scale(-1.0))
        return tr.pm_vae_trainer(model, config, **cpu), tx, None
    if name in ("vade", "vade_pretrain"):
        config = dict(CONFIGS["vade_mnist"](), model=_vade_model())
        model = convert.vade_from_jax(convert.init_vade_tree(config["model"], 0),
                                      config["model"], **cpu)
        if name == "vade_pretrain":
            return (tr.vade_pretrain_trainer(model, config, **cpu),
                    optax.adam(config["pretrain_lr"]), None)
        return tr.vade_trainer(model, config, **cpu), _scheduled(config), None
    if name == "pm_vade":
        config = dict(CONFIGS["pm_vade_mnist"](), model=_vade_model("pm_vade_mnist"))
        config["model"]["partial_posterior_dist_config"]["hidden_units"] = 8
        model = convert.vade_from_jax(convert.init_vade_tree(config["model"], 0, partial=True),
                                      config["model"], **cpu)
        return (tr.pm_vade_trainer(model, config, **cpu), _scheduled(config),
                lambda module, leaf: "partial_" in module)
    if name == "lookahead":
        config = CONFIGS["lookahead_mnist16"]()
        config["model"].update(model_samples=3, lookahead_subsample=4, num_features=256)
        pm_vae = CONFIGS["pm_vae_mnist16"]()["model"]
        pm_vae["encoder_net_config"]["conv_layers"] = [(4, 3, 1), (4, 3, 2), (8, 3, 2), (8, 1, 1)]
        pm_vae["decoder_net_config"]["conv_layers"] = [(8, 8, 1), (8, 5, 2), (4, 5, 1), (1, 3, 1)]
        pm_vae["latent_dim"] = 3
        model = convert.lookahead_from_jax(
            convert.init_lookahead_tree(config["model"], pm_vae, 0), config["model"], pm_vae,
            **cpu)
        return (tr.lookahead_trainer(model, config, **cpu), _scheduled(config),
                lambda module, leaf: "lookahead" in module)
    raise KeyError(name)


def _shapes(tree):
    return [(np.shape(x), np.asarray(x).dtype) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("name", ["vqvae", "pm_vqvae", "pm_vdvae", "pm_vae", "vade_pretrain",
                                  "vade", "pm_vade", "lookahead"])
def test_opt_state_has_the_jax_init_layout(name, tmp_path):
    trainer, tx, trainable = _case(name)
    trainer.init()
    save_train_state(str(tmp_path / "train_state.pkl"), trainer.train_state())
    got = jax_load(str(tmp_path / "train_state.pkl"))   # optax's own classes, by pickle
    pred = None if trainable is None else (lambda m, n, v: trainable(m, n))
    jt = JaxTrainer(lambda *a: None, lambda *a: None, tx, trainable_predicate=pred)
    want = jt._build_tx(got.params).init(got.params)
    assert jax.tree.structure(got.opt_state) == jax.tree.structure(want)
    assert _shapes(got.opt_state) == _shapes(want)
    assert type(jax.tree.leaves(got.opt_state)[0]) is np.ndarray


# ---------------------------------------------------------------------------
# Trainers continuing each other's checkpoints
# ---------------------------------------------------------------------------

class JaxTiny(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return fnn.Dense(x.shape[-1])(jax.nn.relu(fnn.Dense(8)(x)))


class Dense(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return x @ self.kernel + self.bias


class TorchTiny(nn.Module):
    """``JaxTiny`` under flax's names: the outer ``Dense`` is made first, so
    it is ``Dense_0``."""

    def __init__(self):
        super().__init__()
        self.Dense_0, self.Dense_1 = Dense(8, 4), Dense(4, 8)

    def forward(self, x):
        return self.Dense_0(torch.relu(self.Dense_1(x)))


X = np.random.RandomState(0).randn(64, 4).astype(np.float32)
SCHEDULE = {"init_value": 1e-2, "transition_steps": 5, "decay_rate": 0.9}


def _jax_loss(params, state, key, step, batch, is_training):
    pred = JaxTiny().apply({"params": params}, batch["features"])
    return jnp.mean((pred - batch["features"]) ** 2), {}, state


def _jax_init(key, batch):
    return JaxTiny().init(key, batch["features"])["params"], {}


def _torch_loss(model, batch, seed, training):
    return ((model(batch["features"]) - batch["features"]) ** 2).mean()


def _datasets():
    return (JaxArrayDataset({"features": X}, 16, shuffle=True, seed=3),
            ArrayDataset({"features": X}, 16, shuffle=True, seed=3))


def _trainers(chain, frozen):
    """The JAX trainer and the port trainer of one chain, freezing
    ``Dense_0`` with ``frozen``."""
    if chain == "scheduled":
        tx = optax.chain(optax.scale_by_adam(),
                         optax.scale_by_schedule(optax.exponential_decay(**SCHEDULE)),
                         optax.scale(-1.0))
        opt = lambda params: Adam(params, exponential_decay(**SCHEDULE))
    else:   # the PM-VDVAE chain, a clip that bites
        tx = optax.chain(optax.clip_by_global_norm(0.05), optax.scale_by_adam(),
                         optax.add_decayed_weights(1e-3, mask=_decay_mask),
                         optax.scale_by_schedule(lambda count: 1e-2), optax.scale(-1.0))
        opt = lambda params: ClippedAdam(params, lambda count: 1e-2, 0.05, 1e-3)
    trainable = (lambda module, leaf: module != "Dense_0") if frozen else None
    jt = JaxTrainer(_jax_loss, _jax_init, tx, seed=7,
                    trainable_predicate=None if trainable is None else
                    (lambda m, n, v: trainable(m, n)))
    pt = tr.Trainer(TorchTiny(), _torch_loss, optimizer=opt, trainable=trainable,
                    to_trees=lambda sd: (convert.pm_vae_trees(sd), {}),
                    from_trees=lambda params, state: convert.pm_vae_state_dict(params),
                    device="cpu")
    return jt, pt


def _flat(ts, trainable, path):
    """The count and flat parameters and moments of ``ts``, a port or (by
    way of a checkpoint at ``path``) a JAX ``TrainState``."""
    if not isinstance(ts, TrainState):
        jax_save(path, ts)
        ts = load_train_state(path)
    count, mu, nu = convert.optax_moments(ts.opt_state, ts.params, trainable)
    flat = convert.pm_vae_state_dict
    return count, {k: flat(t) for k, t in (("params", ts.params), ("mu", mu), ("nu", nu))}


def _assert_close(got, want):
    assert got[0] == want[0]
    for kind in want[1]:
        for name, w in want[1][kind].items():
            g = got[1][kind][name]
            assert np.abs(g - w).max() <= 1e-5 * max(np.abs(w).max(), 1e-30), (kind, name)


@pytest.mark.parametrize("chain,frozen,direction", [
    ("scheduled", False, "jax_to_port"), ("scheduled", True, "jax_to_port"),
    ("clipped", False, "jax_to_port"), ("scheduled", False, "port_to_jax"),
    ("scheduled", True, "port_to_jax"), ("clipped", True, "port_to_jax")])
def test_resume_crosses_over(chain, frozen, direction, tmp_path):
    path = str(tmp_path / "train_state.pkl")
    jt, pt = _trainers(chain, frozen)
    jds, pds = _datasets()
    if direction == "jax_to_port":
        jax_save(path, jt.fit(jds, 10, validation_freq=100))
        pt.fit(pds, 20, validation_freq=100, resume_from=load_train_state(path))
        got = pt.train_state()
        start = None
    else:
        start = jax.device_get(jt.fit(_datasets()[0], 0, validation_freq=100).params)
        pt.init(convert.to_torch(convert.pm_vae_state_dict(start)))
        pt.fit(pds, 10, validation_freq=100)
        pt.save_checkpoint(path)
        got = jt.fit(jds, 20, validation_freq=100, resume_from=jax_load(path))
    jt2, _ = _trainers(chain, frozen)
    want = jt2.fit(_datasets()[0], 20, validation_freq=100, initial_params=start)
    assert int(got.step) == int(want.step) == 20
    trainable = pt.trainable
    _assert_close(_flat(got, trainable, str(tmp_path / "got.pkl")),
                  _flat(want, trainable, str(tmp_path / "want.pkl")))


def test_packed_moments_unpack_to_the_canonical_tree():
    """Moments packed by the JAX package's ``pack_chain_params`` unpack to
    the canonical tree exactly, zero where the packed form holds no tap."""
    params, _ = convert.random_pm_vqvae_tree(16, VQ, PC, seed=0)
    pc = params["pixel_cnn"]
    rng = np.random.RandomState(1)
    moments = jax.tree.map(lambda p: rng.randn(*np.shape(p)).astype(np.float32), pc)
    packed = jax.device_get(pack_chain_params(moments, num_resnet=2, num_filters=8))
    enc = {"packed": packed, "rest": {k: v for k, v in moments.items()
                                      if not k.startswith(("up_0_", "dn_0_"))}}
    got = convert._unpack_chain(enc, pc)
    sd_got, sd_want = convert.pixel_cnn_state_dict(got), convert.pixel_cnn_state_dict(moments)
    assert set(sd_got) == set(sd_want)
    repacked = jax.device_get(pack_chain_params(got, num_resnet=2, num_filters=8))
    for a, b in zip(jax.tree.leaves(repacked), jax.tree.leaves(packed)):
        np.testing.assert_array_equal(a, b)
    for name, w in sd_want.items():
        g = sd_got[name]
        kept = g != 0
        np.testing.assert_array_equal(g[kept], w[kept])
        if "conv" not in name or "kernel" not in name:
            np.testing.assert_array_equal(g, w)
    vertical = sd_got["layers.up_0_0_vertical_conv_a.kernel"]
    assert np.all(vertical[2] == 0) and np.all(vertical[:2] != 0)   # rows 0..1 of 3

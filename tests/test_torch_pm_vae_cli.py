"""The port's PM-VAE CLIs, and PM-VAE checkpoints across the two packages.

- ``python -m posterior_matching_torch.train_pm_vae`` in this process on
  the CPU, on small gas files (``pm_vae_gas`` at 16 units, 4 steps, two
  validations) and small MNIST files (``pm_vae_mnist``, its conv stacks
  narrowed and its latent at 4, 2 steps): its run directory, its
  ``model_config.json`` (the configuration's ``model`` block), its
  ``val_loss`` lines, a finite loss; then ``eval_pm_vae_uci`` on the gas
  run: ``uci_results/{nrmse,ac_lls}.npy`` of one value a trial, finite, and
  the JAX CLI's two result lines. The CLIs refuse ``--resume_dir``.
- The port's checkpoint is the JAX package's: the JAX ``load_train_state``
  reads the gas run's ``train_state.pkl`` and the JAX
  ``PosteriorMatchingVAE``, built from its ``model_config.json``, gives the
  port's ``is_log_prob`` with the same normals, within 1e-5 of scale.
- And the other way: a checkpoint the JAX ``Trainer`` wrote (one ``fit``
  step of the JAX CLI's loss and optimizer, with its checkpoint callback)
  loads through ``load_pm_vae`` with every parameter bit for bit, and the
  port's forward equals the JAX one on it.
- ``nrmse_score`` equals the JAX CLI's, the zero-variance exclusion too.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from ml_collections import ConfigDict

os.environ.setdefault("PM_TPU_COMPILE_CACHE", "0")
import eval_pm_vae_uci as jax_eval  # noqa: E402
import train_pm_vae as jax_train  # noqa: E402
from posterior_matching_tpu.data.datasets import ArrayDataset as JaxArrayDataset  # noqa: E402
from posterior_matching_tpu.distributions.normal import MultivariateNormalTriL as JaxTriL  # noqa
from posterior_matching_tpu.models.vae import PosteriorMatchingVAE as JaxVAE  # noqa: E402
from posterior_matching_tpu.train import CheckpointCallback as JaxCheckpoint  # noqa: E402
from posterior_matching_tpu.train import Trainer as JaxTrainer  # noqa: E402
from posterior_matching_tpu.train.state import load_train_state as jax_load  # noqa: E402
from posterior_matching_torch import convert, eval_pm_vae_uci, train_pm_vae  # noqa: E402
from posterior_matching_torch.config import CONFIGS  # noqa: E402
from posterior_matching_torch.data import sources  # noqa: E402

GAS_FLAGS = ["--config.model.encoder_net_config.hidden_units=16",
             "--config.model.decoder_net_config.hidden_units=16",
             "--config.data.train_batch_size=16", "--config.data.val_batch_size=16"]
MNIST_FLAGS = ["--config.model.encoder_net_config.conv_layers="
               "[(4, 5, 1), (4, 5, 2), (8, 5, 1), (8, 5, 2), (8, 7, 1)]",
               "--config.model.decoder_net_config.conv_layers="
               "[(8, 7, 1), (8, 5, 2), (4, 5, 1), (4, 5, 2), (1, 5, 1)]",
               "--config.model.latent_dim=4",
               "--config.data.train_batch_size=8", "--config.data.val_batch_size=8"]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Small files cut from the synthetic stand-ins: gas 64 training, 32
    validation and 48 test rows; MNIST 32 training and 16 test images."""
    root = tmp_path_factory.mktemp("data")
    for dataset, sizes in (("gas", {"train": 64, "val": 32, "test": 48}),
                           ("mnist", {"train": 32, "test": 16})):
        (root / dataset).mkdir()
        for split, n in sizes.items():
            arrays = (sources._synthetic_uci(dataset, split) if dataset == "gas"
                      else sources._synthetic_image(dataset, split))
            np.savez(root / dataset / f"{split}.npz", **{k: v[:n] for k, v in arrays.items()})
    return root


@pytest.fixture(scope="module")
def gas_run(data_dir, tmp_path_factory):
    """The gas run of the training CLI: its directory and printed lines."""
    work = tmp_path_factory.mktemp("work")
    lines = _run(train_pm_vae.main, ["--config", "pm_vae_gas", "--device", "cpu",
                                     "--config.steps=4", "--config.validation_freq=2",
                                     "--config.seed=0", *GAS_FLAGS], data_dir, work)
    return _run_dir(work, "gas"), lines


def _run(main, argv, data_dir, cwd):
    import contextlib
    import io

    old = os.getcwd()
    os.environ["PM_TPU_DATA_DIR"] = str(data_dir)
    os.chdir(cwd)
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            assert main(argv) == 0
    finally:
        os.chdir(old)
        os.environ.pop("PM_TPU_DATA_DIR")
    return printed.getvalue().splitlines()


def _run_dir(work, dataset):
    (run,) = [d for d in os.listdir(work / "runs") if d.startswith(f"pm-vae-{dataset}-")]
    return str(work / "runs" / run)


def _check_run(run_dir, lines, config, overrides, validations):
    assert sorted(os.listdir(run_dir)) == ["model_config.json", "tb", "train_meta.json",
                                           "train_state.pkl"]
    with open(os.path.join(run_dir, "model_config.json")) as fp:
        written = json.load(fp)
    want = CONFIGS[config]()["model"]
    want.update(overrides)
    assert written == json.loads(json.dumps(want))
    steps = [line for line in lines if line.startswith("[step ")]
    assert len(steps) == validations and all("val_loss=" in line for line in steps)
    loss = float(steps[-1].split(" loss=")[1].split()[0])
    assert np.isfinite(loss)


def test_gas_training_and_eval_clis(gas_run, data_dir, tmp_path):
    run_dir, lines = gas_run
    model = CONFIGS["pm_vae_gas"]()["model"]
    overrides = {"encoder_net_config": dict(model["encoder_net_config"], hidden_units=16),
                 "decoder_net_config": dict(model["decoder_net_config"], hidden_units=16)}
    _check_run(run_dir, lines, "pm_vae_gas", overrides, validations=2)
    assert json.load(open(os.path.join(run_dir, "train_meta.json"))) == {"seed": 0, "steps": 4}
    out = _run(eval_pm_vae_uci.main, ["--run_dir", run_dir, "--dataset", "gas", "--device",
                                      "cpu", "--num_instances", "32", "--batch_size", "16",
                                      "--num_samples", "8", "--num_trials", "2"],
               data_dir, tmp_path)
    res = os.path.join(run_dir, "uci_results")
    assert sorted(os.listdir(res)) == ["ac_lls.npy", "nrmse.npy"]
    for name in ("nrmse", "ac_lls"):
        v = np.load(os.path.join(res, f"{name}.npy"))
        assert v.shape == (2,) and np.isfinite(v).all()
    assert any(line.startswith("NRMSE: ") and "±" in line for line in out)
    assert any(line.startswith("AC LL: ") and "±" in line for line in out)


def test_mnist_training_cli(data_dir, tmp_path):
    """The conv family through the CLI: images, MNIST masks and the
    autoregressive GMM partial posterior."""
    lines = _run(train_pm_vae.main, ["--config", "pm_vae_mnist", "--device", "cpu",
                                     "--config.steps=2", "--config.validation_freq=1",
                                     "--config.seed=1", *MNIST_FLAGS], data_dir, tmp_path)
    model = CONFIGS["pm_vae_mnist"]()["model"]
    overrides = {
        "latent_dim": 4,
        "encoder_net_config": {"conv_layers": [(4, 5, 1), (4, 5, 2), (8, 5, 1), (8, 5, 2),
                                               (8, 7, 1)]},
        "decoder_net_config": {"conv_layers": [(8, 7, 1), (8, 5, 2), (4, 5, 1), (4, 5, 2),
                                               (1, 5, 1)]},
    }
    assert set(overrides) <= set(model)
    _check_run(_run_dir(tmp_path, "mnist"), lines, "pm_vae_mnist", overrides, validations=2)


def test_training_cli_resumes_a_run(gas_run, data_dir, tmp_path):
    """``--resume_dir`` (refused before the optimizer state was written in
    optax's layout): the gas run (4 steps) continued to step 6 in a fresh
    run directory, its seed restored; one validation, at 6; the JAX
    package reads the checkpoint, its optax counts at 6."""
    run_dir, _ = gas_run
    lines = _run(train_pm_vae.main, ["--config", "pm_vae_gas", "--device", "cpu",
                                     "--config.steps=6", "--config.validation_freq=2",
                                     "--resume_dir", run_dir, *GAS_FLAGS], data_dir, tmp_path)
    assert any(ln.startswith("Restored training seed 0 from ") for ln in lines)
    assert [ln.split()[1] for ln in lines if ln.startswith("[step ")] == ["6/6]"]
    ts = jax_load(os.path.join(_run_dir(tmp_path, "gas"), "train_state.pkl"))
    assert int(ts.step) == 6
    assert [int(s.count) for s in ts.opt_state if "count" in s._fields] == [6, 6]


@pytest.mark.parametrize("main,argv", [
    (train_pm_vae.main, ["--config", "pm_vae_gas", "--config.model.no_such_entry=1"]),
])
def test_training_cli_refuses(main, argv):
    with pytest.raises(SystemExit):
        main(argv)


def test_jax_package_evaluates_the_ports_checkpoint(gas_run, monkeypatch):
    """The JAX ``load_train_state`` and ``PosteriorMatchingVAE`` on the
    port's run: ``is_log_prob`` with the JAX side's normals, recorded and
    handed to the port, equals the port's."""
    run_dir, _ = gas_run
    store = []

    def tril_sample(self, key, sample_shape=()):
        eps = jax.random.normal(key, tuple(sample_shape) + self.loc.shape, self.loc.dtype)
        jax.debug.callback(lambda e: store.append(np.array(e)), eps, ordered=True)
        return self.loc + jnp.einsum("...ij,...j->...i", self.scale_tril, eps,
                                     precision=jax.lax.Precision.HIGHEST)

    monkeypatch.setattr(JaxTriL, "sample", tril_sample)
    ts = jax_load(os.path.join(run_dir, "train_state.pkl"))
    assert ts.step == 4 and type(ts).__module__ == "posterior_matching_tpu.train.state"
    with open(os.path.join(run_dir, "model_config.json")) as fp:
        jm = JaxVAE.from_config(json.load(fp))
    rng = np.random.RandomState(0)
    x = rng.randn(6, 8).astype(np.float32)
    b = (rng.rand(6, 8) > 0.5).astype(np.float32)
    want = jax.block_until_ready(jax.jit(lambda p: jm.apply(
        {"params": p}, x, b, num_samples=16, method=jm.is_log_prob,
        rngs={"sample": jax.random.PRNGKey(3)}))(ts.params))
    assert len(store) == 2
    port = convert.load_pm_vae(run_dir, device="cpu")
    with torch.no_grad():
        got = port.is_log_prob(torch.from_numpy(x), torch.from_numpy(b),
                               iter([torch.from_numpy(e) for e in store]), num_samples=16)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_load_pm_vae_reads_a_jax_trainer_checkpoint(tmp_path, monkeypatch):
    """One ``fit`` step of the JAX ``Trainer`` with the JAX CLI's loss and
    optimizer at a toy width writes ``train_state.pkl`` through its
    checkpoint callback; ``load_pm_vae`` gives every parameter bit for bit
    and the forward of the JAX model on it (same normals)."""
    cfg = CONFIGS["pm_vae_gas"]()
    cfg["model"]["encoder_net_config"]["hidden_units"] = 8
    cfg["model"]["decoder_net_config"]["hidden_units"] = 8
    config = ConfigDict({k: cfg[k] for k in ("model", "beta", "lr_schedule", "weight_decay")})
    jm = JaxVAE.from_config(cfg["model"])
    rng = np.random.RandomState(1)
    data = {"features": rng.randn(16, 8).astype(np.float32),
            "mask": (rng.rand(16, 8) > 0.5).astype(np.float32)}

    def init_fn(key, batch):
        k1, k2 = jax.random.split(key)
        return jm.init({"params": k1, "sample": k2}, batch["features"], batch["mask"])["params"], {}

    tx, _ = jax_train.build_optimizer(config)
    trainer = JaxTrainer(jax_train.build_loss_fn(jm, config, "features"), init_fn, tx,
                         num_devices=1, seed=0)
    ckpt = str(tmp_path / "train_state.pkl")
    ts = trainer.fit(JaxArrayDataset(data, 8), 1, val_dataset=JaxArrayDataset(data, 8),
                     validation_freq=1, callbacks=[JaxCheckpoint(ckpt)], log_fn=lambda s: None)
    with open(tmp_path / "model_config.json", "w") as fp:
        json.dump(cfg["model"], fp)
    port = convert.load_pm_vae(str(tmp_path), device="cpu")
    want = convert.pm_vae_state_dict(jax.device_get(ts.params))
    got = port.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)
    x, b = data["features"][:4], data["mask"][:4]
    eps = np.random.RandomState(2).randn(4, 16).astype(np.float32)
    monkeypatch.setattr(JaxTriL, "sample", lambda self, key, sample_shape=(): self.loc + jnp.einsum(
        "...ij,...j->...i", self.scale_tril, eps, precision=jax.lax.Precision.HIGHEST))
    want_out = jm.apply({"params": ts.params}, x, b, rngs={"sample": jax.random.PRNGKey(0)})
    with torch.no_grad():
        got_out = port(torch.from_numpy(x), torch.from_numpy(b), iter([torch.from_numpy(eps)]))
    for k in ("reconstruction_ll", "kl", "matching_ll"):
        w = np.asarray(want_out[k])
        np.testing.assert_allclose(got_out[k].numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                   err_msg=k)


def test_nrmse_score_is_the_jax_clis():
    rng = np.random.RandomState(3)
    x = rng.randn(40, 6)
    x[:, 2] = 1.5   # a zero-variance feature
    imp = x[None] + 0.3 * rng.randn(3, 40, 6)
    masks = (rng.rand(3, 40, 6) > 0.5).astype(np.float32)
    xs = np.broadcast_to(x[None], imp.shape)
    np.testing.assert_allclose(eval_pm_vae_uci.nrmse_score(imp, xs, masks),
                               jax_eval.nrmse_score(imp, xs, masks), rtol=1e-12)

"""``use_ema=False``: the VQ-VAE whose codebook the loss learns, against the
JAX package.

- The training forward of the port's ``VQVAE(use_ema=False)`` and the JAX
  ``VQVAE(use_ema=False)`` from the same variables and images: the same
  codes, the loss (reconstruction + ``q_latent + commitment_cost *
  e_latent``) within 1e-6 relative, every gradient, the codebook's
  included, within 1e-5 of its scale. The codebook's gradient reaches it
  through the gather of the chosen codes alone.
- ``train_state.pkl`` both ways: a JAX-written state (the codebook in
  ``params["vq"]``, no ``vq_ema``) trains on in the port, and the port's
  checkpoint loads in the JAX package and gives the port's loss.
- The pipeline on the CPU: ``train_vqvae --config.model.use_ema False``,
  ``train_pm_vqvae`` on that frozen run, ``eval_pm_vqvae`` on its result.
"""
import glob
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posterior_matching_tpu.models.vqvae import VQVAE as JaxVQVAE
from posterior_matching_tpu.train.state import TrainState as JaxTrainState
from posterior_matching_tpu.train.state import load_train_state as jax_load_train_state
from posterior_matching_tpu.train.state import save_train_state as jax_save_train_state
from posterior_matching_torch import convert, eval_pm_vqvae, train_pm_vqvae, train_vqvae
from posterior_matching_torch.train.state import load_train_state
from posterior_matching_torch.train.trainer import vqvae_trainer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = {"output_channels": 1, "embedding_dim": 8, "num_embeddings": 16, "hidden_units": 8,
       "residual_blocks": 1, "residual_hidden_units": 4, "decay": 0.99, "use_ema": False,
       "commitment_cost": 0.25}


def _images(seed, n=4, side=8):
    return np.random.RandomState(seed).rand(n, side, side, 1).astype(np.float32)


@pytest.fixture(scope="module")
def jax_variables():
    jm = JaxVQVAE(**CFG)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 1))))
    assert set(variables) == {"params"} and "embeddings" in variables["params"]["vq"]
    return jm, variables["params"]


def test_loss_and_gradients_match_jax(jax_variables):
    jm, params = jax_variables
    port = convert.vqvae_from_jax(params, {}, CFG, device="cpu")
    assert "vq.embeddings" in dict(port.named_parameters())

    def jax_loss(p, x):
        out = jm.apply({"params": p}, x, is_training=True)
        return out["loss"], out["vq_output"]["encoding_indices"]

    grad_fn = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))
    for i in range(2):
        x = _images(i)
        (loss, codes), jgrads = grad_fn(params, x)
        names, ps = zip(*port.named_parameters())
        out = port(torch.from_numpy(x), is_training=True)
        grads = dict(zip(names, torch.autograd.grad(out["loss"], ps)))
        np.testing.assert_array_equal(out["vq_output"]["encoding_indices"].numpy(),
                                      np.asarray(codes))
        np.testing.assert_allclose(out["loss"].item(), float(loss), rtol=1e-6)
        want_sd = convert.vqvae_state_dict(jax.device_get(jgrads), None)
        assert set(want_sd) == set(grads)
        for name, g in grads.items():
            want = want_sd[name]
            np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                       atol=1e-5 * max(np.abs(want).max(), 1e-6), err_msg=name)
        # rows of codes no latent chose get no gradient: the gather alone
        unused = np.setdiff1d(np.arange(CFG["num_embeddings"]), np.asarray(codes))
        assert not grads["vq.embeddings"][unused].any()


def test_train_state_both_ways(jax_variables, tmp_path):
    jm, params = jax_variables
    path = str(tmp_path / "jax.pkl")
    jax_save_train_state(path, JaxTrainState(params=params, state={}, opt_state=None,
                                             ema_params=None, step=0))
    ts = load_train_state(path)
    model = convert.vqvae_from_jax(ts.params, ts.state, CFG, device="cpu")
    trainer = vqvae_trainer(model, {"learning_rate": 1e-3}, device="cpu")
    trainer.init()
    assert "vq.embeddings" in trainer.optimizer.params
    before = model.vq.embeddings.detach().clone()
    x = torch.from_numpy(_images(5))
    trainer.train_step({"image": x})
    assert not torch.equal(model.vq.embeddings, before)
    out = str(tmp_path / "port.pkl")
    trainer.save_checkpoint(out)
    back = jax_load_train_state(out)
    assert back.state == {} and "embeddings" in back.params["vq"]
    np.testing.assert_array_equal(back.params["vq"]["embeddings"],
                                  model.vq.embeddings.detach().numpy())
    want = jm.apply({"params": back.params}, x.numpy())["loss"]
    with torch.no_grad():
        got = model(x)["loss"]
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_pipeline_from_the_command_line(tmp_path, monkeypatch):
    monkeypatch.setenv("PM_TPU_DATA_DIR", str(tmp_path / "data"))
    (tmp_path / "data" / "mnist").mkdir(parents=True)
    rng = np.random.RandomState(0)
    for split, n in (("train", 8), ("test", 8)):
        np.savez(tmp_path / "data" / "mnist" / f"{split}.npz",
                 image=rng.randint(0, 256, (n, 28, 28, 1)).astype(np.uint8),
                 label=np.zeros(n, np.int64))
    monkeypatch.chdir(tmp_path)
    common = ["--device", "cpu", "--config.steps", "2", "--config.validation_freq", "2",
              "--config.seed", "0", "--config.data.train_batch_size=4",
              "--config.data.val_batch_size=4"]
    assert train_vqvae.main([
        "--config", "vqvae_mnist", *common, "--config.model.use_ema", "False",
        "--config.model.hidden_units=8", "--config.model.residual_hidden_units=4",
        "--config.model.embedding_dim=8", "--config.model.num_embeddings=16"]) == 0
    (run1,) = glob.glob("runs/vqvae-mnist-*")
    stage1 = load_train_state(str(Path(run1, "train_state.pkl")))
    assert stage1.state == {} and "embeddings" in stage1.params["vq"]
    assert train_pm_vqvae.main([
        "--config", "pm_vqvae_mnist", *common, "--config.vqvae_dir", run1,
        "--config.pixel_cnn.num_resnet=1", "--config.pixel_cnn.num_filters=8",
        "--config.conditional_dim=16"]) == 0
    (run2,) = glob.glob("runs/pm-vqvae-mnist-*")
    stage2 = load_train_state(str(Path(run2, "train_state.pkl")))
    # the frozen codebook came through unchanged, in the params
    np.testing.assert_array_equal(stage2.params["vqvae"]["vq"]["embeddings"],
                                  stage1.params["vq"]["embeddings"])
    assert eval_pm_vqvae.main([
        "--run_dir", run2, "--dataset", "mnist", "--mask_generator", "MNISTMaskGenerator",
        "--num_instances", "4", "--batch_size", "2", "--num_samples", "2", "--num_trials", "1",
        "--device", "cpu"]) == 0
    assert np.load(Path(run2, "imputation_results", "psnrs.npy")).shape == (1, 4)

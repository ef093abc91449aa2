"""The port's PM-VQVAE training CLIs, stage 1 then stage 2, against the JAX
package's reading of their run directories.

``python -m posterior_matching_torch.train_vqvae`` and then
``python -m posterior_matching_torch.train_pm_vqvae --chain_segment 2`` on
the CPU at toy widths on small synthetic MNIST files (2 steps, one
validation each):

- each run directory holds the JAX layout's files; the step lines log the
  JAX CLIs' metrics; ``model_config.json`` is the configuration's ``model``
  block; stage 2's ``config.json`` holds the configuration's own keys and
  nothing of ``--chain_segment``;
- the JAX package's ``load_train_state`` reads stage 1's checkpoint, and
  the JAX ``VQVAE`` built from ``model_config.json`` gives the port's loss
  on a batch within 1e-5 relative;
- stage 2 read stage 1's directory: its checkpoint holds stage 1's VQ-VAE
  and codebook unchanged; the JAX ``PMVQVAE.from_config`` builds from its
  ``config.json`` and ``vqvae_config.json`` as written and gives the
  port's log-likelihoods within 1e-4 relative (float32, the port through
  the segment path, JAX unfused).

And both CLIs refuse what they do not take.
"""
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from posterior_matching_tpu.models.pm_vqvae import PMVQVAE as JaxPMVQVAE
from posterior_matching_tpu.models.vqvae import VQVAE as JaxVQVAE
from posterior_matching_tpu.train.state import load_train_state as jax_load_train_state
from posterior_matching_torch import convert, train_pm_vqvae, train_vqvae
from posterior_matching_torch.config import pm_vqvae_mnist, vqvae_mnist
from posterior_matching_torch.data import sources
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

STAGE1 = ["--config.data.train_batch_size=8", "--config.data.val_batch_size=8",
          "--config.model.hidden_units=8", "--config.model.residual_hidden_units=4",
          "--config.model.embedding_dim=8", "--config.model.num_embeddings=16"]
STAGE2 = ["--config.data.train_batch_size=4", "--config.data.val_batch_size=8",
          "--config.pixel_cnn.num_resnet=3", "--config.pixel_cnn.num_filters=8",
          "--config.conditional_dim=16"]


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    """Small MNIST files cut from the synthetic stand-in: 32 training and
    16 test images."""
    monkeypatch.setenv("PM_TPU_DATA_DIR", str(tmp_path / "data"))
    (tmp_path / "data" / "mnist").mkdir(parents=True)
    for split, n in (("train", 32), ("test", 16)):
        arrays = sources._synthetic_image("mnist", split)
        np.savez(tmp_path / "data" / "mnist" / f"{split}.npz",
                 **{k: v[:n] for k, v in arrays.items()})
    return tmp_path / "data"


def _run(main, argv, capsys):
    assert main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    (run_dir,) = [ln.split(": ")[1] for ln in lines if ln.startswith("Using run directory")]
    steps = [ln for ln in lines if ln.startswith("[step ")]
    assert len(steps) == 1 and steps[0].startswith("[step 2/2] ")
    return run_dir, steps[0]


def test_stage1_then_stage2_and_jax_reads_both(data_dir, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    run1, line = _run(train_vqvae.main, ["--config", "vqvae_mnist", "--device", "cpu",
                                         "--config.steps", "2", "--config.validation_freq", "2",
                                         "--config.seed", "3", *STAGE1], capsys)
    assert run1.startswith(os.path.join("runs", "vqvae-mnist-"))
    assert sorted(os.listdir(run1)) == ["model_config.json", "tb", "train_meta.json",
                                        "train_state.pkl"]
    for key in ("loss", "perplexity", "reconstruction_loss", "vq_loss", "steps_per_sec",
                "val_loss", "val_perplexity"):
        assert f" {key}=" in line, key
    with open(os.path.join(run1, "model_config.json")) as fp:
        model_config = json.load(fp)
    assert set(model_config) == set(vqvae_mnist()["model"]) and model_config["hidden_units"] == 8

    ts1 = jax_load_train_state(os.path.join(run1, "train_state.pkl"))
    assert int(ts1.step) == 2 and set(ts1.state) == {"vq_ema"}
    x = np.random.RandomState(4).rand(4, 28, 28, 1).astype(np.float32)
    want = JaxVQVAE(**model_config).apply({"params": ts1.params, **ts1.state}, x)["loss"]
    port = convert.vqvae_from_jax(ts1.params, ts1.state, model_config, device="cpu")
    with torch.no_grad():
        got = port(torch.from_numpy(x))["loss"]
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)

    run2, line = _run(train_pm_vqvae.main, [
        "--config", "pm_vqvae_mnist", "--device", "cpu", "--config.vqvae_dir", run1,
        "--config.steps", "2", "--config.validation_freq", "2", "--config.seed", "5",
        "--chain_segment", "2", *STAGE2], capsys)
    assert run2.startswith(os.path.join("runs", "pm-vqvae-mnist-"))
    assert sorted(os.listdir(run2)) == ["config.json", "tb", "train_meta.json", "train_state.pkl",
                                        "vqvae_config.json"]
    assert " val_loss=" in line
    with open(os.path.join(run2, "config.json")) as fp:
        config = json.load(fp)
    with open(os.path.join(run2, "vqvae_config.json")) as fp:
        assert json.load(fp) == model_config
    assert set(config) == set(pm_vqvae_mnist()) and "chain_segment" not in json.dumps(config)
    assert config["vqvae_dir"] == run1 and config["pixel_cnn"]["num_indices"] == 16

    ts2 = jax_load_train_state(os.path.join(run2, "train_state.pkl"))
    for a, b in zip(jax.tree.leaves(ts2.params["vqvae"]), jax.tree.leaves(ts1.params)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(ts2.state["vq_ema"]["vqvae"]),
                    jax.tree.leaves(ts1.state["vq_ema"])):
        np.testing.assert_array_equal(a, b)
    jm = JaxPMVQVAE.from_config(config["conditional_dim"], model_config, config["pixel_cnn"],
                                compute_dtype=config.get("compute_dtype"))
    b = (np.random.RandomState(6).rand(4, 28, 28, 1) > 0.5).astype(np.float32)
    want = jm.apply({"params": ts2.params, **ts2.state}, x, b, training=False)
    port = convert.load_pm_vqvae(run2, device="cpu", chain_segment=2)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)


def test_stage1_resumes_a_run(data_dir, tmp_path, monkeypatch, capsys):
    """``--resume_dir`` (refused before the optimizer state was written in
    optax's layout): a 2-step stage-1 run continued to step 3 in a fresh
    run directory, its seed restored; the codebook's EMA state and Adam's
    count carried on, as the JAX package reads them."""
    monkeypatch.chdir(tmp_path)
    argv = ["--config", "vqvae_mnist", "--device", "cpu", "--config.validation_freq", "1",
            *STAGE1]
    assert train_vqvae.main([*argv, "--config.steps", "2", "--config.seed", "3"]) == 0
    lines = capsys.readouterr().out.splitlines()
    (first,) = [ln.split(": ")[1] for ln in lines if ln.startswith("Using run directory")]
    (tmp_path / "again").mkdir()
    monkeypatch.chdir(tmp_path / "again")
    assert train_vqvae.main([*argv, "--config.steps", "3", "--resume_dir",
                             str(tmp_path / first)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert any(ln.startswith("Restored training seed 3 from ") for ln in lines)
    assert [ln.split()[1] for ln in lines if ln.startswith("[step ")] == ["3/3]"]
    (second,) = [ln.split(": ")[1] for ln in lines if ln.startswith("Using run directory")]
    ts1 = jax_load_train_state(str(tmp_path / first / "train_state.pkl"))
    ts2 = jax_load_train_state(os.path.join(second, "train_state.pkl"))
    assert int(ts2.step) == 3 and int(ts2.opt_state[0].count) == 3
    size1, size2 = (ts.state["vq_ema"]["vq"]["ema_cluster_size"] for ts in (ts1, ts2))
    assert not np.array_equal(size1, size2)


@pytest.mark.parametrize("main,argv", [
    (train_vqvae.main, ["--config", "pm_vqvae_mnist"]),
    (train_vqvae.main, ["--config", "vqvae_mnist", "--config.model.nope=1"]),
    (train_pm_vqvae.main, ["--config", "pm_vqvae_mnist", "--chain_segment", "0"]),
    (train_pm_vqvae.main, ["--config", "pm_vqvae_mnist", "--chain_segment", "pairs"]),
    (train_pm_vqvae.main, ["--config", "pm_vqvae_mnist", "--config.compute_dtype=float16"]),
])
def test_clis_refuse_what_they_do_not_take(main, argv):
    with pytest.raises(SystemExit):
        main([*argv, "--device", "cpu"])

"""The port's PM-VDVAE training CLI and its input pipeline against the JAX
package's.

- ``load_arrays`` gives the JAX package's arrays exactly, from files and
  from the synthetic stand-in (the same crc32 seeds); ``load_datasets``
  gives the JAX package's batch stream exactly for the same shuffle seed,
  over two epochs.
- ``init_pm_vdvae_tree`` has the JAX initialisation's structure, its zero
  leaves where the JAX init has them and its ones for the gain (at an 8x8
  geometry).
- ``python -m posterior_matching_torch.train_pm_vdvae`` on the CPU at a
  tiny model (width 16, latent 4) on small synthetic MNIST files, fused
  decoder on: 2 steps, one validation; its run directory; its
  ``model_config.json`` holds exactly the keys of ``configs/
  pm_vdvae_mnist.py``'s ``model`` block (``fused_chain`` is the run's
  execution option, not written), so the JAX ``from_config`` builds it as
  written on the CPU; the JAX package's ``load_train_state`` reads the
  checkpoint, and that JAX model gives the port's loss on a batch with the
  same injected normals, within 1e-4 relative (the port's fused runs sum
  in another order than the JAX package's unfused blocks); the port loads
  the run unfused unless asked for the fused decoder.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posterior_matching_tpu.data import datasets as jax_datasets
from posterior_matching_tpu.data import sources as jax_sources
from posterior_matching_tpu.distributions import normal as jax_normal
from posterior_matching_tpu.models.vdvae import PosteriorMatchingVDVAE as JaxVDVAE
from posterior_matching_tpu.train.state import load_train_state as jax_load_train_state
from configs.pm_vdvae_mnist import get_config as jax_pm_vdvae_mnist
from posterior_matching_torch import cli, convert, train_pm_vdvae
from posterior_matching_torch.config import CONFIGS
from posterior_matching_torch.data import datasets, sources
from posterior_matching_torch.models.vdvae import parse_layer_string
from posterior_matching_torch.train.trainer import pm_vdvae_loss

TINY = ["--config.model.width=16", "--config.model.latent_dim=4",
        "--config.model.num_mixtures=2",
        "--config.model.encoder_blocks=28x2,28d4,7x2,7d7,1x2",
        "--config.model.decoder_blocks=1x2,7m1,7x2,28m7,28x2"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The CLI's toy runs on one intra-op thread: the suite's parallel
    workers, each with torch's default pool of one thread a core,
    oversubscribe the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    """Small MNIST files cut from the synthetic stand-in: 48 training and
    32 test images."""
    monkeypatch.setenv("PM_TPU_DATA_DIR", str(tmp_path / "data"))
    (tmp_path / "data" / "mnist").mkdir(parents=True)
    for split, n in (("train", 48), ("test", 32)):
        arrays = sources._synthetic_image("mnist", split)
        np.savez(tmp_path / "data" / "mnist" / f"{split}.npz",
                 **{k: v[:n] for k, v in arrays.items()})
    return tmp_path / "data"


def test_load_arrays_match_jax(data_dir, monkeypatch):
    for split in ("train", "test"):
        got, want = sources.load_arrays("mnist", split), jax_sources.load_arrays("mnist", split)
        assert set(got) == set(want) == {"image", "label"}
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    monkeypatch.setenv("PM_TPU_DATA_DIR", str(data_dir / "absent"))
    with pytest.warns(UserWarning, match="synthetic"):
        got = sources.load_arrays("mnist", "test")
    want = jax_sources.load_arrays("mnist", "test")
    assert got["image"].shape == (1024, 28, 28, 1) and got["image"].dtype == np.uint8
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def test_load_datasets_stream_matches_jax(data_dir):
    config = {"dataset": "mnist", "train_split": "train", "validation_split": "test",
              "train_batch_size": 16, "val_batch_size": 16, "shuffle_seed": 5}
    port = datasets.load_datasets(config, normalize_images=False)
    jax_ds = jax_datasets.load_datasets(config, normalize_images=False)
    for got_ds, want_ds, n in zip(port, jax_ds, (3, 2)):   # 48 // 16, 32 // 16
        for _ in range(2):   # two epochs: the shuffle stream continues
            got, want = list(got_ds), list(want_ds)
            assert len(got) == len(want) == n
            for g, w in zip(got, want):
                assert set(g) == set(w) == {"image", "label"}
                assert g["image"].dtype == np.float32 and g["image"].max() > 1.0
                for k in g:
                    np.testing.assert_array_equal(g[k], w[k])


def test_init_tree_has_the_jax_init_structure():
    config = dict(CONFIGS["pm_vdvae_mnist"]()["model"], image_shape=(8, 8, 1),
                  width=16, latent_dim=4, num_mixtures=2,
                  encoder_blocks="8x2,8d2,4x2,4d4,1x2", decoder_blocks="1x2,4m1,4x2,8m4,8x2")
    x = np.zeros((1, 8, 8, 1), np.float32)
    init = jax.jit(JaxVDVAE.from_config(dict(config, fused_chain=False)).init)
    want = init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, x, x)
    want = convert.pm_vdvae_state_dict(jax.device_get(want["params"]))
    got = convert.pm_vdvae_state_dict(convert.init_pm_vdvae_tree(config, seed=0))
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        assert np.all(got[name] == 0) == np.all(w == 0), name
        if name.endswith("gain"):
            np.testing.assert_array_equal(got[name], w)


@pytest.fixture
def inject(monkeypatch):
    """Hands the JAX side's posterior samples the normals of a list, in
    call order (under ``jit`` they enter as constants)."""
    feed = []

    def diag_sample(self, key, sample_shape=()):
        return self.loc + self.scale_diag * jnp.asarray(feed.pop(0))

    monkeypatch.setattr(jax_normal.MultivariateNormalDiag, "sample", diag_sample)
    return feed


def test_cli_trains_and_jax_reads_its_checkpoint(data_dir, tmp_path, monkeypatch, capsys,
                                                 inject):
    monkeypatch.chdir(tmp_path)
    rc = train_pm_vdvae.main(["--config", "pm_vdvae_mnist", "--device", "cpu",
                              "--config.steps", "2", "--config.validation_freq", "2",
                              "--config.seed", "3", "--config.model.fused_chain=True", *TINY])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    (run_dir,) = [ln.split(": ")[1] for ln in lines if ln.startswith("Using run directory")]
    assert run_dir.startswith(os.path.join("runs", "pm-vdvae-mnist-"))
    assert sorted(os.listdir(run_dir)) == ["model_config.json", "tb", "train_meta.json",
                                           "train_state.pkl"]
    steps = [ln for ln in lines if ln.startswith("[step ")]
    assert len(steps) == 1 and steps[0].startswith("[step 2/2] ")
    for key in ("loss", "bpd", "kl", "pm_kl", "reconstruction_ll", "steps_per_sec",
                "learning_rate", "val_loss", "val_bpd"):
        assert f" {key}=" in steps[0], key
    with open(os.path.join(run_dir, "train_meta.json")) as fp:
        assert json.load(fp) == {"seed": 3, "steps": 2}
    with open(os.path.join(run_dir, "model_config.json")) as fp:
        model_config = json.load(fp)
    assert set(model_config) == set(jax_pm_vdvae_mnist().model.to_dict())
    assert model_config["width"] == 16

    ts = jax_load_train_state(os.path.join(run_dir, "train_state.pkl"))
    assert int(ts.step) == 2
    rng = np.random.RandomState(4)
    x = rng.randint(0, 256, (2, 28, 28, 1)).astype(np.float32)
    b = (rng.rand(2, 28, 28, 1) > 0.5).astype(np.float32)
    eps = [rng.randn(2, r, r, 4).astype(np.float32)
           for r, _ in parse_layer_string(model_config["decoder_blocks"])]
    inject.extend(eps)
    jm = JaxVDVAE.from_config(model_config)

    @jax.jit
    def jax_loss(params):
        out = jm.apply({"params": params}, x, b, rngs={"sample": jax.random.PRNGKey(5)})
        return -jnp.mean(out["reconstruction_ll"] - out["kl"]) + jnp.mean(out["pm_kl"])

    want = jax_loss(ts.ema_params)
    assert not inject   # one sample per decoder block
    assert convert.load_pm_vdvae(run_dir, device="cpu", fused_chain=True).decoder.fused
    port = convert.load_pm_vdvae(run_dir, device="cpu")
    assert not port.decoder.fused
    with torch.no_grad():
        got = pm_vdvae_loss(port, {"image": torch.from_numpy(x), "mask": torch.from_numpy(b)},
                            iter(torch.from_numpy(e) for e in eps))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)


def test_cli_resumes_a_run(data_dir, tmp_path, monkeypatch, capsys):
    """``--resume_dir`` (refused before the optimizer state was written in
    optax's layout): a 1-step run continued to step 2 in a fresh run
    directory, its seed restored from ``train_meta.json``, its EMA carried
    on, its one step logged at 2/2."""
    monkeypatch.chdir(tmp_path)
    argv = ["--config", "pm_vdvae_mnist", "--device", "cpu", "--config.validation_freq", "1",
            "--config.model.fused_chain=True", *TINY]
    assert train_pm_vdvae.main([*argv, "--config.steps", "1", "--config.seed", "3"]) == 0
    lines = capsys.readouterr().out.splitlines()
    (first,) = [ln.split(": ")[1] for ln in lines if ln.startswith("Using run directory")]
    (tmp_path / "again").mkdir()
    monkeypatch.chdir(tmp_path / "again")
    assert train_pm_vdvae.main([*argv, "--config.steps", "2", "--resume_dir",
                                str(tmp_path / first)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert any(ln.startswith("Restored training seed 3 from ") for ln in lines)
    assert [ln.split()[1] for ln in lines if ln.startswith("[step ")] == ["2/2]"]
    (second,) = [ln.split(": ")[1] for ln in lines if ln.startswith("Using run directory")]
    with open(os.path.join(second, "train_meta.json")) as fp:
        assert json.load(fp) == {"seed": 3, "steps": 2}
    ts1 = jax_load_train_state(str(tmp_path / first / "train_state.pkl"))
    ts2 = jax_load_train_state(os.path.join(second, "train_state.pkl"))
    assert int(ts1.step) == 1 and int(ts2.step) == 2
    assert int(ts2.opt_state[1].count) == 2   # optax's ScaleByAdamState, by pickle
    moved = [not np.array_equal(a, b) for a, b in zip(jax.tree.leaves(ts1.ema_params),
                                                      jax.tree.leaves(ts2.ema_params))]
    assert any(moved)


@pytest.mark.parametrize("argv", [["--config.model.nope=1"], ["--config.steps"],
                                  ["--steps", "3"]])
def test_cli_refuses_what_it_does_not_take(argv, capsys):
    with pytest.raises(SystemExit):
        train_pm_vdvae.main(["--config", "pm_vdvae_mnist", "--device", "cpu", *argv])


def test_config_overrides():
    config = CONFIGS["pm_vdvae_mnist"]()
    cli.apply_overrides(config, cli.parse_overrides(
        ["--config.steps", "7", "--config.lr=1.5e-4", "--config.model.fused_chain=True",
         "--config.model.decoder_blocks=1x2,28m1", "--config.seed", "None"]))
    assert config["steps"] == 7 and config["lr"] == 1.5e-4 and config["seed"] is None
    assert config["model"]["fused_chain"] is True
    assert config["model"]["decoder_blocks"] == "1x2,28m1"
    assert CONFIGS["pm_vdvae_mnist"]()["steps"] == 500000

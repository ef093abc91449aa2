"""The port's three image eval CLIs on the CPU, at toy sizes.

- The slice: ``eval_pm_vqvae.evaluate_batch`` on a tiny PM-VQVAE (weights
  from ``convert.random_pm_vqvae_tree``, the configuration of
  ``test_torch_pm_vqvae.py``), with the masks and the Gumbel noise of the
  JAX ``pm_vqvae_impute``, gives the JAX CLI's per-instance PSNR
  (``eval_pm_vqvae.py:92-94`` on the JAX imputations) to 1e-5 dB.
- ``eval_pm_vqvae.main([..., "--device", "cpu"])`` on that model's run
  directory in the JAX layout (written by the JAX package's
  ``save_train_state``) writes the JAX CLI's file set; ``eval_summary.json``
  has the keys of the JAX CLI's summary in ``artifacts/``; the arrays'
  shapes and the summary agree.
- The flagship pipeline from the command line, shrunk: ``train_vqvae
  --config vqvae_celeb_a``, ``train_pm_vqvae --config pm_vqvae_celeb_a``,
  then ``eval_pm_vqvae --dataset celeb_a`` on small CelebA files.
- The PM-VDVAE CLIs' per-batch work on a ``TINY_CONFIG`` model, with the
  masks of the JAX CLIs' ``add_mask`` and the standard normals of their
  jitted steps (recorded in order by a ``jax.debug.callback`` put into
  ``MultivariateNormal{Diag,TriL}.sample`` in this test only): the
  imputation CLI's ``evaluate_batch`` gives the PSNR of the JAX step
  (``eval_pm_vdvae_imputation.py:88-97``) to 1e-5 dB and its imputations
  over 255 to one rounding step (1/255) of the mean, which agrees to 1e-4
  relative, and on the observed pixels to one float32 ulp; the likelihood CLI's gives ``px`` and ``px - pxu`` of the JAX
  ``vdvae_is_log_probs``, unchunked and in chunks, to 1e-4 relative, and
  its ``summarize`` the JAX CLI's BPD and masked per-trial means
  (``eval_pm_vdvae_likelihood.py:150-170``).
- ``eval_pm_vdvae_imputation`` and ``eval_pm_vdvae_likelihood`` on a
  ``TINY_CONFIG`` run directory (8x8 images): the JAX CLIs' file sets and
  shapes, the BPD from ``x_lls``, a ragged last chunk.
"""
import glob
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from posterior_matching_tpu import masking as jax_masking
from posterior_matching_tpu.distributions import normal as jax_normal
from posterior_matching_tpu.models.pm_vqvae import PMVQVAE as JaxPMVQVAE
from posterior_matching_tpu.models.pm_vqvae import pm_vqvae_impute as jax_pm_vqvae_impute
from posterior_matching_tpu.models.vdvae import PosteriorMatchingVDVAE as JaxVDVAE
from posterior_matching_tpu.models.vdvae import vdvae_impute as jax_vdvae_impute
from posterior_matching_tpu.models.vdvae import vdvae_is_log_probs as jax_vdvae_is_log_probs
from posterior_matching_tpu.train.state import TrainState, save_train_state
from posterior_matching_torch import (
    convert,
    eval_pm_vdvae_imputation,
    eval_pm_vdvae_likelihood,
    eval_pm_vqvae,
    train_pm_vqvae,
    train_vqvae,
)
from test_torch_pm_vqvae import COND_DIM, NUM_SAMPLES, PC_CONFIG, VQ_CONFIG, jax_key_noise
from test_torch_vdvae import MODE_TOL, TINY_CONFIG

REPO = Path(__file__).resolve().parents[1]
PSNR_TOL = 1e-5   # dB
JAX_SUMMARY = REPO / "artifacts/pm-vqvae-celeb_a-20260820-142531/imputation_results/eval_summary.json"
IMPUTATION_FILES = ["embedder.txt", "f_scores.npy", "prd_data.npy", "psnrs.npy"]


def _images(tmp_path, monkeypatch, name, splits, shape):
    """Random uint8 images ``<PM_TPU_DATA_DIR>/<name>/<split>.npz``."""
    monkeypatch.setenv("PM_TPU_DATA_DIR", str(tmp_path / "data"))
    (tmp_path / "data" / name).mkdir(parents=True)
    rng = np.random.RandomState(0)
    for split, n in splits.items():
        np.savez(tmp_path / "data" / name / f"{split}.npz",
                 image=rng.randint(0, 256, (n, *shape)).astype(np.uint8),
                 label=np.zeros(n, np.int64))


@pytest.fixture(scope="module")
def tiny_pm_vqvae():
    """A tiny PM-VQVAE's JAX-layout tree, a batch of 16x16x3 images and
    masks, the JAX ``pm_vqvae_impute`` imputations and their Gumbel
    noise."""
    params, state = convert.random_pm_vqvae_tree(COND_DIM, VQ_CONFIG, PC_CONFIG, seed=1)
    rng = np.random.RandomState(0)
    x = rng.rand(2, 16, 16, 3).astype(np.float32)
    b = (rng.rand(2, 16, 16, 1) > 0.5).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax_pm_vqvae_impute(
        JaxPMVQVAE.from_config(COND_DIM, VQ_CONFIG, PC_CONFIG), {"params": params, **state},
        jnp.asarray(x), jnp.asarray(b), key, num_samples=NUM_SAMPLES))
    return params, state, x, b, jax_key_noise(key, 4, 4, NUM_SAMPLES * 2, 16), want


def test_evaluate_batch_matches_jax(tiny_pm_vqvae):
    params, state, x, b, noise, want = tiny_pm_vqvae
    mse = jnp.mean((jnp.mean(jnp.asarray(want), axis=1) - x) ** 2, axis=(1, 2, 3))
    jax_psnr = np.asarray(-10.0 * jnp.log10(mse))
    model = convert.pm_vqvae_from_jax(params, state, COND_DIM, VQ_CONFIG, PC_CONFIG,
                                      device="cpu")
    psnr, imp = eval_pm_vqvae.evaluate_batch(model, torch.from_numpy(x), torch.from_numpy(b),
                                             NUM_SAMPLES, noise=torch.from_numpy(noise))
    assert imp.shape == want.shape and psnr.shape == (2,)
    np.testing.assert_allclose(psnr.numpy(), jax_psnr, rtol=0, atol=PSNR_TOL)


def test_eval_pm_vqvae_writes_the_jax_cli_s_results(tiny_pm_vqvae, tmp_path, monkeypatch,
                                                    capsys):
    params, state, *_ = tiny_pm_vqvae
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    save_train_state(str(run_dir / "train_state.pkl"), TrainState(
        params=params, state=state, opt_state=optax.adam(1e-3).init(params), step=3))
    (run_dir / "vqvae_config.json").write_text(json.dumps(VQ_CONFIG))
    (run_dir / "config.json").write_text(json.dumps({"conditional_dim": COND_DIM,
                                                     "pixel_cnn": PC_CONFIG}))
    _images(tmp_path, monkeypatch, "tiny16", {"test": 10}, (16, 16, 3))
    rc = eval_pm_vqvae.main(["--run_dir", str(run_dir), "--dataset", "tiny16",
                             "--mask_generator", "RectangleMaskGenerator", "--num_instances",
                             "9", "--batch_size", "4", "--num_samples", "2", "--num_trials",
                             "2", "--device", "cpu"])
    assert rc == 0
    res = run_dir / "imputation_results"
    assert sorted(p.name for p in res.iterdir()) == sorted([*IMPUTATION_FILES,
                                                            "eval_summary.json"])
    psnrs, prd_data = np.load(res / "psnrs.npy"), np.load(res / "prd_data.npy")
    f_scores = np.load(res / "f_scores.npy")
    assert psnrs.shape == (2, 8) and np.isfinite(psnrs).all()   # 9 // 4 batches of 4
    assert prd_data.shape == (2, 2, 2, 1001) and f_scores.shape == (2, 2)
    summary = json.loads((res / "eval_summary.json").read_text())
    assert set(summary) == set(json.loads(JAX_SUMMARY.read_text()))
    assert summary["num_instances"] == 9 and summary["num_trials"] == 2
    np.testing.assert_allclose(summary["per_trial_psnr"], psnrs.mean(1), rtol=1e-6)
    assert summary["precision"] == pytest.approx(f_scores[:, 1].mean())
    assert (res / "embedder.txt").read_text() == "random_conv\n"
    out = capsys.readouterr().out
    assert "****RESULTS****" in out and "Wall time: requests " in out


def test_celeb_a_pipeline_from_the_command_line(tmp_path, monkeypatch):
    """train_vqvae, train_pm_vqvae and eval_pm_vqvae on CelebA, shrunk."""
    _images(tmp_path, monkeypatch, "celeb_a", {"train": 8, "validation": 4, "test": 4},
            (218, 178, 3))
    monkeypatch.chdir(tmp_path)
    common = ["--device", "cpu", "--config.steps", "2", "--config.validation_freq", "2",
              "--config.seed", "0", "--config.data.train_batch_size=4",
              "--config.data.val_batch_size=4"]
    assert train_vqvae.main([
        "--config", "vqvae_celeb_a", *common, "--config.model.hidden_units=8",
        "--config.model.residual_hidden_units=4", "--config.model.embedding_dim=8",
        "--config.model.num_embeddings=16"]) == 0
    (run1,) = glob.glob("runs/vqvae-celeb_a-*")
    assert train_pm_vqvae.main([
        "--config", "pm_vqvae_celeb_a", *common, "--config.vqvae_dir", run1,
        "--config.pixel_cnn.num_resnet=1", "--config.pixel_cnn.num_filters=8",
        "--config.conditional_dim=16"]) == 0
    (run2,) = glob.glob("runs/pm-vqvae-celeb_a-*")
    config = json.loads(Path(run2, "config.json").read_text())
    assert config["pixel_cnn"]["num_indices"] == 16 and config["data"]["dataset"] == "celeb_a"
    assert eval_pm_vqvae.main([
        "--run_dir", run2, "--dataset", "celeb_a", "--mask_generator", "CelebAMaskGenerator",
        "--num_instances", "4", "--batch_size", "2", "--num_samples", "2", "--num_trials", "1",
        "--device", "cpu"]) == 0
    assert np.load(Path(run2, "imputation_results", "psnrs.npy")).shape == (1, 4)


@pytest.fixture(scope="module")
def tiny_pm_vdvae():
    """A ``TINY_CONFIG`` PM-VDVAE in both packages and three 8x8 images in
    [0, 255]."""
    tree = convert.random_pm_vdvae_tree(TINY_CONFIG, seed=2)
    x = np.random.RandomState(0).randint(0, 256, (3, 8, 8, 1)).astype(np.float32)
    return (JaxVDVAE.from_config(TINY_CONFIG), {"params": tree},
            convert.pm_vdvae_from_jax(tree, TINY_CONFIG, device="cpu"), x)


@pytest.fixture
def jax_normals(monkeypatch):
    """The JAX side's standard normals in the order its jitted steps draw
    them."""
    store = []

    def keep(eps):
        jax.debug.callback(lambda e: store.append(torch.from_numpy(np.array(e))), eps,
                           ordered=True)

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


def _jax_masks(x, key):
    """The JAX CLIs' masks: ``add_mask`` with the step key's first half."""
    k_mask, k_rest = jax.random.split(key)
    mask_fn = jax_masking.get_mask_generator("ImageBernoulliMaskGenerator")
    return jax_masking.add_mask({"image": jnp.asarray(x)}, k_mask, mask_fn)["mask"], k_rest


def test_vdvae_imputation_evaluate_batch_matches_jax(tiny_pm_vdvae, jax_normals):
    jm, variables, port, x = tiny_pm_vdvae
    b, k_sample = _jax_masks(x, jax.random.PRNGKey(7))

    @jax.jit
    def eval_step(x, b, k):   # eval_pm_vdvae_imputation.py:88-97 after add_mask
        imputations = jax_vdvae_impute(jm, variables, x, b, k, num_samples=3)
        mse = jnp.mean((jnp.mean(imputations, axis=1) / 255.0 - x / 255.0) ** 2,
                       axis=(1, 2, 3))
        return -10.0 * jnp.log10(mse), imputations / 255.0

    want_psnr, want_imp = (np.asarray(a) for a in eval_step(jnp.asarray(x), b, k_sample))
    jax.effects_barrier()
    assert len(jax_normals) == 3 * 6   # one posterior sample per decoder block
    psnr, imp = eval_pm_vdvae_imputation.evaluate_batch(
        port, torch.from_numpy(x), torch.from_numpy(np.array(b)), 3,
        noise=iter(jax_normals))
    assert imp.shape == want_imp.shape == (3, 3, 8, 8, 1)
    np.testing.assert_allclose(psnr.numpy(), want_psnr, rtol=0, atol=PSNR_TOL)
    np.testing.assert_allclose(imp.numpy(), want_imp, rtol=0, atol=1 / 255 + 1e-6)
    obs = np.broadcast_to(np.asarray(b)[:, None] == 1, want_imp.shape)
    # the observed pixels over 255: XLA divides by the reciprocal, torch not
    np.testing.assert_allclose(imp.numpy()[obs], want_imp[obs], rtol=np.finfo(np.float32).eps,
                               atol=0)


@pytest.mark.parametrize("chunk", [None, 2])
def test_vdvae_likelihood_evaluate_batch_matches_jax(tiny_pm_vdvae, jax_normals, chunk):
    """Unchunked, and in chunks of 2 (the last padded with the first
    instance): JAX's chunks draw from split keys, the port's one after the
    other, and the recorded normals come in that order."""
    jm, variables, port, x = tiny_pm_vdvae
    b, k_is = _jax_masks(x, jax.random.PRNGKey(8))
    px, pxu = jax.jit(lambda x, b, k: jax_vdvae_is_log_probs(
        jm, variables, x, b, k, num_samples=4, batch_chunk=chunk))(jnp.asarray(x), b, k_is)
    jax.effects_barrier()
    # eval_pm_vdvae_likelihood.py:136-137: x_lls and xo_lls
    want_x, want_xo = np.asarray(px), np.asarray(px) - np.asarray(pxu)
    assert len(jax_normals) == 4 * 12 * (1 if chunk is None else 2)
    got_x, got_xo = eval_pm_vdvae_likelihood.evaluate_batch(
        port, torch.from_numpy(x), torch.from_numpy(np.array(b)), 4, batch_chunk=chunk,
        noise=iter(jax_normals))
    np.testing.assert_allclose(got_x.numpy(), want_x, rtol=MODE_TOL)
    np.testing.assert_allclose(got_xo.numpy(), want_xo, rtol=MODE_TOL)
    bpd, _, _ = eval_pm_vdvae_likelihood.summarize(got_x.numpy()[None], got_xo.numpy()[None],
                                                   TINY_CONFIG["image_shape"])
    want_bpd = -want_x / (math.prod(TINY_CONFIG["image_shape"]) * np.log(2))
    np.testing.assert_allclose(bpd[0], want_bpd, rtol=MODE_TOL)


def test_vdvae_likelihood_summary_masks_as_the_jax_cli():
    """The BPD and the AC LL drop the values that are not finite or beyond
    1e10 before the per-trial means (``eval_pm_vdvae_likelihood.py:150-170``)."""
    x_lls = np.array([[-300.0, -np.inf, -310.0, -1e12], [-305.0, -320.0, np.nan, -290.0]])
    xo_lls = np.array([[-50.0, -60.0, np.inf, -40.0], [-55.0, 1e11, -45.0, -52.0]])
    bpd, per_trial_bpd, per_trial_ac = eval_pm_vdvae_likelihood.summarize(
        x_lls, xo_lls, TINY_CONFIG["image_shape"])
    want_bpd = -x_lls / (math.prod(TINY_CONFIG["image_shape"]) * np.log(2))
    finite = lambda v: np.ma.masked_array(v, mask=(~np.isfinite(v)) | (np.abs(v) > 1e10))
    np.testing.assert_array_equal(bpd, want_bpd)
    np.testing.assert_array_equal(per_trial_bpd, np.mean(finite(want_bpd), axis=1))
    np.testing.assert_array_equal(per_trial_ac, np.mean(finite(x_lls - xo_lls), axis=1))
    np.testing.assert_allclose(per_trial_ac, [-250.0, (-250.0 - 238.0) / 2])


@pytest.fixture
def vdvae_run(tmp_path, monkeypatch):
    """A ``TINY_CONFIG`` PM-VDVAE run directory in the JAX layout (EMA
    parameters beside the parameters) and 8x8 test images."""
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    tree = convert.random_pm_vdvae_tree(TINY_CONFIG, seed=2)
    save_train_state(str(run_dir / "train_state.pkl"),
                     TrainState(params=tree, state={}, ema_params=tree, step=1))
    (run_dir / "model_config.json").write_text(json.dumps(TINY_CONFIG))
    _images(tmp_path, monkeypatch, "tiny8", {"test": 10}, (8, 8, 1))
    return run_dir


def test_eval_pm_vdvae_imputation_writes_the_jax_cli_s_results(vdvae_run):
    rc = eval_pm_vdvae_imputation.main([
        "--run_dir", str(vdvae_run), "--dataset", "tiny8", "--mask_generator",
        "ImageBernoulliMaskGenerator", "--num_instances", "8", "--batch_size", "4",
        "--num_samples", "3", "--num_trials", "2", "--device", "cpu"])
    assert rc == 0
    res = vdvae_run / "imputation_results"
    assert sorted(p.name for p in res.iterdir()) == IMPUTATION_FILES
    psnrs = np.load(res / "psnrs.npy")
    assert psnrs.shape == (2, 8) and np.isfinite(psnrs).all()
    assert np.load(res / "prd_data.npy").shape == (2, 3, 2, 1001)


def test_eval_pm_vdvae_likelihood_writes_the_jax_cli_s_results(vdvae_run, capsys):
    rc = eval_pm_vdvae_likelihood.main([
        "--run_dir", str(vdvae_run), "--dataset", "tiny8", "--mask_generator",
        "RectangleMaskGenerator", "--num_instances", "10", "--batch_size", "5",
        "--batch_chunk", "3", "--num_samples", "2", "--num_trials", "2", "--device", "cpu"])
    assert rc == 0
    res = vdvae_run / "likelihood_results"
    assert sorted(p.name for p in res.iterdir()) == ["bpd.npy", "x_lls.npy", "xo_lls.npy"]
    x_lls, xo_lls, bpd = (np.load(res / f"{k}.npy") for k in ("x_lls", "xo_lls", "bpd"))
    assert x_lls.shape == xo_lls.shape == bpd.shape == (2, 10)
    assert np.isfinite(x_lls).all() and np.isfinite(xo_lls).all()
    np.testing.assert_allclose(bpd, -x_lls / (math.prod(TINY_CONFIG["image_shape"]) * np.log(2)),
                               rtol=1e-12)
    out = capsys.readouterr().out
    assert "BPD: " in out and "AC LL: " in out

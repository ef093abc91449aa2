"""The port's multi-rank CLIs over two gloo ranks on the CPU, each rank a
``python -m`` process with the launcher's environment set by hand and its
own time limit (``torch_parallel_worker.spawn_command``).

- ``train_pm_vdvae`` at a toy width, per-device batch 2 (global 4), fused
  decoder: one run directory, written by rank 0 alone, with one
  ``[step 2/2]`` line, a checkpoint that the JAX package's
  ``load_train_state`` reads at step 2; rank 1 prints nothing.
- ``eval_pm_vqvae`` at two ranks writes, bit for bit, the one-process
  run's ``psnrs``, ``prd_data`` and ``f_scores``: the masks and the Gumbel
  noise of each global request come from the shared generator, each rank
  samples its rows' share.
- ``eval_pm_vdvae_imputation`` and ``eval_pm_vdvae_likelihood`` at two
  ranks write every instance once (their normals are the ranks' own, so
  they equal the one-process run only in distribution): finite values of
  the one-process run's shapes, written and printed by rank 0 alone.
"""
import json
import math
import os
import shutil
import sys

import numpy as np
import optax
import pytest
import torch

import torch_parallel_worker as worker
from posterior_matching_tpu.train.state import TrainState, save_train_state
from posterior_matching_tpu.train.state import load_train_state as jax_load_train_state
from posterior_matching_torch import convert, eval_pm_vqvae
from posterior_matching_torch.data import sources
from test_torch_pm_vqvae import COND_DIM, PC_CONFIG, VQ_CONFIG
from test_torch_train_cli import TINY
from test_torch_vdvae import TINY_CONFIG
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

IMPUTATION_FILES = ("psnrs", "prd_data", "f_scores")


def _ranks(module, argv, cwd, env):
    return worker.spawn_command([sys.executable, "-m", f"posterior_matching_torch.{module}",
                                 *argv, "--device", "cpu"], cwd=cwd, env=env)


def _images(root, name, splits, shape):
    (root / name).mkdir(parents=True)
    rng = np.random.RandomState(0)
    for split, n in splits.items():
        np.savez(root / name / f"{split}.npz",
                 image=rng.randint(0, 256, (n, *shape)).astype(np.uint8),
                 label=np.zeros(n, np.int64))


def test_train_pm_vdvae_two_ranks_write_one_run(tmp_path):
    data = tmp_path / "data"
    (data / "mnist").mkdir(parents=True)
    for split, n in (("train", 16), ("test", 8)):
        arrays = sources._synthetic_image("mnist", split)
        np.savez(data / "mnist" / f"{split}.npz", **{k: v[:n] for k, v in arrays.items()})
    outs = _ranks("train_pm_vdvae", [
        "--config", "pm_vdvae_mnist", "--config.steps", "2", "--config.validation_freq", "2",
        "--config.seed", "3", "--config.model.fused_chain=True",
        "--config.data.train_batch_size=2", "--config.data.val_batch_size=2", *TINY],
        cwd=tmp_path, env={"PM_TPU_DATA_DIR": str(data)})
    runs = sorted(os.listdir(tmp_path / "runs"))
    assert len(runs) == 1 and runs[0].startswith("pm-vdvae-mnist-")
    run_dir = tmp_path / "runs" / runs[0]
    assert sorted(os.listdir(run_dir)) == ["model_config.json", "tb", "train_meta.json",
                                           "train_state.pkl"]
    steps = [ln for ln in outs[0].splitlines() if ln.startswith("[step ")]
    assert len(steps) == 1 and steps[0].startswith("[step 2/2] ") and "val_loss=" in steps[0]
    assert outs[1] == ""
    ts = jax_load_train_state(str(run_dir / "train_state.pkl"))
    assert int(ts.step) == 2 and ts.ema_params is not None
    model = convert.load_pm_vdvae(str(run_dir), device="cpu")
    assert all(torch.isfinite(p).all() for p in model.parameters())


@pytest.fixture
def pm_vqvae_run(tmp_path):
    params, state = convert.random_pm_vqvae_tree(COND_DIM, VQ_CONFIG, PC_CONFIG, seed=1)
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    save_train_state(str(run_dir / "train_state.pkl"), TrainState(
        params=params, state=state, opt_state=optax.adam(1e-3).init(params), step=3))
    (run_dir / "vqvae_config.json").write_text(json.dumps(VQ_CONFIG))
    (run_dir / "config.json").write_text(json.dumps({"conditional_dim": COND_DIM,
                                                     "pixel_cnn": PC_CONFIG}))
    _images(tmp_path / "data", "tiny16", {"test": 10}, (16, 16, 3))
    return run_dir


def test_eval_pm_vqvae_two_ranks_equal_one_process(pm_vqvae_run, tmp_path, monkeypatch):
    argv = ["--dataset", "tiny16", "--mask_generator", "RectangleMaskGenerator",
            "--num_instances", "8", "--batch_size", "4", "--num_samples", "2",
            "--num_trials", "2"]
    two = tmp_path / "two"
    shutil.copytree(pm_vqvae_run, two)
    env = {"PM_TPU_DATA_DIR": str(tmp_path / "data")}
    outs = _ranks("eval_pm_vqvae", ["--run_dir", str(two), *argv], tmp_path, env)
    assert "Wall time: requests " in outs[0] and outs[1] == ""
    monkeypatch.setenv("PM_TPU_DATA_DIR", env["PM_TPU_DATA_DIR"])
    with torch.random.fork_rng():
        assert eval_pm_vqvae.main(["--run_dir", str(pm_vqvae_run), *argv, "--device",
                                   "cpu"]) == 0
    res1, res2 = pm_vqvae_run / "imputation_results", two / "imputation_results"
    assert sorted(os.listdir(res2)) == sorted(os.listdir(res1))
    for name in IMPUTATION_FILES:
        np.testing.assert_array_equal(np.load(res2 / f"{name}.npy"),
                                      np.load(res1 / f"{name}.npy"), err_msg=name)
    assert np.load(res2 / "psnrs.npy").shape == (2, 8)


@pytest.fixture
def vdvae_run(tmp_path):
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    tree = convert.random_pm_vdvae_tree(TINY_CONFIG, seed=2)
    save_train_state(str(run_dir / "train_state.pkl"),
                     TrainState(params=tree, state={}, ema_params=tree, step=1))
    (run_dir / "model_config.json").write_text(json.dumps(TINY_CONFIG))
    _images(tmp_path / "data", "tiny8", {"test": 10}, (8, 8, 1))
    return run_dir


def test_vdvae_evals_two_ranks_write_every_instance(vdvae_run, tmp_path):
    common = ["--run_dir", str(vdvae_run), "--dataset", "tiny8", "--num_trials", "2"]
    env = {"PM_TPU_DATA_DIR": str(tmp_path / "data")}
    _ranks("eval_pm_vdvae_imputation", [
        *common, "--mask_generator", "ImageBernoulliMaskGenerator", "--num_instances", "8",
        "--batch_size", "4", "--num_samples", "3"], tmp_path, env)
    psnrs = np.load(vdvae_run / "imputation_results" / "psnrs.npy")
    assert psnrs.shape == (2, 8) and np.isfinite(psnrs).all()
    assert np.load(vdvae_run / "imputation_results" / "prd_data.npy").shape == (2, 3, 2, 1001)
    outs = _ranks("eval_pm_vdvae_likelihood", [
        *common, "--mask_generator", "RectangleMaskGenerator", "--num_instances", "8",
        "--batch_size", "2", "--batch_chunk", "1", "--num_samples", "2"], tmp_path, env)
    assert "BPD: " in outs[0] and outs[1] == ""
    res = vdvae_run / "likelihood_results"
    x_lls, xo_lls, bpd = (np.load(res / f"{k}.npy") for k in ("x_lls", "xo_lls", "bpd"))
    assert x_lls.shape == xo_lls.shape == bpd.shape == (2, 8)
    assert np.isfinite(x_lls).all() and np.isfinite(xo_lls).all()
    np.testing.assert_allclose(bpd, -x_lls / (math.prod(TINY_CONFIG["image_shape"]) * np.log(2)),
                               rtol=1e-12)

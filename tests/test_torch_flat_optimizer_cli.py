"""``flat_optimizer`` from the command line (split from
``tests/test_torch_flat_optimizer.py``, so that the suite's workers run
these CLI runs beside its optimizer cases): the bf16 + flat CLI with its
resume and both evals, a JAX-written flat bf16 run resumed and evaluated,
and the run over two gloo ranks.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from posterior_matching_torch import convert, train_pm_vdvae
from posterior_matching_torch.data import sources
from posterior_matching_tpu.train.state import TrainState as JaxTrainState
from posterior_matching_tpu.train.state import load_train_state as jax_load
from posterior_matching_tpu.train.state import save_train_state as jax_save
from test_torch_flat_optimizer import (
    EVALS,
    TINY,
    TINY_CONFIG,
    _jax_chain,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


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
    # one intra-op thread, as tests/test_torch_train_cli.py's CLI runs
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tmp_path / "data"
    torch.set_num_threads(threads)


def _evaluate(run_dir):
    for main, argv, results in EVALS:
        assert main(["--run_dir", str(run_dir), "--dataset", "mnist", "--mask_generator",
                     "MNISTMaskGenerator", "--device", "cpu", *argv]) == 0
        assert all(np.isfinite(np.load(f)).all()
                   for f in (run_dir / results).iterdir() if f.suffix == ".npy")


def _train(argv, capsys):
    assert train_pm_vdvae.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    (run_dir,) = [ln.split(": ")[1] for ln in lines if ln.startswith("Using run directory")]
    return lines, run_dir


def test_cli_trains_bf16_with_flat_optimizer_resumes_and_evaluates(data_dir, tmp_path,
                                                                   monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    argv = ["--config", "pm_vdvae_mnist", "--device", "cpu", "--config.validation_freq", "1",
            "--config.model.compute_dtype", "bfloat16", "--config.flat_optimizer", "True",
            "--config.data.train_batch_size", "16", "--config.data.val_batch_size", "16",
            "--config.model.fused_chain=True", *TINY]
    _, first = _train([*argv, "--config.steps", "1", "--config.seed", "3"], capsys)
    with open(os.path.join(first, "model_config.json")) as fp:
        model_config = json.load(fp)
    assert model_config["compute_dtype"] == "bfloat16" and "remat" not in model_config
    ts = jax_load(os.path.join(first, "train_state.pkl"))
    want = _jax_chain(200.0, 0.0, 1.5e-4).init(ts.params)
    assert jax.tree.structure(ts.opt_state) == jax.tree.structure(want)
    assert int(ts.opt_state[0][1].count) == 1   # group_by_shape's (chain state,)

    (tmp_path / "again").mkdir()
    monkeypatch.chdir(tmp_path / "again")
    lines, second = _train([*argv, "--config.steps", "2", "--resume_dir", str(tmp_path / first)],
                           capsys)
    assert [ln.split()[1] for ln in lines if ln.startswith("[step ")] == ["2/2]"]
    ts2 = jax_load(os.path.join(second, "train_state.pkl"))
    assert int(ts2.step) == 2 and int(ts2.opt_state[0][1].count) == 2
    model = convert.load_pm_vdvae(second, device="cpu")
    assert model.decoder.cdtype == torch.bfloat16
    _evaluate(tmp_path / "again" / second)


def test_a_jax_written_flat_bf16_run_resumes_and_evaluates(data_dir, tmp_path, monkeypatch,
                                                           capsys):
    config = dict(TINY_CONFIG, image_shape=(28, 28, 1), encoder_blocks="28x2,28d4,7x2,7d7,1x2",
                  decoder_blocks="1x2,7m1,7x2,28m7,28x2", num_mixtures=2,
                  compute_dtype="bfloat16")
    run_dir = tmp_path / "jax_run"
    run_dir.mkdir()
    tree = convert.random_pm_vdvae_tree(config, seed=1)
    state = _jax_chain(200.0, 0.0, 1.5e-4).init(tree)
    jax_save(str(run_dir / "train_state.pkl"),
             JaxTrainState(params=tree, state={}, opt_state=state, ema_params=tree, step=1))
    (run_dir / "model_config.json").write_text(json.dumps(config))
    (run_dir / "train_meta.json").write_text(json.dumps({"seed": 4, "steps": 1}))
    _evaluate(run_dir)
    monkeypatch.chdir(tmp_path)
    lines, resumed = _train(["--config", "pm_vdvae_mnist", "--device", "cpu",
                             "--config.validation_freq", "2", "--config.steps", "2",
                             "--config.model.compute_dtype", "bfloat16",
                             "--config.flat_optimizer", "True",
                             "--config.data.train_batch_size", "16",
                             "--config.data.val_batch_size", "16", *TINY,
                             "--resume_dir", str(run_dir)], capsys)
    assert int(jax_load(os.path.join(resumed, "train_state.pkl")).step) == 2


def test_bf16_flat_optimizer_run_over_two_ranks(tmp_path):
    """``train_pm_vdvae`` in bf16 with ``flat_optimizer`` over two gloo
    ranks (``tests/torch_parallel_worker.py``'s launcher, per-device batch
    2): one run directory, its checkpoint in group_by_shape's layout at
    step 2, its model in bf16 and finite."""
    import sys

    import torch_parallel_worker as worker

    data = tmp_path / "data"
    (data / "mnist").mkdir(parents=True)
    for split, n in (("train", 16), ("test", 8)):
        arrays = sources._synthetic_image("mnist", split)
        np.savez(data / "mnist" / f"{split}.npz", **{k: v[:n] for k, v in arrays.items()})
    worker.spawn_command([
        sys.executable, "-m", "posterior_matching_torch.train_pm_vdvae", "--config",
        "pm_vdvae_mnist", "--config.steps", "2", "--config.validation_freq", "2",
        "--config.seed", "3", "--config.model.fused_chain=True",
        "--config.model.compute_dtype", "bfloat16", "--config.flat_optimizer", "True",
        "--config.data.train_batch_size=2", "--config.data.val_batch_size=2", *TINY,
        "--device", "cpu"], cwd=tmp_path, env={"PM_TPU_DATA_DIR": str(data)})
    (run,) = os.listdir(tmp_path / "runs")
    ts = jax_load(str(tmp_path / "runs" / run / "train_state.pkl"))
    assert int(ts.step) == 2 and int(ts.opt_state[0][1].count) == 2
    model = convert.load_pm_vdvae(str(tmp_path / "runs" / run), device="cpu")
    assert model.encoder.cdtype == torch.bfloat16
    assert all(torch.isfinite(p).all() for p in model.parameters())

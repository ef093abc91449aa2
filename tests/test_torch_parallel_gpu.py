"""The port's data parallelism on the GPU, at digits16's toy widths.

These need an NVIDIA GPU (sm_90a) and ``nvcc``; elsewhere they skip. On the
card: ``python -m pytest tests/test_torch_parallel_gpu.py -q -m cuda
--noconftest`` (one card is enough).

- One rank over NCCL: ``train_pm_vdvae --config pm_vdvae_digits16`` with
  the fused decoder, per-device batch 8, 3 steps, writes the
  ``train_state.pkl`` of the same run without a process group, bit for
  bit. Both runs ask cuDNN for its deterministic algorithms (its own
  choice sums weight gradients in another order from one run to the
  next); the reduction over one rank, its division by 1 and the flat
  buffer's copies are exact.
- Two ranks on the one card over gloo: a fused ``pm_vdvae_trainer`` step of
  digits16's model at global batch 16 (8 rows a rank, so every decoder
  run is fused in both), each rank's normals its rows of the one-process
  run's, equals one process's step on the global batch within the CPU
  test's bounds (``test_torch_parallel.py``): the loss within 1e-5
  relative, Adam's moments within 1e-4 of scale, the parameters and their
  EMA within 5% of the learning rate, or twice the rate where the gradient
  is within that bar of zero (``torch_parallel_worker.params_close``); the
  ranks' parameters are equal bit for bit.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from posterior_matching_torch import convert
from posterior_matching_torch.config import CONFIGS
from posterior_matching_torch.ops import _build
from posterior_matching_torch.train.state import ForeignRecord, load_train_state

pytestmark = pytest.mark.cuda

MOMENT_TOL, PARAM_STEP_SHARE = 1e-4, 0.05
DETERMINISTIC_CLI = ("import sys, torch\n"
                     "torch.backends.cudnn.deterministic = True\n"
                     "from posterior_matching_torch.train_pm_vdvae import main\n"
                     "sys.exit(main(sys.argv[1:]))\n")


@pytest.fixture
def dev():
    """The GPU, with every kernel built here first: the ranks then load
    them instead of compiling them at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _build.build()
    return torch.device("cuda")


def _digits16(root):
    (root / "digits16").mkdir(parents=True)
    rng = np.random.RandomState(0)
    for split, n in (("train", 48), ("val", 16)):
        np.savez(root / "digits16" / f"{split}.npz",
                 image=rng.randint(0, 256, (n, 16, 16, 1)).astype(np.uint8),
                 label=np.zeros(n, np.int64))


def checkpoint_arrays(path):
    """Every array of a ``train_state.pkl``, flat by its path (the
    optimizer's through its optax records)."""
    ts = load_train_state(str(path))
    out = {"step": np.asarray(ts.step)}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}", v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}/{i}", v)
        elif isinstance(node, ForeignRecord):
            walk(f"{prefix}/{type(node).__name__}", node.args)
        else:
            out[prefix] = np.asarray(node)

    for field in ("params", "state", "opt_state", "ema_params"):
        walk(field, getattr(ts, field))
    return out


def test_one_nccl_rank_writes_the_one_process_checkpoint(dev, tmp_path):
    _digits16(tmp_path / "data")
    argv = [sys.executable, "-c", DETERMINISTIC_CLI, "--config", "pm_vdvae_digits16",
            "--config.steps", "3", "--config.validation_freq", "3", "--config.seed", "0",
            "--config.model.fused_chain=True", "--config.data.train_batch_size=8",
            "--config.data.val_batch_size=8"]
    env = {"PM_TPU_DATA_DIR": str(tmp_path / "data")}
    states = []
    for name in ("one", "nccl"):
        (tmp_path / name).mkdir()
        if name == "one":
            run = subprocess.run(argv, cwd=tmp_path / name, capture_output=True, text=True,
                                 timeout=worker.RANK_TIMEOUT,
                                 env=dict(os.environ, **env, PYTHONPATH=str(worker.REPO)))
            assert run.returncode == 0, run.stderr[-4000:]
        else:
            worker.spawn_command(argv, world=1, cwd=tmp_path / name, env=env)
        (run_dir,) = (tmp_path / name / "runs").iterdir()
        states.append(checkpoint_arrays(run_dir / "train_state.pkl"))
    one, nccl = states
    assert int(one["step"]) == int(nccl["step"]) == 3 and sorted(one) == sorted(nccl)
    for path, x in one.items():
        np.testing.assert_array_equal(nccl[path], x, err_msg=path)


def test_two_gloo_ranks_on_one_card_equal_one_process(dev, tmp_path):
    config = CONFIGS["pm_vdvae_digits16"]()
    cfg = dict(config["model"], fused_chain=True)
    tree = convert.random_pm_vdvae_tree(cfg, seed=4)
    rng = np.random.RandomState(7)
    batches = [{"image": rng.randint(0, 256, (16, 16, 16, 1)).astype(np.float32),
                "mask": (rng.rand(16, 16, 16, 1) > 0.5).astype(np.float32)}]
    model = convert.pm_vdvae_from_jax(tree, cfg, device=dev)
    shapes = worker.normals_shapes(model, {k: torch.from_numpy(v).to(dev)
                                           for k, v in batches[0].items()})
    assert all(s[0] == 16 for s in shapes), shapes
    inputs = {"vdvae_tree": tree, "vdvae_config": cfg, "vdvae_train": {"lr": config["lr"]},
              "vdvae_batches": batches,
              "vdvae_normals": [[rng.standard_normal(s).astype(np.float32) for s in shapes]]}
    with open(tmp_path / "inputs.pkl", "wb") as fp:
        pickle.dump(inputs, fp)
    worker.spawn_command([sys.executable, str(worker.WORKER), str(tmp_path), "vdvae"],
                         env={"PM_PARALLEL_DEVICE": "cuda", "LOCAL_RANK": "0"})
    ranks = [worker._load(tmp_path / f"vdvae.{r}.pkl") for r in range(2)]
    one = worker.vdvae_trainer(inputs, device=dev)
    metrics = [one.train_step(b) for b in worker._global_batches(inputs, "vdvae_batches")]
    want = worker.trainer_state(one)
    for out in ranks:
        assert out["count"] == want["count"] == 1
        assert out["metrics"][0]["skipped"] == metrics[0]["skipped"].item() == 0.0
        np.testing.assert_allclose(out["metrics"][0]["loss"], metrics[0]["loss"].item(),
                                   rtol=1e-5)
        for key in ("mu", "nu"):
            for name, w in want[key].items():
                np.testing.assert_allclose(out[key][name], w, rtol=0,
                                           atol=MOMENT_TOL * max(np.abs(w).max(), 1e-12),
                                           err_msg=f"{key} {name}")
        worker.params_close(out, want, config["lr"], 1, MOMENT_TOL, PARAM_STEP_SHARE)
    for name, a in ranks[0]["params"].items():
        np.testing.assert_array_equal(a, ranks[1]["params"][name], err_msg=name)

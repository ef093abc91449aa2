"""``--resume_dir`` of ``train_pm_vqvae`` on the GPU, through the kernels.

These need an NVIDIA GPU (sm_90a) and ``nvcc``; elsewhere they skip. On the
card: ``python -m pytest tests/test_torch_resume_gpu.py -q -m cuda
--noconftest``. A toy PM-VQVAE (PM-VQVAE MNIST's geometry, 2 resnet levels
of the kernels' 128 filters, a narrow VQ-VAE from ``train_vqvae`` with the
256 codes the row kernel's logits chunk needs) on small
synthetic MNIST files: 4 steps straight, and 2 steps then ``--resume_dir``
to 4, validating every 2 steps. The two final checkpoints are equal bit for
bit (the chain kernels relaunch bit for bit), and each validation's
imputation strips launch each sampler kernel once a code row (7 rows).
"""
import glob
import os

import numpy as np
import pytest
import torch

from posterior_matching_torch import train_pm_vqvae, train_vqvae
from posterior_matching_torch.data import sources
from posterior_matching_torch.ops import gated_chain as gc
from posterior_matching_torch.ops import sampler_chain as sc
from posterior_matching_torch.train.state import ForeignRecord, load_train_state

pytestmark = pytest.mark.cuda

STAGE1 = ["--config.data.train_batch_size=8", "--config.data.val_batch_size=8",
          "--config.model.hidden_units=8", "--config.model.residual_hidden_units=4",
          "--config.model.embedding_dim=8", "--config.model.num_embeddings=256"]
STAGE2 = ["--config.data.train_batch_size=4", "--config.data.val_batch_size=8",
          "--config.pixel_cnn.num_resnet=2", "--config.conditional_dim=16"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _run(main, argv, cwd, data_dir, monkeypatch):
    os.makedirs(cwd)
    monkeypatch.chdir(cwd)
    monkeypatch.setenv("PM_TPU_DATA_DIR", str(data_dir))
    assert main(argv) == 0
    (run,) = glob.glob(os.path.join(cwd, "runs", "*"))
    return run


def _arrays(run_dir):
    ts = load_train_state(os.path.join(run_dir, "train_state.pkl"))
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

    for field in ("params", "state", "opt_state"):
        walk(field, getattr(ts, field))
    return out


def test_pm_vqvae_resume_equals_straight_on_the_gpu(dev, tmp_path, monkeypatch):
    data = tmp_path / "data"
    (data / "mnist").mkdir(parents=True)
    for split, n in (("train", 32), ("test", 16)):
        arrays = sources._synthetic_image("mnist", split)
        np.savez(data / "mnist" / f"{split}.npz", **{k: v[:n] for k, v in arrays.items()})
    vqvae_dir = _run(train_vqvae.main, ["--config", "vqvae_mnist", "--config.steps=1",
                                        "--config.validation_freq=1", "--config.seed=1",
                                        *STAGE1], tmp_path / "stage1", data, monkeypatch)
    argv = ["--config", "pm_vqvae_mnist", "--config.vqvae_dir", vqvae_dir,
            "--config.validation_freq=2", *STAGE2]
    runs, launches = {}, {}
    for label, extra in (("straight", ["--config.steps=4", "--config.seed=2"]),
                         ("short", ["--config.steps=2", "--config.seed=2"]),
                         ("resumed", ["--config.steps=4", "--resume_dir", None])):
        if label == "resumed":
            extra[-1] = runs["short"]
        for c in (sc.vrow, sc.row, gc.stream_bwd):
            c.launches = 0
        runs[label] = _run(train_pm_vqvae.main, [*argv, *extra], tmp_path / label, data,
                           monkeypatch)
        torch.cuda.synchronize()
        launches[label] = (sc.vrow.launches, sc.row.launches, gc.stream_bwd.launches)
    assert launches == {"straight": (14, 14, 8), "short": (7, 7, 4), "resumed": (7, 7, 4)}
    want, got = _arrays(runs["straight"]), _arrays(runs["resumed"])
    assert set(got) == set(want) and int(want["step"]) == 4
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)

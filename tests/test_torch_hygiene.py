"""Import hygiene and device policy of the PyTorch port.

The port (its ``data`` and ``eval`` modules and CLIs too) and
``chip_smoke.py`` run on a machine without JAX, flax, ml_collections, PIL,
absl, tqdm, sklearn or TF-Hub, so none of them (nor the JAX package) may be
imported; Triton is imported only
inside the function that launches a kernel, never at module level. Entry
points run on the GPU unless the caller asks for the CPU: without a GPU
they raise.
"""
import ast
from pathlib import Path

import pytest
import torch

from posterior_matching_torch import (
    eval_pm_vae_uci,
    eval_pm_vdvae_imputation,
    eval_pm_vdvae_likelihood,
    eval_pm_vqvae,
    masking,
    runtime,
    train_pm_vae,
    train_pm_vdvae,
)
from posterior_matching_torch.config import (
    PM_VAE_CONFIGS,
    PM_VDVAE_MNIST,
    PM_VDVAE_MNIST_TRAIN,
    PM_VQVAE_CELEB_A,
    VQVAE_CELEB_A,
)
from posterior_matching_torch.models.pm_vqvae import PMVQVAE
from posterior_matching_torch.models.vae import PosteriorMatchingVAE
from posterior_matching_torch.models.vdvae import PosteriorMatchingVDVAE
from posterior_matching_torch.train.optim import Adam, ClippedAdam, GroupedClippedAdam
from posterior_matching_torch.train.trainer import (
    Trainer,
    pm_vae_trainer,
    pm_vdvae_trainer,
    pm_vqvae_loss,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "posterior_matching_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"
]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ml_collections", "PIL",
             "absl", "tqdm", "sklearn", "tensorflow_hub", "posterior_matching_tpu"}


def _imports(tree, module_level=False):
    """Imported module names; with ``module_level``, only those that run
    when the module is imported (not inside a function body)."""
    stack = [tree]
    while stack:
        node = stack.pop()
        if module_level and isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            continue
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        stack.extend(ast.iter_child_nodes(node))


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_side_imports(path):
    tree = ast.parse(path.read_text())
    bad = sorted({m for m in _imports(tree) if m.split(".")[0] in FORBIDDEN})
    assert not bad, f"{path} imports {bad}"
    top = {m.split(".")[0] for m in _imports(tree, module_level=True)}
    assert "triton" not in top, f"{path} imports triton at module level"


def test_entry_points_need_a_gpu_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PMVQVAE.from_config(
            PM_VQVAE_CELEB_A["conditional_dim"], VQVAE_CELEB_A,
            PM_VQVAE_CELEB_A["pixel_cnn"],
        )
    with pytest.raises(RuntimeError, match="no CUDA device"):
        masking.get_mask_generator("CelebAMaskGenerator")
    adam = lambda params: Adam(params, lambda count: 1e-3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(torch.nn.Linear(2, 2), pm_vqvae_loss, optimizer=adam)
    assert Trainer(torch.nn.Linear(2, 2), pm_vqvae_loss, optimizer=adam,
                   device="cpu").device == torch.device("cpu")
    assert runtime.resolve_device("cpu") == torch.device("cpu")


def test_float32_numerics_are_pinned():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_vdvae_entry_points_need_a_gpu_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PosteriorMatchingVDVAE.from_config(PM_VDVAE_MNIST)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        masking.get_mask_generator("MNISTMaskGenerator")
    model = PosteriorMatchingVDVAE.from_config(PM_VDVAE_MNIST, device="cpu")
    assert model.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm_vdvae_trainer(model, PM_VDVAE_MNIST_TRAIN)
    assert pm_vdvae_trainer(model, PM_VDVAE_MNIST_TRAIN, device="cpu").device == torch.device("cpu")
    masking.get_mask_generator("MNISTMaskGenerator", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_pm_vdvae.main(["--config", "pm_vdvae_mnist", "--config.steps", "1"])


def test_vdvae_fused_chain_options_are_taken():
    for option in (None, True, False):
        model = PosteriorMatchingVDVAE.from_config(dict(PM_VDVAE_MNIST, fused_chain=option),
                                                   device="cpu")
        assert model.decoder.fused == (option is True)
        assert model.encoder.chain == model.masked_encoder.chain == (option is not False)


@pytest.mark.parametrize("option", [{"compute_dtype": "bfloat16"}, {"remat": True},
                                    {"fused_chain": "interpret"}])
def test_vdvae_tpu_options_are_refused(option):
    """Of the JAX package's TPU options only ``fused_chain="interpret"``
    (its CPU test mode) is refused; ``compute_dtype`` bfloat16 and
    ``remat`` are ported and taken."""
    if "fused_chain" in option:
        with pytest.raises(NotImplementedError, match="fused_chain"):
            PosteriorMatchingVDVAE.from_config(dict(PM_VDVAE_MNIST, **option), device="cpu")
        return
    model = PosteriorMatchingVDVAE.from_config(dict(PM_VDVAE_MNIST, **option), device="cpu")
    assert model.encoder.remat == model.masked_encoder.remat == bool(option.get("remat"))
    cdtype = torch.bfloat16 if "compute_dtype" in option else torch.float32
    assert model.encoder.cdtype == model.decoder.cdtype == cdtype
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with pytest.raises(ValueError, match="compute_dtype"):
        PosteriorMatchingVDVAE.from_config(dict(PM_VDVAE_MNIST, compute_dtype="float16"),
                                           device="cpu")


def test_vdvae_flat_optimizer_is_refused():
    """``flat_optimizer`` is ported: the trainer takes it and runs the
    clipped Adam chain under group_by_shape."""
    model = PosteriorMatchingVDVAE.from_config(PM_VDVAE_MNIST, device="cpu")
    trainer = pm_vdvae_trainer(model, dict(PM_VDVAE_MNIST_TRAIN, flat_optimizer=True),
                               device="cpu")
    trainer.init()
    assert isinstance(trainer.optimizer, GroupedClippedAdam)
    plain = pm_vdvae_trainer(model, PM_VDVAE_MNIST_TRAIN, device="cpu")
    plain.init()
    assert type(plain.optimizer) is ClippedAdam


@pytest.mark.parametrize("main", [eval_pm_vqvae.main, eval_pm_vdvae_imputation.main,
                                  eval_pm_vdvae_likelihood.main])
def test_eval_clis_need_a_gpu_unless_told_cpu(main, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("PM_TPU_DATA_DIR", str(tmp_path))
    argv = ["--run_dir", str(tmp_path), "--dataset", "digits16", "--mask_generator",
            "RectangleMaskGenerator"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    # on the CPU it runs on, as far as the absent data
    with pytest.raises(ValueError, match="unknown dataset"):
        main([*argv, "--device", "cpu"])


@pytest.mark.parametrize("name", ["pm_vae_gas", "pm_vae_mnist"])
def test_pm_vae_entry_points_need_a_gpu_unless_told_cpu(name, monkeypatch, tmp_path):
    """The model, its trainer, its masks and both CLIs raise without a GPU
    unless asked for the CPU; on the CPU the eval CLI runs as far as the
    absent run directory."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = PM_VAE_CONFIGS[name]()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PosteriorMatchingVAE.from_config(config["model"])
    model = PosteriorMatchingVAE.from_config(config["model"], device="cpu")
    assert model.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm_vae_trainer(model, config)
    assert pm_vae_trainer(model, config, device="cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        masking.get_mask_generator(config["data"]["mask_generator"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_pm_vae.main(["--config", name, "--config.steps", "1"])
    monkeypatch.setenv("PM_TPU_DATA_DIR", str(tmp_path))
    argv = ["--run_dir", str(tmp_path / "absent"), "--dataset", "gas", "--num_instances", "32"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_pm_vae_uci.main(argv)
    with pytest.raises(FileNotFoundError, match="model_config.json"):
        eval_pm_vae_uci.main([*argv, "--device", "cpu"])

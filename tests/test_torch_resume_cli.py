"""``--resume_dir`` on the port's seven training CLIs, on the CPU at toy
widths on small synthetic files.

- For each CLI (``train_vqvae``, ``train_pm_vqvae``, ``train_pm_vdvae``
  with the fused decoder, ``train_pm_vae``, ``train_vade``'s ELBO phase,
  ``train_pm_vade``, ``train_lookahead_posterior``): a run of 6 steps
  straight, and a run of 3 steps continued to 6 by ``--resume_dir`` with
  no seed given (restored from ``train_meta.json``), validating every 3
  steps: the two final checkpoints are equal bit for bit in parameters,
  buffers (the VQ codebook's EMA state), ``mu``, ``nu``, count and EMA
  parameters. The resumed stream starts inside an epoch (and, for five of
  the seven, crosses into the next).
- A resume that cannot be read stops with an error that says why: a run
  directory without ``train_state.pkl``, a ``flat_optimizer`` checkpoint
  of the JAX package (``group_by_shape``'s stacked moments), and a
  checkpoint with the ``{count, mu, nu}`` optimizer dict that the port
  wrote before it wrote optax's layout.
- The event files: CRC32C's check value, and a scalar and an image batch
  written by ``TensorBoardCallback`` read back by ``read_events``
  (``tests/tb_events.py``; the card has no tensorboard), the PNG's rows
  decoded to tensorboardX's grid of the batch.
- Each straight run's ``tb/`` events, read back by TensorBoard's
  ``EventAccumulator``, hold the JAX CLIs' scalar tags (``loss``,
  ``val_loss``, ``steps_per_sec`` and, where the JAX CLI logs it,
  ``learning_rate``) at steps 3 and 6 and their image tags
  (``reconstructions``; ``imputations``; ``reconstructions``,
  ``imputations`` and ``samples``) at the grids' shapes; ``read_events``
  reads the same scalars.
"""
import os
import zlib

import jax
import numpy as np
import optax
import pytest
import torch

from posterior_matching_tpu.train import group_by_shape
from posterior_matching_tpu.train.state import TrainState as JaxTrainState
from posterior_matching_tpu.train.state import save_train_state as jax_save
from posterior_matching_torch import (
    convert,
    train_lookahead_posterior,
    train_pm_vade,
    train_pm_vae,
    train_pm_vdvae,
    train_pm_vqvae,
    train_vade,
    train_vqvae,
)
from posterior_matching_torch.data import sources
from posterior_matching_torch.train import tensorboard
from posterior_matching_torch.train.callbacks import TensorBoardCallback
from posterior_matching_torch.train.state import (
    ForeignRecord,
    TrainState,
    load_train_state,
    save_train_state,
)
from tb_events import read_events
from test_torch_pm_vae_cli import GAS_FLAGS
from test_torch_train_cli import TINY
from test_torch_vade_cli import LOOKAHEAD_FLAGS, PM_VADE_FLAGS, PM_VAE16_FLAGS, VADE_FLAGS
from test_torch_vqvae_cli import STAGE1, STAGE2

STEPS, HALF = 6, 3

# name -> (main, config, flags, the base run it reads or None, its flag)
CLIS = {
    "vqvae": (train_vqvae.main, "vqvae_mnist", STAGE1, None),
    "pm_vqvae": (train_pm_vqvae.main, "pm_vqvae_mnist", STAGE2, ("vqvae", "vqvae_dir")),
    "pm_vdvae": (train_pm_vdvae.main, "pm_vdvae_mnist",
                 [*TINY, "--config.model.fused_chain=True",
                  "--config.data.train_batch_size=8", "--config.data.val_batch_size=8"], None),
    "pm_vae": (train_pm_vae.main, "pm_vae_gas", GAS_FLAGS, None),
    "vade": (train_vade.main, "vade_mnist",
             [*VADE_FLAGS, "--config.pretrain_steps=3", "--config.cluster_pred_num_samples=3"],
             None),
    "pm_vade": (train_pm_vade.main, "pm_vade_mnist", PM_VADE_FLAGS, ("vade", "vade_dir")),
    "lookahead": (train_lookahead_posterior.main, "lookahead_mnist16", LOOKAHEAD_FLAGS,
                  ("pm_vae16", "pm_vae_dir")),
}
# The JAX CLIs' TensorBoard tags: images, and whether ``learning_rate`` is
# logged.
TAGS = {"vqvae": (("reconstructions",), False), "pm_vqvae": (("imputations",), False),
        "pm_vdvae": (("imputations", "reconstructions", "samples"), True),
        "pm_vae": ((), True), "vade": ((), True), "pm_vade": ((), True),
        "lookahead": ((), True)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The toy runs on one intra-op thread: the suite's parallel workers,
    each with torch's default pool of one thread a core, oversubscribe the
    cores many times over (a run took 60x its time alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Small files cut from the synthetic stand-ins: MNIST 32 training and
    16 test images (4 batches of 8 an epoch; mnist16 reads them too), gas 64
    training, 32 validation and 48 test rows."""
    root = tmp_path_factory.mktemp("data")
    for dataset, sizes in (("mnist", {"train": 32, "test": 16}),
                           ("gas", {"train": 64, "val": 32, "test": 48})):
        (root / dataset).mkdir()
        for split, n in sizes.items():
            arrays = (sources._synthetic_uci(dataset, split) if dataset == "gas"
                      else sources._synthetic_image(dataset, split))
            np.savez(root / dataset / f"{split}.npz", **{k: v[:n] for k, v in arrays.items()})
    return root


def _run(main, argv, data_dir, cwd):
    """``main(argv)`` in ``cwd`` on ``data_dir``: its run directory."""
    old = os.getcwd()
    os.environ["PM_TPU_DATA_DIR"] = str(data_dir)
    os.makedirs(cwd)
    os.chdir(cwd)
    try:
        assert main(argv) == 0
    finally:
        os.chdir(old)
        os.environ.pop("PM_TPU_DATA_DIR")
    (run,) = os.listdir(os.path.join(cwd, "runs"))
    return os.path.join(cwd, "runs", run)


@pytest.fixture(scope="module")
def runs(data_dir, tmp_path_factory):
    """Each CLI's straight, short and resumed runs, made once when a test
    first asks for them: ``runs(name) -> (straight, resumed)`` (the base
    run of the lookahead's PM-VAE: ``(run,)``)."""
    work = tmp_path_factory.mktemp("runs")
    done = {}

    def get(name):
        if name in done:
            return done[name]
        if name == "pm_vae16":
            done[name] = (_run(train_pm_vae.main, [
                "--config", "pm_vae_mnist16", "--device", "cpu", "--config.steps=2",
                "--config.validation_freq=2", "--config.seed=0", *PM_VAE16_FLAGS],
                data_dir, work / name),)
            return done[name]
        main, config, flags, base = CLIS[name]
        argv = ["--config", config, "--device", "cpu", f"--config.validation_freq={HALF}",
                *flags]
        if base is not None:
            argv += [f"--config.{base[1]}", get(base[0])[0]]
        straight = _run(main, [*argv, f"--config.steps={STEPS}", "--config.seed=5"],
                        data_dir, work / name / "straight")
        short = _run(main, [*argv, f"--config.steps={HALF}", "--config.seed=5"],
                     data_dir, work / name / "short")
        resumed = _run(main, [*argv, f"--config.steps={STEPS}", "--resume_dir", short],
                       data_dir, work / name / "resumed")
        done[name] = (straight, resumed)
        return done[name]

    return get


def _everything(ts: TrainState):
    """Every array of a port-read checkpoint, flat, the optimizer's through
    its optax records."""
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


@pytest.mark.parametrize("name", list(CLIS))
def test_resume_equals_straight(name, runs):
    straight, resumed = runs(name)
    want = _everything(load_train_state(os.path.join(straight, "train_state.pkl")))
    got = _everything(load_train_state(os.path.join(resumed, "train_state.pkl")))
    assert set(got) == set(want)
    assert int(want["step"]) == STEPS
    assert any("ScaleByAdamState" in k for k in want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    if name == "pm_vdvae":
        assert any(k.startswith("ema_params/") for k in want)
    if name == "vqvae":
        assert any(k.endswith("ema_cluster_size") for k in want)


def test_resume_errors(runs, data_dir, tmp_path):
    vqvae_dir = runs("vqvae")[0]
    argv = ["--config", "vqvae_mnist", "--device", "cpu", "--config.steps=2", *STAGE1]
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="train_state.pkl"):
        train_vqvae.main([*argv, "--resume_dir", str(empty)])

    ts = load_train_state(os.path.join(vqvae_dir, "train_state.pkl"))
    params = ts.params
    flat = group_by_shape(optax.adam(1e-3)).init(params)
    grouped = tmp_path / "grouped"
    grouped.mkdir()
    jax_save(str(grouped / "train_state.pkl"), JaxTrainState(
        params=params, state=ts.state, opt_state=jax.device_get(flat), step=2))
    with pytest.raises(ValueError, match="flat_optimizer.*A7"):
        _run(train_vqvae.main, [*argv, "--resume_dir", str(grouped)], data_dir,
             tmp_path / "w1")

    old = tmp_path / "old"
    old.mkdir()
    zeros = {k: np.zeros_like(v) for k, v in convert.vqvae_state_dict(
        params, ts.state["vq_ema"]).items()}
    save_train_state(str(old / "train_state.pkl"), TrainState(
        params=params, state=ts.state, opt_state={"count": 2, "mu": zeros, "nu": zeros}, step=2))
    with pytest.raises(ValueError, match="before it wrote optax's layout"):
        _run(train_vqvae.main, [*argv, "--resume_dir", str(old)], data_dir, tmp_path / "w2")


def test_event_file_round_trip(tmp_path):
    assert tensorboard.crc32c(b"123456789") == 0xE3069283
    images = np.random.RandomState(0).rand(9, 5, 6, 1)
    cb = TensorBoardCallback(str(tmp_path / "tb"))
    cb.on_validation_end(None, 3, {"loss": 1.25, "imputations": images})
    cb.on_validation_end(None, 6, {"loss": np.float32(0.5)})
    (path,) = (tmp_path / "tb").iterdir()
    assert path.name.startswith("events.out.tfevents.")
    assert read_events(str(path)) == [(3, "loss", 1.25), (3, "imputations", (10, 48)),
                                                  (6, "loss", 0.5)]
    grid = tensorboard.image_grid(images)
    want = np.zeros((10, 48, 3), np.uint8)   # 8 a row, the ninth alone on the second
    for i in range(9):
        y, x = divmod(i, 8)
        want[y * 5:(y + 1) * 5, x * 6:(x + 1) * 6] = (images[i] * 255.0).astype(np.uint8)
    np.testing.assert_array_equal(grid, want)
    png = tensorboard.png(grid)
    idat = png[png.index(b"IDAT") + 4:png.index(b"IEND") - 8]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(10, 1 + 48 * 3)
    assert not rows[:, 0].any()
    np.testing.assert_array_equal(rows[:, 1:].reshape(10, 48, 3), grid)


@pytest.mark.parametrize("name", list(CLIS))
def test_tensorboard_reads_the_events(name, runs):
    event_accumulator = pytest.importorskip(
        "tensorboard.backend.event_processing.event_accumulator")
    straight, _ = runs(name)
    acc = event_accumulator.EventAccumulator(os.path.join(straight, "tb"),
                                             size_guidance={"images": 0, "scalars": 0})
    acc.Reload()
    images, lr = TAGS[name]
    tags = acc.Tags()
    scalars = {"loss", "val_loss", "steps_per_sec"} | ({"learning_rate"} if lr else set())
    assert scalars <= set(tags["scalars"])
    assert sorted(tags["images"]) == sorted(images)
    (path,) = os.listdir(os.path.join(straight, "tb"))
    ours = read_events(os.path.join(straight, "tb", path))
    for tag in scalars:
        assert [e.step for e in acc.Scalars(tag)] == [HALF, STEPS]
        assert all(np.isfinite(e.value) for e in acc.Scalars(tag))
        assert [(e.step, e.value) for e in acc.Scalars(tag)] == [
            (step, value) for step, t, value in ours if t == tag]
    for tag in images:
        events = acc.Images(tag)
        assert [e.step for e in events] == [HALF, STEPS]
        # 28x28 images: [x | recon] 3 wide, [x | x_o | 5 samples] 3 wide, and
        # PM-VDVAE's 8 of each in one row of the grid
        width = {("vqvae", "reconstructions"): 3 * 56, ("pm_vqvae", "imputations"): 3 * 196,
                 ("pm_vdvae", "reconstructions"): 8 * 56,
                 ("pm_vdvae", "imputations"): 8 * 280, ("pm_vdvae", "samples"): 8 * 28}
        assert all(e.height == 28 and e.width == width[name, tag] for e in events)

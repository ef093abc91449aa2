"""The port's VaDE and acquisition CLIs, and their checkpoints across the two
packages, on the CPU at toy widths.

- ``train_vade`` (``vade_mnist``, its conv stacks narrowed, 3 pretraining
  steps, 4 ELBO steps, two validations) on small MNIST files in this
  process: its run directory, ``GMM Accuracy:`` printed, the fitted
  mixture grafted into the prior before phase 3 (``logits = log
  weights_``, ``mu = means_``, ``log_scale = log covariances_``), and
  ``val_clustering_accuracy`` logged at each validation.
- ``train_pm_vade`` on a VaDE run that the JAX package wrote (its
  ``save_train_state``, weights from the JAX init): every parameter outside
  ``partial_*`` in the port's checkpoint is the JAX run's, bit for bit; and
  on the port's own ``train_vade`` run.
- ``train_pm_vae --config pm_vae_mnist16`` (narrowed), then
  ``train_lookahead_posterior`` on its run and ``eval_greedy_acquisition``
  on that: the run directories, ``num_features`` 256, the trajectories'
  keys and shapes under the JAX CLI's names; the lookahead run's
  ``train_state.pkl`` loads through the JAX ``load_train_state`` into the
  JAX ``LookaheadPosterior``, whose ``expected_info_gains`` equal the
  port's at 1e-5 of scale.
- Without ``--device cpu`` each of the four CLIs raises here, where there
  is no GPU.
"""
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

os.environ.setdefault("PM_TPU_COMPILE_CACHE", "0")
from posterior_matching_tpu.models.lookahead import LookaheadPosterior as JaxLookahead  # noqa
from posterior_matching_tpu.models.vade import VADE as JaxVADE  # noqa: E402
from posterior_matching_tpu.train.state import TrainState as JaxTrainState  # noqa: E402
from posterior_matching_tpu.train.state import load_train_state as jax_load  # noqa: E402
from posterior_matching_tpu.train.state import save_train_state as jax_save  # noqa: E402
from posterior_matching_torch import (  # noqa: E402
    convert,
    eval_greedy_acquisition,
    train_lookahead_posterior,
    train_pm_vade,
    train_pm_vae,
    train_vade,
)
from posterior_matching_torch.config import CONFIGS  # noqa: E402
from posterior_matching_torch.data import sources  # noqa: E402
from posterior_matching_torch.train.trainer import Trainer  # noqa: E402
from test_torch_pm_vae_cli import _run  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ENC = [(4, 5, 1), (4, 5, 2), (8, 5, 1), (8, 5, 2), (8, 7, 1)]
DEC = [(8, 7, 1), (8, 5, 2), (4, 5, 1), (4, 5, 2), (4, 5, 1), (1, 5, 1)]
VADE_FLAGS = [f"--config.model.encoder_net_config.conv_layers={ENC}",
              f"--config.model.decoder_net_config.conv_layers={DEC}",
              "--config.data.train_batch_size=8", "--config.data.val_batch_size=8"]
PM_VADE_FLAGS = VADE_FLAGS + ["--config.model.partial_posterior_dist_config.hidden_units=8"]
PM_VAE16_FLAGS = ["--config.model.encoder_net_config.conv_layers="
                  "[(4, 3, 1), (4, 3, 2), (8, 3, 2), (8, 1, 1)]",
                  "--config.model.decoder_net_config.conv_layers="
                  "[(8, 8, 1), (8, 5, 2), (4, 5, 1), (1, 3, 1)]",
                  "--config.model.latent_dim=3",
                  "--config.data.train_batch_size=8", "--config.data.val_batch_size=8"]
LOOKAHEAD_FLAGS = ["--config.model.model_samples=3", "--config.model.lookahead_subsample=4",
                   "--config.data.train_batch_size=4", "--config.data.val_batch_size=8"]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """MNIST cut from the synthetic stand-in: 64 training and 24 test
    images (mnist16 reads the same files)."""
    root = tmp_path_factory.mktemp("data")
    (root / "mnist").mkdir()
    for split, n in (("train", 64), ("test", 24)):
        arrays = sources._synthetic_image("mnist", split)
        np.savez(root / "mnist" / f"{split}.npz", **{k: v[:n] for k, v in arrays.items()})
    return root


def _run_dir(work, prefix):
    (run,) = [d for d in os.listdir(work / "runs") if d.startswith(prefix + "-")]
    return str(work / "runs" / run)


def _steps(lines):
    return [ln for ln in lines if ln.startswith("[step ")]


def _vade_model_config():
    model = CONFIGS["vade_mnist"]()["model"]
    model["encoder_net_config"]["conv_layers"] = ENC
    model["decoder_net_config"]["conv_layers"] = DEC
    return model


@pytest.fixture(scope="module")
def vade_run(data_dir, tmp_path_factory, monkeypatch_module):
    """The port's ``train_vade`` run, the fitted mixture and the prior as
    phase 3 started from it."""
    fits, starts = [], []

    class Recorded(train_vade.GaussianMixture):
        def fit(self, x):
            fits.append(self)
            return super().fit(x)

    init = Trainer.init

    def recorded_init(self, initial_state_dict=None):
        init(self, initial_state_dict)
        starts.append({k: v.detach().clone() for k, v in self.model.state_dict().items()})

    monkeypatch_module.setattr(train_vade, "GaussianMixture", Recorded)
    monkeypatch_module.setattr(Trainer, "init", recorded_init)
    work = tmp_path_factory.mktemp("vade")
    lines = _run(train_vade.main, ["--config", "vade_mnist", "--device", "cpu",
                                   "--config.pretrain_steps=3", "--config.steps=4",
                                   "--config.validation_freq=2", "--config.seed=0",
                                   "--config.cluster_pred_num_samples=3", *VADE_FLAGS],
                 data_dir, work)
    monkeypatch_module.undo()
    return _run_dir(work, "vade-mnist"), lines, fits, starts


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def test_train_vade_runs_three_phases(vade_run):
    run_dir, lines, fits, starts = vade_run
    assert sorted(os.listdir(run_dir)) == ["model_config.json", "pretrain_state.pkl",
                                           "tb", "train_meta.json", "train_state.pkl"]
    with open(os.path.join(run_dir, "model_config.json")) as fp:
        assert json.load(fp) == json.loads(json.dumps(_vade_model_config()))
    (gmm_line,) = [ln for ln in lines if ln.startswith("GMM Accuracy: ")]
    assert 0.0 < float(gmm_line.split()[-1]) <= 1.0
    assert lines.index("Pretraining...") < lines.index(gmm_line)
    steps = _steps(lines)
    assert len(steps) == 3 and steps[0].startswith("[step 3/3]")
    assert all("val_clustering_accuracy=" in ln and "val_loss=" in ln for ln in steps[1:])
    # the graft: phase 3 starts from the mixture fitted in phase 2
    (gmm,) = fits
    assert gmm.means_.shape == (10, 10) and len(starts) == 2
    graft = train_vade.gmm_graft(gmm)
    for name, value in graft.items():
        np.testing.assert_array_equal(starts[1][name].numpy(), value, err_msg=name)
    np.testing.assert_array_equal(graft["log_scale"], np.log(gmm.covariances_).astype(np.float32))
    # and the pretraining left the rest of the model as phase 3 found it
    pre = convert.vade_state_dict(jax_load(os.path.join(run_dir, "pretrain_state.pkl")).params)
    for name, value in pre.items():
        if name not in graft:
            np.testing.assert_array_equal(starts[1][name].numpy(), value, err_msg=name)


def test_train_pm_vade_on_a_jax_written_run(data_dir, tmp_path):
    """A VaDE run the JAX package wrote warm-starts the port's PM-VaDE,
    whose checkpoint keeps every VaDE parameter bit for bit."""
    model = _vade_model_config()
    jm = JaxVADE.from_config(model)
    x = np.zeros((1, 28, 28, 1), np.float32)
    init = jax.jit(lambda keys: jm.init(keys, x, method=jm.elbo)["params"])
    params = jax.device_get(init({"params": jax.random.PRNGKey(0),
                                  "sample": jax.random.PRNGKey(1)}))
    vade_dir = tmp_path / "jax-vade"
    vade_dir.mkdir()
    jax_save(str(vade_dir / "train_state.pkl"), JaxTrainState(params=params, state={}, step=7))
    with open(vade_dir / "model_config.json", "w") as fp:
        json.dump(model, fp)
    lines = _run(train_pm_vade.main, ["--config", "pm_vade_mnist", "--device", "cpu",
                                      f"--config.vade_dir={vade_dir}", "--config.steps=2",
                                      "--config.validation_freq=1", "--config.seed=0",
                                      *PM_VADE_FLAGS], data_dir, tmp_path)
    steps = _steps(lines)
    assert len(steps) == 2 and all(np.isfinite(float(ln.split(" val_loss=")[1].split()[0]))
                                   for ln in steps)
    run_dir = _run_dir(tmp_path, "pm-vade-mnist")
    assert sorted(os.listdir(run_dir)) == ["model_config.json", "tb", "train_meta.json",
                                           "train_state.pkl"]
    got = convert.vade_state_dict(jax_load(os.path.join(run_dir, "train_state.pkl")).params)
    want = convert.vade_state_dict(params)
    assert set(got) - set(want) == {n for n in got if n.startswith("partial_")}
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)
    assert isinstance(convert.load_vade(run_dir, device="cpu"),
                      convert.PosteriorMatchingVADE)


def test_train_pm_vade_on_the_ports_run(vade_run, data_dir, tmp_path):
    run_dir = vade_run[0]
    lines = _run(train_pm_vade.main, ["--config", "pm_vade_mnist", "--device", "cpu",
                                      f"--config.vade_dir={run_dir}", "--config.steps=1",
                                      "--config.validation_freq=1", "--config.seed=1",
                                      *PM_VADE_FLAGS], data_dir, tmp_path)
    assert len(_steps(lines)) == 1
    vade = convert.load_vade(run_dir, device="cpu")
    pm = convert.load_vade(_run_dir(tmp_path, "pm-vade-mnist"), device="cpu")
    for name, value in vade.state_dict().items():
        assert torch.equal(pm.state_dict()[name], value), name


@pytest.fixture(scope="module")
def lookahead_run(data_dir, tmp_path_factory):
    work = tmp_path_factory.mktemp("lookahead")
    _run(train_pm_vae.main, ["--config", "pm_vae_mnist16", "--device", "cpu",
                             "--config.steps=2", "--config.validation_freq=2",
                             "--config.seed=0", *PM_VAE16_FLAGS], data_dir, work)
    pm_vae_dir = _run_dir(work, "pm-vae-mnist16")
    lines = _run(train_lookahead_posterior.main, [
        "--config", "lookahead_mnist16", "--device", "cpu", f"--config.pm_vae_dir={pm_vae_dir}",
        "--config.steps=2", "--config.validation_freq=1", "--config.seed=0",
        *LOOKAHEAD_FLAGS], data_dir, work)
    return _run_dir(work, "lookahead-mnist16"), pm_vae_dir, lines


def test_lookahead_cli_on_a_pm_vae_run(lookahead_run):
    run_dir, pm_vae_dir, lines = lookahead_run
    assert sorted(os.listdir(run_dir)) == ["lookahead_config.json", "pm_vae_config.json",
                                           "tb", "train_meta.json", "train_state.pkl"]
    steps = _steps(lines)
    assert len(steps) == 2 and all("val_loss=" in ln for ln in steps)
    with open(os.path.join(run_dir, "lookahead_config.json")) as fp:
        assert json.load(fp) == {"lookahead_subsample": 4, "model_samples": 3,
                                 "num_features": 256}
    with open(os.path.join(run_dir, "pm_vae_config.json")) as fp, \
            open(os.path.join(pm_vae_dir, "model_config.json")) as fp2:
        assert json.load(fp) == json.load(fp2)
    # the PM-VAE under pm_vae is the PM-VAE run's, bit for bit
    la = convert.load_lookahead(run_dir, device="cpu")
    for name, value in convert.load_pm_vae(pm_vae_dir, device="cpu").state_dict().items():
        assert torch.equal(la.pm_vae.state_dict()[name], value), name


def test_jax_lookahead_applies_the_ports_checkpoint(lookahead_run):
    run_dir = lookahead_run[0]
    ts = jax_load(os.path.join(run_dir, "train_state.pkl"))
    assert ts.step == 2 and type(ts).__module__ == "posterior_matching_tpu.train.state"
    configs = [json.load(open(os.path.join(run_dir, f))) for f in ("lookahead_config.json",
                                                                   "pm_vae_config.json")]
    jm = JaxLookahead.from_config(*configs)
    rng = np.random.RandomState(0)
    x = rng.rand(16, 16, 1).astype(np.float32)
    b = (rng.rand(16, 16, 1) > 0.7).astype(np.float32)
    want = np.asarray(jm.apply({"params": ts.params}, x, b, method=jm.expected_info_gains))
    with torch.no_grad():
        got = convert.load_lookahead(run_dir, device="cpu").expected_info_gains(
            torch.from_numpy(x), torch.from_numpy(b)).numpy()
    observed = b.reshape(-1) != 0
    assert np.all(np.isneginf(got[observed])) and np.all(np.isneginf(want[observed]))
    np.testing.assert_allclose(got[~observed], want[~observed], rtol=0,
                               atol=1e-5 * np.abs(want[~observed]).max())


def test_greedy_acquisition_cli(lookahead_run, data_dir, tmp_path):
    run_dir = lookahead_run[0]
    lines = _run(eval_greedy_acquisition.main, [
        "--run_dir", run_dir, "--dataset", "mnist16", "--device", "cpu", "--num_instances",
        "5", "--num_samples", "2", "--episode_length", "3", "--chunk_size", "3"],
        data_dir, tmp_path)
    assert any(ln.startswith("Wall time: ") for ln in lines)
    res = os.path.join(run_dir, "trajectories")
    assert sorted(os.listdir(res)) == ["lookahead_trajectories.pkl",
                                       "sampling_trajectories.pkl"]
    shapes = {"sampling_action": (3,), "lookahead_action": (3,), "sampling_probs": (3, 256),
              "lookahead_probs": (3, 256), "reconstruction": (3, 16, 16, 1), "rmse": (3,),
              "mask": (3, 16, 16, 1), "truth": (16, 16, 1)}
    for name in ("sampling", "lookahead"):
        with open(os.path.join(res, f"{name}_trajectories.pkl"), "rb") as fp:
            trajectories = pickle.load(fp)
        assert len(trajectories) == 5
        for tr in trajectories:
            assert {k: v.shape for k, v in tr.items()} == shapes
            assert isinstance(tr["rmse"], np.ndarray) and np.isfinite(tr["rmse"]).all()
            np.testing.assert_array_equal(tr["mask"][0], 0.0)
            assert tr["mask"][-1].sum() == 2.0


@pytest.mark.parametrize("main,argv", [
    (train_vade.main, ["--config", "vade_mnist"]),
    (train_pm_vade.main, ["--config", "pm_vade_mnist"]),
    (train_lookahead_posterior.main, ["--config", "lookahead_mnist16"]),
    (eval_greedy_acquisition.main, ["--run_dir", "runs/x", "--dataset", "mnist16"]),
], ids=["train_vade", "train_pm_vade", "train_lookahead_posterior", "eval_greedy_acquisition"])
def test_clis_raise_without_a_gpu(main, argv):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)

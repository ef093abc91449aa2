"""The seven training CLIs with the JAX trainer's execution options, on the
CPU at toy widths on small synthetic files (the runs of
``tests/test_torch_resume_cli.py``):

- ``--config.steps_per_call 3``: 6 steps in two chunks of 3, validating
  every 3; the checkpoint equals the ``steps_per_call`` 1 run's bit for bit
  (parameters, buffers, moments, count, EMA parameters);
- ``--config.device_resident_data True`` with ``steps_per_call`` 3: the
  split goes to the trainer as a ``DeviceDataset``; the run ends at step 6
  with finite losses and parameters.
"""
import os

import numpy as np
import pytest

from posterior_matching_torch import train_pm_vae
from posterior_matching_torch.data.datasets import DeviceDataset
from posterior_matching_torch.train import trainer as trainer_module
from posterior_matching_torch.train.state import load_train_state
from test_torch_resume_cli import (  # noqa: F401 (fixtures)
    CLIS,
    HALF,
    STEPS,
    _everything,
    _run,
    data_dir,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_vade_cli import PM_VAE16_FLAGS


def _spied(main, argv, data_dir, cwd):
    """``_run`` that also returns, for the CLI's last ``Trainer.fit``, its
    trainer's ``steps_per_call`` and whether it was given a
    ``DeviceDataset``."""
    seen, fit = [], trainer_module.Trainer.fit

    def spy(self, batches, *args, **kwargs):
        seen.append((self.steps_per_call, isinstance(batches, DeviceDataset)))
        return fit(self, batches, *args, **kwargs)

    trainer_module.Trainer.fit = spy
    try:
        return _run(main, argv, data_dir, cwd), seen[-1]
    finally:
        trainer_module.Trainer.fit = fit


@pytest.fixture(scope="module")
def option_runs(data_dir, tmp_path_factory):
    """``option_runs(name) -> ((run directory, (steps_per_call, device
    resident)), ...)`` of the straight, chunked and device-resident runs,
    made once a CLI."""
    work = tmp_path_factory.mktemp("runs")
    done = {}

    def get(name):
        if name in done:
            return done[name]
        if name == "pm_vae16":
            done[name] = (_spied(train_pm_vae.main, [
                "--config", "pm_vae_mnist16", "--device", "cpu", "--config.steps=2",
                "--config.validation_freq=2", "--config.seed=0", *PM_VAE16_FLAGS],
                data_dir, work / name),)
            return done[name]
        main, config, flags, base = CLIS[name]
        argv = ["--config", config, "--device", "cpu", f"--config.validation_freq={HALF}",
                f"--config.steps={STEPS}", "--config.seed=5", *flags]
        if base is not None:
            argv += [f"--config.{base[1]}", get(base[0])[0][0]]
        spc = [f"--config.steps_per_call={HALF}"]
        done[name] = (_spied(main, argv, data_dir, work / name / "straight"),
                      _spied(main, [*argv, *spc], data_dir, work / name / "chunked"),
                      _spied(main, [*argv, *spc, "--config.device_resident_data=True"],
                             data_dir, work / name / "resident"))
        return done[name]

    return get


@pytest.mark.parametrize("name", list(CLIS))
def test_steps_per_call_and_device_resident_data(name, option_runs):
    runs = option_runs(name)
    assert [options for _, options in runs] == [(1, False), (HALF, False), (HALF, True)]
    straight, chunked, resident = (run for run, _ in runs)
    want = _everything(load_train_state(os.path.join(straight, "train_state.pkl")))
    got = _everything(load_train_state(os.path.join(chunked, "train_state.pkl")))
    assert set(got) == set(want) and int(want["step"]) == STEPS
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    res = _everything(load_train_state(os.path.join(resident, "train_state.pkl")))
    assert int(res["step"]) == STEPS
    assert all(np.isfinite(v).all() for k, v in res.items()
               if k.startswith(("params", "ema_params")) and v.dtype.kind == "f")

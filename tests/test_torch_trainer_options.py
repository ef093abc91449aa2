"""The JAX trainer's execution options in the port: ``steps_per_call`` and
``device_resident_data`` (``DeviceDataset``).

- ``Trainer(steps_per_call=5)`` is the K=1 run bit for bit (the steps keep
  their seeds; a masking prologue and dropout-like draws included), the
  tail chunk lands on ``steps``, and a ``validation_freq`` K does not
  divide is refused with the JAX trainer's text (as ``tests/test_trainer.
  py:195-229`` holds the JAX trainer).
- ``ArrayDataset.to_device_resident``: the split stored as uint8 where the
  transform is a pure rescale, the transform materialised otherwise (as
  ``tests/test_trainer.py:230-310`` holds JAX's); given the same indices
  the batches are the host batches' bit for bit (the fused gather's
  rescale, as JAX's); the indices a step draws pass a chi-square test of
  uniformity; a resumed run equals the straight one bit for bit.

The seven training CLIs with both options: ``tests/test_torch_execution_cli.py``.
"""
import numpy as np
import pytest
import scipy.stats
import torch
from torch import nn

from posterior_matching_tpu.data.datasets import ArrayDataset as JaxArrayDataset
from posterior_matching_torch.data.datasets import (
    ArrayDataset,
    DeviceDataset,
    _make_batch_transform,
)
from posterior_matching_torch.train.optim import Adam
from posterior_matching_torch.train.trainer import Trainer, derive_seed
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


class Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.enc, self.dec = nn.Linear(4, 8), nn.Linear(8, 4)

    def forward(self, x):
        return self.dec(torch.relu(self.enc(x)))


def _loss(model, batch, seed, training):
    noise = torch.randn(batch["features"].shape,
                        generator=torch.Generator().manual_seed(seed))
    x = batch["features"] * batch["mask"]
    loss = ((model(x + 0.01 * noise) - batch["features"]) ** 2).mean()
    return loss, {"mse": loss.detach()}


def _prologue(batch, gen):
    mask = (torch.rand(batch["features"].shape, generator=gen) < 0.7).float()
    return {**batch, "mask": mask}


def _trainer(spc=1, ema=None):
    return Trainer(Tiny(), _loss, optimizer=lambda p: Adam(p, lambda count: 1e-2),
                   prologue_fn=_prologue, seed=3, device="cpu", steps_per_call=spc,
                   ema_rate=ema)


def _dataset():
    x = np.random.RandomState(0).randn(256, 4).astype(np.float32)
    return ArrayDataset({"features": x}, batch_size=32, shuffle=True, seed=0)


def _params(trainer):
    return {n: p.detach().clone() for n, p in trainer.model.named_parameters()}


@pytest.mark.parametrize("spc,steps", [(5, 20), (8, 19)])
def test_steps_per_call_is_the_per_step_run_bit_for_bit(spc, steps):
    """K=5 over 20 steps; K=8 over 19 (two chunks of 8, a tail of 3)."""
    one, k = _trainer(ema=0.9), _trainer(spc, ema=0.9)
    logs = {}
    one.fit(_dataset(), steps, validation_freq=40)
    k.fit(_dataset(), steps, validation_freq=40,
          callbacks=[lambda t, m: logs.setdefault(t.step, float(m["loss"]))])
    assert k.step == one.step == steps and sorted(logs) == list(range(1, steps + 1))
    a, b = _params(one), _params(k)
    for n in a:
        assert torch.equal(a[n], b[n]), n
    for n in one.ema_params:
        assert torch.equal(one.ema_params[n], k.ema_params[n]), n


def test_steps_per_call_refuses_an_undivided_validation_freq():
    with pytest.raises(ValueError, match="validation_freq=10 must be divisible by "
                                         "steps_per_call=7"):
        _trainer(7).fit(_dataset(), 20, validation_freq=10)


def _images(n=50):
    return np.random.RandomState(1).randint(0, 256, (n, 28, 28, 1)).astype(np.uint8)


def test_device_dataset_stores_uint8_for_a_pure_rescale():
    x = _images()
    ds = ArrayDataset({"image": x, "id": np.arange(50)}, 16,
                      transform=_make_batch_transform("mnist", True))
    dds = ds.to_device_resident("cpu")
    assert dds.data["image"].dtype == torch.uint8 and set(dds.data) == {"image"}
    assert dds.num_examples == 50
    # the JAX package keeps uint8 for its pure rescale as well
    jds = JaxArrayDataset({"image": x}, 16, transform=_jax_transform())
    assert jds.to_device_resident().data["image"].dtype == np.uint8
    # a transform that resizes is materialised, every example in order
    ds16 = ArrayDataset({"image": x}, 16, transform=_make_batch_transform("mnist16", True))
    d16 = ds16.to_device_resident("cpu")
    assert d16.data["image"].dtype == torch.float32 and d16.data["image"].shape == (50, 16, 16, 1)
    whole = np.concatenate([b["image"] for b in ArrayDataset(
        {"image": x}, 16, drop_remainder=False, transform=_make_batch_transform("mnist16", True))])
    np.testing.assert_array_equal(d16.data["image"].numpy(), whole)


def _jax_transform():
    def transform(batch):
        return {"image": batch["image"].astype(np.float32) / 255.0}

    transform.u8_scale_fields = {"image": 1.0 / 255.0}
    return transform


@pytest.mark.parametrize("dataset", ["mnist", "mnist16"])
def test_device_batches_are_the_host_batches(dataset):
    x = _images()
    ds = ArrayDataset({"image": x}, 16, transform=_make_batch_transform(dataset, True))
    dds = ds.to_device_resident("cpu")
    for seed in range(3):
        idx = torch.randint(0, 50, (16,), generator=torch.Generator().manual_seed(seed))
        got = dds.gather(idx)["image"].numpy()
        want = ds._batch(idx.numpy())["image"]   # the fused gather's rescale, JAX's
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_device_indices_are_uniform():
    n, draws = 64, 200
    dds = DeviceDataset({"i": np.arange(n)}, 32, device="cpu")
    counts = np.zeros(n)
    for step in range(draws):
        gen = torch.Generator().manual_seed(derive_seed(5, step, 6))
        np.add.at(counts, dds.sample(gen)["i"].numpy(), 1)
    expected = draws * 32 / n
    stat = ((counts - expected) ** 2 / expected).sum()
    assert scipy.stats.chi2.sf(stat, n - 1) > 1e-3, stat


def test_device_resident_run_resumes_bit_for_bit(tmp_path):
    x = np.random.RandomState(0).randn(256, 4).astype(np.float32)
    dds = lambda: ArrayDataset({"features": x}, 32).to_device_resident("cpu")
    straight = _trainer(2)
    straight.fit(dds(), 8, validation_freq=4)
    half = _trainer(2)
    half.fit(dds(), 4, validation_freq=4)
    path = str(tmp_path / "half.pkl")
    half.save_checkpoint(path)
    from posterior_matching_torch.train.state import load_train_state

    resumed = _trainer(2)
    resumed.fit(dds(), 8, validation_freq=4, resume_from=load_train_state(path))
    a, b = _params(straight), _params(resumed)
    for n in a:
        assert torch.equal(a[n], b[n]), n
    # and the steps drew other batches than the host stream would
    host = _trainer(2)
    host.fit(ArrayDataset({"features": x}, 32), 8, validation_freq=4)
    assert not torch.equal(_params(host)["enc.weight"], a["enc.weight"])

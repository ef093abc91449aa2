"""The port's image rescale is the JAX package's, bit for bit, on the CPU.

The JAX package rescales an image batch on two paths, its fused native
gather (``posterior_matching_tpu/native/pm_data.cc``) and its
device-resident transform (``datasets.py:199-204``), both as
``float32(u8) * float32(1 / 255)``, which differs from ``u8 / 255`` in the
last bit for 126 of the 256 byte values. Over all 256 values:

- the port's host batch (``ArrayDataset``) and device batch
  (``DeviceDataset.gather`` on the CPU) equal that product, JAX's
  ``to_device_resident()`` batch and JAX's ``ArrayDataset`` batch (through
  its native gather where ``posterior_matching_tpu.native.available()``
  says so, else held against the product);
- a uint8 field the gather does not rescale (strided, so not
  C-contiguous) is divided by 255 by the transform, in both packages.
"""
import numpy as np
import pytest
import torch

from posterior_matching_tpu import native as jax_native
from posterior_matching_tpu.data.datasets import ArrayDataset as JaxArrayDataset
from posterior_matching_tpu.data.datasets import _make_batch_transform as jax_transform
from posterior_matching_torch.data.datasets import ArrayDataset, _make_batch_transform
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# every byte value, as 16x16 one-channel images (MNIST-like) or as 8x8x4
# pixels of 3 channels split over images (a CelebA-like field)
SHAPES = {"mnist": (1, 16, 16, 1), "digits16": (4, 8, 8, 3)}


def _bytes(dataset):
    shape = SHAPES[dataset]
    return np.resize(np.arange(256, dtype=np.uint8), int(np.prod(shape))).reshape(shape)


def _product(x):
    return x.astype(np.float32) * np.float32(1.0 / 255.0)


def _whole_batch(ds):
    return next(iter(ds))["image"]


@pytest.mark.parametrize("dataset", sorted(SHAPES))
def test_host_batch_is_the_jax_rescale(dataset):
    x = _bytes(dataset)
    got = _whole_batch(ArrayDataset({"image": x}, len(x),
                                    transform=_make_batch_transform(dataset, True)))
    assert got.dtype == np.float32
    assert got.tobytes() == _product(x).tobytes()
    assert (got != x.astype(np.float32) / 255.0).sum() > 0   # the division differs
    jds = JaxArrayDataset({"image": x}, len(x), transform=jax_transform(dataset, True))
    assert np.asarray(jds.to_device_resident().example_batch()["image"]).tobytes() == \
        got.tobytes()


@pytest.mark.parametrize("dataset", sorted(SHAPES))
def test_device_batch_is_the_jax_rescale(dataset):
    x = _bytes(dataset)
    dds = ArrayDataset({"image": x}, len(x), transform=_make_batch_transform(dataset, True)
                       ).to_device_resident("cpu")
    assert dds.data["image"].dtype == torch.uint8   # the rescale runs on the device
    got = dds.gather(torch.arange(len(x)))["image"].numpy()
    assert got.tobytes() == _product(x).tobytes()
    jds = JaxArrayDataset({"image": x}, len(x), transform=jax_transform(dataset, True))
    assert np.asarray(jds.to_device_resident().example_batch()["image"]).tobytes() == \
        got.tobytes()


@pytest.mark.parametrize("dataset", sorted(SHAPES))
def test_jax_native_batch_is_the_ports(dataset):
    x = _bytes(dataset)
    sel = np.random.RandomState(0).permutation(len(x))
    got = ArrayDataset({"image": x}, len(x), transform=_make_batch_transform(dataset, True)
                       )._batch(sel)["image"]
    if jax_native.available():
        jds = JaxArrayDataset({"image": x}, len(x), transform=jax_transform(dataset, True))
        want = jds._gather(sel)
        assert want.get("_prescaled") == {"image"}
        want = jds._transform(want)["image"]
    else:
        want = _product(x[sel])
    assert got.tobytes() == want.tobytes()


def test_a_field_the_gather_does_not_rescale_is_divided():
    x = np.repeat(_bytes("mnist"), 2, axis=-1)[..., ::2]   # strided: not C-contiguous
    assert not x.flags.c_contiguous
    got = _whole_batch(ArrayDataset({"image": x}, 1, transform=_make_batch_transform("mnist",
                                                                                    True)))
    assert got.tobytes() == (x.astype(np.float32) / 255.0).tobytes()
    want = _whole_batch(JaxArrayDataset({"image": x}, 1, transform=jax_transform("mnist", True)))
    assert got.tobytes() == want.tobytes()
    # nor is it kept as uint8 on the device: the host batches are materialised
    dds = ArrayDataset({"image": x}, 1, transform=_make_batch_transform("mnist", True)
                       ).to_device_resident("cpu")
    assert dds.data["image"].dtype == torch.float32
    assert dds.gather(torch.tensor([0]))["image"].numpy().tobytes() == got.tobytes()

"""The port's data path against the JAX package's, on the same numpy arrays.

- ``_resize_batch`` (numpy) against the JAX package's PIL ``Image.resize(...,
  BILINEAR)``: to 1e-3 on a 0-255 scale (it reproduces Pillow's
  coefficients and summation order; in practice the two are equal);
- ``load_eval_dataset`` and ``load_datasets`` give the JAX package's
  batches for celeb_a (crop and resize), mnist16 (the resize after /255),
  mnist16_flat (``features``), digits16 (files only) and mnist, to 1e-3 on
  a 0-255 scale, with the same cardinality, remainder and shuffle stream;
- the ported configurations are the JAX config files' entries, less the
  JAX execution options the port does not take.

Data comes from small npz files in a temporary ``PM_TPU_DATA_DIR``.
"""
import importlib

import numpy as np
import pytest

from configs.pm_vdvae_digits16 import get_config as jax_pm_vdvae_digits16
from configs.pm_vqvae_celeb_a import get_config as jax_pm_vqvae_celeb_a
from configs.pm_vqvae_digits16 import get_config as jax_pm_vqvae_digits16
from configs.vqvae_celeb_a import get_config as jax_vqvae_celeb_a
from configs.vqvae_digits16 import get_config as jax_vqvae_digits16
from posterior_matching_tpu.data import datasets as jax_datasets
from posterior_matching_tpu.data import sources as jax_sources
from posterior_matching_torch.config import CONFIGS
from posterior_matching_torch.data import datasets, load_eval_dataset, sources
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL_255 = 1e-3   # on the 0-255 scale
SHAPES = {"celeb_a": (218, 178, 3), "mnist": (28, 28, 1), "digits16": (16, 16, 1)}


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    """Random uint8 images for each dataset's splits: 10 test, 24 train and
    16 validation images."""
    monkeypatch.setenv("PM_TPU_DATA_DIR", str(tmp_path))
    rng = np.random.RandomState(0)
    for name, shape in SHAPES.items():
        (tmp_path / name).mkdir()
        for split, n in (("test", 10), ("train", 24), ("validation", 16), ("val", 16)):
            np.savez(tmp_path / name / f"{split}.npz",
                     image=rng.randint(0, 256, (n, *shape)).astype(np.uint8),
                     label=rng.randint(0, 10, n))
    return tmp_path


def assert_batches_equal(got, want, scale):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=TOL_255 * scale)


@pytest.mark.parametrize("shape,size", [((5, 128, 128, 3), (64, 64)), ((6, 28, 28, 1), (16, 16)),
                                        ((4, 37, 23, 2), (11, 29)), ((3, 10, 10, 1), (20, 15))],
                         ids=["celeb_a", "mnist16", "non_square", "upscale"])
def test_resize_matches_pil(shape, size):
    x = (np.random.RandomState(1).rand(*shape) * 255).astype(np.float32)
    got, want = datasets._resize_batch(x, size), jax_datasets._resize_batch(x, size)
    assert got.shape == want.shape == (shape[0], *size, shape[-1])
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_255)


@pytest.mark.parametrize("dataset,normalize,drop", [
    ("celeb_a", True, True), ("celeb_a", False, False), ("mnist16", True, False),
    ("mnist16_flat", True, True), ("digits16", True, False), ("mnist", False, True)])
def test_load_eval_dataset_matches_jax(data_dir, dataset, normalize, drop):
    got = load_eval_dataset(dataset, 4, num_instances=9, normalize_images=normalize,
                            drop_remainder=drop)
    want = jax_datasets.load_eval_dataset(dataset, 4, num_instances=9,
                                          normalize_images=normalize, drop_remainder=drop)
    assert got.cardinality() == want.cardinality() == (2 if drop else 3)
    got_b, want_b = list(got), list(want)
    assert_batches_equal(got_b, want_b, 1 / 255 if normalize else 1.0)
    key = "features" if dataset == "mnist16_flat" else "image"
    shape = {"celeb_a": (64, 64, 3), "mnist16": (16, 16, 1), "mnist16_flat": (256,),
             "digits16": (16, 16, 1), "mnist": (28, 28, 1)}[dataset]
    assert got_b[0][key].shape == (4, *shape)


@pytest.mark.parametrize("dataset", ["celeb_a", "mnist16", "digits16"])
def test_load_datasets_stream_matches_jax(data_dir, dataset):
    config = {"dataset": dataset, "train_split": "train",
              "validation_split": "val" if dataset == "digits16" else "validation",
              "train_batch_size": 8, "val_batch_size": 8, "shuffle_seed": 3}
    if dataset == "mnist16":
        config["validation_split"] = "test"
    port, jax_ds = datasets.load_datasets(config), jax_datasets.load_datasets(config)
    for got, want in zip(port, jax_ds):
        for _ in range(2):   # two epochs: the shuffle stream continues
            assert_batches_equal(list(got), list(want), 1 / 255)


def test_digits16_has_no_synthetic_stand_in(tmp_path, monkeypatch):
    monkeypatch.setenv("PM_TPU_DATA_DIR", str(tmp_path))
    for load in (sources.load_arrays, jax_sources.load_arrays):
        with pytest.raises(ValueError, match="unknown dataset"):
            load("digits16", "train")


def _plain(v):
    """Nested dicts with lists for tuples, as a JSON round trip gives them."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    return list(v) if isinstance(v, tuple) else v


@pytest.mark.parametrize("name,get_config", [
    ("vqvae_celeb_a", jax_vqvae_celeb_a), ("pm_vqvae_celeb_a", jax_pm_vqvae_celeb_a),
    ("vqvae_digits16", jax_vqvae_digits16), ("pm_vqvae_digits16", jax_pm_vqvae_digits16),
    ("pm_vdvae_digits16", jax_pm_vdvae_digits16)])
def test_configs_are_the_jax_files(name, get_config):
    got = _plain(CONFIGS[name]())
    # every key of the JAX file, its execution options (steps_per_call,
    # device_resident_data, packed_chain) too
    want = _plain(get_config().to_dict())
    if name == "pm_vdvae_digits16":
        assert got["model"].pop("fused_chain") is None   # the port's execution option
    assert got == want


@pytest.mark.parametrize("main,name", [
    ("train_vqvae", "vqvae_celeb_a"), ("train_vqvae", "vqvae_digits16"),
    ("train_pm_vqvae", "pm_vqvae_celeb_a"), ("train_pm_vqvae", "pm_vqvae_digits16"),
    ("train_pm_vdvae", "pm_vdvae_digits16")])
def test_training_clis_take_the_new_configs(main, name, monkeypatch):
    """Each CLI names the configuration in its choices (it reaches the data
    loader, which here stops the run)."""
    module = importlib.import_module(f"posterior_matching_torch.{main}")

    class Stop(Exception):
        pass

    def stop(config, **kwargs):
        raise Stop(config["dataset"])

    monkeypatch.setattr(module, "load_datasets", stop)
    with pytest.raises(Stop, match=CONFIGS[name]()["data"]["dataset"]):
        module.main(["--config", name, "--device", "cpu"])

"""Dataset array sources.

Counterpart of ``posterior_matching_tpu/data/sources.py``, of which this is
the port's own copy (the port imports nothing of the JAX package). Each
dataset resolves to plain numpy arrays, looked up in order:

1. ``$PM_TPU_DATA_DIR`` (default ``<cwd>/data``): ``<dataset>/<split>.npz``
   with keys ``features`` or ``image`` (and optionally ``label``), as the
   scripts in ``datasets/`` write them;
2. a deterministic synthetic stand-in with the right shapes and dtypes,
   drawn from the same crc32 seeds as the JAX package's, so both packages
   see the same arrays (a warning says so, once per dataset).
"""
from __future__ import annotations

import os
import warnings
import zlib
from typing import Dict

import numpy as np


def _synth_seed(dataset: str, split: str) -> int:
    """Stable per-(dataset, split) seed (crc32: ``hash()`` is salted per
    process)."""
    return zlib.crc32(f"{dataset}/{split}".encode()) % (2**31)


UCI_DIMS = {"gas": 8, "power": 6, "hepmass": 21, "miniboone": 43, "bsds": 63}

IMAGE_SHAPES = {
    "mnist": (28, 28, 1),
    "celeb_a": (218, 178, 3),
}

_SYNTH_SIZES = {"train": 4096, "val": 1024, "validation": 1024, "test": 1024}

_warned = set()


def data_dir() -> str:
    return os.environ.get("PM_TPU_DATA_DIR", os.path.join(os.getcwd(), "data"))


def _warn_synthetic(dataset: str):
    if dataset not in _warned:
        _warned.add(dataset)
        warnings.warn(
            f"dataset '{dataset}' not found under {data_dir()}; using a "
            f"deterministic synthetic stand-in (shapes/dtypes match the real "
            f"data). Drop '<dataset>/<split>.npz' files there for real data.",
            stacklevel=2,
        )


def _synthetic_uci(dataset: str, split: str) -> Dict[str, np.ndarray]:
    d = UCI_DIMS[dataset]
    n = _SYNTH_SIZES.get(split, 1024)
    rng = np.random.RandomState(_synth_seed(dataset, split))
    # a correlated gaussian mixture: non-trivial structure for imputation
    k = 4
    means = rng.randn(k, d) * 2.0
    comps = rng.randint(0, k, size=n)
    a = rng.randn(d, d) * 0.3
    cov_factor = np.eye(d) + a @ a.T * 0.1
    chol = np.linalg.cholesky(cov_factor)
    x = means[comps] + rng.randn(n, d) @ chol.T * 0.5
    return {"features": x.astype(np.float32)}


def _synthetic_image(dataset: str, split: str) -> Dict[str, np.ndarray]:
    h, w, c = IMAGE_SHAPES[dataset]
    n = _SYNTH_SIZES.get(split, 1024)
    rng = np.random.RandomState(_synth_seed(dataset, split))
    labels = rng.randint(0, 10, size=n).astype(np.int64)
    # smooth blobs whose position and size depend on the label: learnable
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    imgs = np.zeros((n, h, w, c), np.float32)
    for i in range(n):
        lbl = labels[i]
        cy = h * (0.25 + 0.05 * (lbl % 5)) + rng.randn() * h * 0.05
        cx = w * (0.25 + 0.05 * (lbl // 5)) + rng.randn() * w * 0.05
        sig = (0.08 + 0.02 * (lbl % 3)) * (h + w) / 2
        blob = np.exp(-(((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * sig**2)))
        blob2 = np.exp(
            -(((ys - (h - cy)) ** 2 + (xs - (w - cx)) ** 2) / (2 * sig**2))
        )
        img = np.clip(blob + 0.7 * blob2, 0, 1)
        imgs[i, ..., 0] = img
        if c > 1:
            imgs[i, ..., 1] = np.clip(blob * (0.5 + 0.05 * lbl), 0, 1)
            imgs[i, ..., 2] = np.clip(blob2, 0, 1)
    image = (imgs * 255).astype(np.uint8)
    return {"image": image, "label": labels}


def load_arrays(dataset: str, split: str) -> Dict[str, np.ndarray]:
    """The raw arrays of a dataset split, before any pipeline transform."""
    path = os.path.join(data_dir(), dataset, f"{split}.npz")
    if os.path.exists(path):
        with np.load(path) as f:
            return {k: f[k] for k in f.files}
    if dataset in UCI_DIMS:
        _warn_synthetic(dataset)
        return _synthetic_uci(dataset, split)
    if dataset in IMAGE_SHAPES:
        _warn_synthetic(dataset)
        return _synthetic_image(dataset, split)
    raise ValueError(f"unknown dataset: {dataset}")

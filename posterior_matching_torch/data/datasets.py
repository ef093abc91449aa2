"""Input pipeline: a numpy batcher and the reference's dataset transforms.

Counterpart of ``posterior_matching_tpu/data/datasets.py``:
:class:`ArrayDataset` (``:30-180``, with the resume fast-forward
``skip_stream``; without ``spec_batch``, as the port's models need no batch
to start, the native gather and the device-resident copy), the CelebA crop
and resize and the mnist16 transforms (``:316-369``), :func:`load_datasets` (``:372-402``)
and :func:`load_eval_dataset` (``:405-426``). Masks are not added here: the
trainer's prologue and the eval CLIs draw them on the device.

The JAX package resizes through PIL, which the port does not use:
:func:`_resize_batch` reproduces ``PIL.Image.resize(..., BILINEAR)`` on
mode ``F`` images in numpy (Pillow's triangle filter widened by the scale
on downscale, its support and rounding rules, a horizontal pass stored as
float32 then a vertical pass, each summing its taps in order in float64),
each pass vectorised over the batch, one gather and product a tap.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np

from posterior_matching_torch.data.sources import load_arrays

Batch = Dict[str, np.ndarray]

# Images a resize converts to float64 at once: 32 CelebA crops of 128x128x3
# are 12.6 MB, which keeps a pass's operands in cache (chunks of 512 ran
# about 2x slower on an 8-core x86 host).
_RESIZE_CHUNK = 32


class ArrayDataset:
    """A shuffling, batching iterator over in-memory arrays: iterating
    yields one epoch of dict batches, a last partial batch left out unless
    ``drop_remainder`` is False. With ``shuffle`` each epoch permutes the
    examples with the dataset's ``np.random.RandomState(seed)``;
    ``transform`` runs on each batch."""

    def __init__(self, data: Batch, batch_size: int, shuffle: bool = False,
                 drop_remainder: bool = True, seed: Optional[int] = None,
                 transform: Optional[Callable[[Batch], Batch]] = None):
        n = len(next(iter(data.values())))
        for k, v in data.items():
            if len(v) != n:
                raise ValueError(f"ragged dataset field {k}: {len(v)} rows, not {n}")
        self._data, self._n = data, n
        self.batch_size = batch_size
        self._shuffle = shuffle
        self._drop_remainder = drop_remainder
        self._rng = np.random.RandomState(seed)
        self._transform = transform
        self._pending_skip = 0   # batches the next epoch skips by index

    def cardinality(self) -> int:
        """Batches an epoch yields."""
        if self._drop_remainder:
            return self._n // self.batch_size
        return -(-self._n // self.batch_size)

    def __iter__(self) -> Iterator[Batch]:
        idx = np.arange(self._n)
        if self._shuffle:
            self._rng.shuffle(idx)
        stop = self._n - self.batch_size + 1 if self._drop_remainder else self._n
        skip, self._pending_skip = self._pending_skip, 0
        for start in range(skip * self.batch_size, max(stop, 0), self.batch_size):
            yield self._batch(idx[start:start + self.batch_size])

    def _batch(self, sel: np.ndarray) -> Batch:
        batch = {k: v[sel] for k, v in self._data.items()}
        return self._transform(batch) if self._transform else batch

    def skip_stream(self, n: int) -> None:
        """Moves the stream on so that the next batch drawn (iterating this
        dataset epoch after epoch) is batch ``n`` of the stream, as a replay
        would leave it (``datasets.py:166-177``): one ``shuffle`` for each
        whole epoch skipped, the offset into the last one skipped by index
        when its iteration starts; no batch is gathered or transformed."""
        epochs, self._pending_skip = divmod(int(n), self.cardinality())
        if self._shuffle:
            idx = np.arange(self._n)
            for _ in range(epochs):
                self._rng.shuffle(idx)


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


@functools.lru_cache(maxsize=8)
def _bilinear_taps(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's bilinear resampling coefficients (``precompute_coeffs`` in
    ``Resample.c``): for each output index its input indices ``[out, T]``
    and float64 weights ``[out, T]``, the triangle's support widened by the
    scale on downscale, each row's weights summing to 1 (unused taps weigh
    0 at index 0)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int64)
    wts = np.zeros((out_size, ksize))
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        w = _bilinear((np.arange(xmin, xmax) - center + 0.5) * (1.0 / filterscale))
        total = w.sum()
        idx[xx, :xmax - xmin] = np.arange(xmin, xmax)
        wts[xx, :xmax - xmin] = w / total if total != 0.0 else w
    return idx, wts


def _resample(x: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One pass along ``axis`` of a float64 array, its taps summed in order
    in float64 as Pillow sums them; stored as float32."""
    idx, wts = _bilinear_taps(x.shape[axis], out_size)
    shape = [1] * x.ndim
    shape[axis] = out_size
    acc = np.take(x, idx[:, 0], axis=axis) * wts[:, 0].reshape(shape)
    for t in range(1, idx.shape[1]):
        acc += np.take(x, idx[:, t], axis=axis) * wts[:, t].reshape(shape)
    return acc.astype(np.float32)


def _resize_batch(images: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``[N, H, W, C]`` -> float32 ``[N, h, w, C]``, each channel as
    ``PIL.Image.fromarray(img, "F").resize((w, h), BILINEAR)``
    (``datasets.py:316-329``): the horizontal pass, then the vertical."""
    h, w = size
    out = np.empty((len(images), h, w, images.shape[-1]), np.float32)
    for start in range(0, len(images), _RESIZE_CHUNK):
        x = images[start:start + _RESIZE_CHUNK].astype(np.float64)
        tmp = _resample(x, 2, w)
        out[start:start + len(x)] = _resample(tmp.astype(np.float64), 1, h)
    return out


def _prepare_image_arrays(dataset: str, arrays: Batch) -> Batch:
    """One-time spatial transforms at load: CelebA cropped to 128x128
    (``[45:-45, 25:-25]``) and resized to 64x64 (``datasets.py:332-340``)."""
    if dataset == "celeb_a":
        return {"image": _resize_batch(arrays["image"][:, 45:-45, 25:-25, :], (64, 64))}
    return arrays


def _make_batch_transform(dataset: str, normalize_images: bool) -> Callable[[Batch], Batch]:
    """Drops ``id``; images to float32, over 255 with ``normalize_images``;
    ``mnist16*`` resized to 16x16, ``mnist16_flat`` flattened to
    ``features`` (``datasets.py:344-369``)."""
    def transform(batch: Batch) -> Batch:
        out = dict(batch)
        out.pop("id", None)
        if "image" in out:
            img = out["image"].astype(np.float32)
            if normalize_images:
                img = img / 255.0
            if "mnist16" in dataset:
                img = _resize_batch(img, (16, 16))
            out["image"] = img
        if dataset == "mnist16_flat" and "image" in out:
            img = out.pop("image")
            out["features"] = img.reshape(len(img), -1)
        return out
    return transform


def _base(dataset: str) -> str:
    """The arrays a dataset reads: every ``mnist*`` variant reads MNIST."""
    return "mnist" if "mnist" in dataset else dataset


def load_datasets(config: Mapping, normalize_images: bool = True,
                  seed: Optional[int] = None) -> Tuple[ArrayDataset, ArrayDataset]:
    """The training split (shuffled with ``shuffle_seed``, else with
    ``seed``) and the validation split (in order) from a ``data`` config
    (``datasets.py:372-402``). The training CLIs pass the run's seed: no
    shipped configuration sets ``shuffle_seed``, where the JAX package then
    shuffles from fresh entropy, and a resumed run must see the stream the
    interrupted run saw."""
    dataset = config["dataset"]
    if config.get("shuffle_seed") is not None:
        seed = config["shuffle_seed"]
    base = _base(dataset)
    transform = _make_batch_transform(dataset, normalize_images)
    train_arrays = load_arrays(base, config.get("train_split", "train"))
    val_arrays = load_arrays(base, config.get("validation_split", "validation"))
    train = ArrayDataset(_prepare_image_arrays(dataset, train_arrays),
                         config["train_batch_size"], shuffle=True,
                         seed=seed, transform=transform)
    val = ArrayDataset(_prepare_image_arrays(dataset, val_arrays),
                       config["val_batch_size"], transform=transform)
    return train, val


def load_eval_dataset(dataset: str, batch_size: int, num_instances: Optional[int] = None,
                      split: str = "test", normalize_images: bool = True,
                      drop_remainder: bool = True) -> ArrayDataset:
    """The eval CLIs' split, in order, cut to its first ``num_instances``
    examples (``datasets.py:405-426``)."""
    arrays = load_arrays(_base(dataset), split)
    if num_instances is not None:
        arrays = {k: v[:num_instances] for k, v in arrays.items()}
    return ArrayDataset(_prepare_image_arrays(dataset, arrays), batch_size,
                        drop_remainder=drop_remainder,
                        transform=_make_batch_transform(dataset, normalize_images))

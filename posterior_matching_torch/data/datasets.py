"""Input pipeline: a numpy batcher and the reference's dataset transforms.

Counterpart of ``posterior_matching_tpu/data/datasets.py``:
:class:`ArrayDataset` (``:30-180``, with the resume fast-forward
``skip_stream``, the device-resident copy ``to_device_resident`` and the
batches assembled by the native gather, :mod:`posterior_matching_torch.
native`; without ``spec_batch``, as the port's models need no batch to
start), :class:`DeviceDataset` (``:225-310``), the CelebA crop
and resize and the mnist16 transforms (``:316-369``), :func:`load_datasets` (``:372-402``)
and :func:`load_eval_dataset` (``:405-426``). Masks are not added here: the
trainer's prologue and the eval CLIs draw them on the device.

Images are rescaled as the JAX package rescales them on its two batch
paths, the fused native gather and the device-resident transform:
``float32(u8) * float32(1 / 255)``, which differs from ``u8 / 255`` in
the last bit for 126 of the 256 byte values. A transform advertises the
rescale as ``u8_scale_fields``; the native gather applies it to uint8
fields and marks them ``_prescaled``, and the transform leaves those as
they are (a field the gather did not rescale is divided by 255, as in the
JAX package).

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
import torch

from posterior_matching_torch import native, tracing
from posterior_matching_torch.data.sources import load_arrays
from posterior_matching_torch.runtime import resolve_device

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
        """The rows ``sel``, transformed, gathered as ``datasets.py:104-127``
        gathers them: a C-contiguous uint8 field the transform names in
        ``u8_scale_fields`` by the fused native gather and rescale (marked
        ``_prescaled`` for the transform), any other C-contiguous field of
        fixed-size items by the native row gather, the rest by numpy."""
        with tracing.span("data.fetch"):
            scales = getattr(self._transform, "u8_scale_fields", {})
            batch, prescaled = {}, set()
            for k, v in self._data.items():
                if k in scales and v.dtype == np.uint8 and v.flags.c_contiguous:
                    batch[k] = native.gather_u8_to_f32(v, sel, scales[k])
                    prescaled.add(k)
                elif v.flags.c_contiguous and v.ndim >= 1 and not v.dtype.hasobject:
                    batch[k] = native.gather_rows(v, sel)
                else:
                    batch[k] = v[sel]
            if prescaled:
                batch["_prescaled"] = prescaled
            if self._transform:
                batch = self._transform(batch)
            batch.pop("_prescaled", None)
            return batch

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

    def to_device_resident(self, device: Optional[str] = None) -> "DeviceDataset":
        """The split as a :class:`DeviceDataset` on ``device`` (the GPU
        unless ``"cpu"``; ``datasets.py:182-222``). Where the transform is a
        pure rescale of uint8 fields (:meth:`_is_pure_rescale`) the uint8
        arrays go to the device, a quarter of float32's memory, and the
        rescale runs there on each batch; otherwise the transform runs once
        here, over the split in order (the last partial batch kept), and
        its float output goes to the device."""
        scales = getattr(self._transform, "u8_scale_fields", None)
        if scales and self._is_pure_rescale(scales):
            data = {k: v for k, v in self._data.items() if k != "id"}
            return DeviceDataset(data, self.batch_size, scales=scales, device=device)
        full = ArrayDataset(self._data, self.batch_size, drop_remainder=False,
                            transform=self._transform)
        batches = list(full)
        data = {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}
        return DeviceDataset(data, self.batch_size, device=device)

    def _is_pure_rescale(self, scales: Dict[str, float]) -> bool:
        """Whether a batch is exactly ``float32(uint8 field) *
        float32(scale)`` for each field of ``scales`` (C-contiguous, so the
        fused gather rescales it), the other fields as they are, on this
        split's first rows: no resize, rename or other field changed
        (``datasets.py:224-242``, here held bit for bit)."""
        got = self._batch(np.arange(min(2, self._n)))
        want = {k: v[:2] for k, v in self._data.items() if k != "id"}
        for k, s in scales.items():
            if k not in want or want[k].dtype != np.uint8 or not self._data[k].flags.c_contiguous:
                return False
            want[k] = want[k].astype(np.float32) * np.float32(s)
        return set(got) == set(want) and all(
            got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
            and np.array_equal(got[k], want[k]) for k in want)


class DeviceDataset:
    """A training split held in device memory (``datasets.py:244-300``):
    :meth:`sample` draws a batch's indices on the device, uniformly with
    replacement, from the generator it is given, gathers the rows there and
    rescales the uint8 fields of ``scales`` as the host batch does,
    ``float32(u8) * float32(scale)``. The trainer seeds the generator from
    (run seed, step), so a step's batch needs no stream and a resume no
    replay; sampling with replacement stands in for shuffled epochs, as in
    the JAX package."""

    def __init__(self, data: Batch, batch_size: int, scales: Optional[Dict[str, float]] = None,
                 device: Optional[str] = None):
        n = len(next(iter(data.values())))
        for k, v in data.items():
            if len(v) != n:
                raise ValueError(f"ragged dataset field {k}: {len(v)} rows, not {n}")
        dev = resolve_device(device)
        self.data = {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in data.items()}
        self.batch_size, self.num_examples = batch_size, n
        # float32 scalar tensors: a Python float could be widened in the
        # product, and the host batch multiplies in float32
        self.scales = {k: torch.tensor(np.float32(s), device=dev)
                       for k, s in (scales or {}).items()}

    def gather(self, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The rows ``idx`` (a device tensor), transformed."""
        out = {k: v.index_select(0, idx) for k, v in self.data.items()}
        for k, s in self.scales.items():
            out[k] = out[k].float() * s
        return out

    def sample(self, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        """One batch, its indices uniform with replacement from ``gen``
        (on this dataset's device)."""
        idx = torch.randint(0, self.num_examples, (self.batch_size,), generator=gen,
                            device=gen.device)
        return self.gather(idx)


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
    """Drops ``id``; images to float32, over 255 with ``normalize_images``
    unless the gather rescaled them (``_prescaled``); ``mnist16*`` resized
    to 16x16, ``mnist16_flat`` flattened to ``features``
    (``datasets.py:344-369``)."""
    def transform(batch: Batch) -> Batch:
        out = dict(batch)
        out.pop("id", None)
        if "image" in out:
            if "image" in out.get("_prescaled", ()):
                img = out["image"]
            else:
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

    if normalize_images:
        # the fused uint8 gather and rescale, for ArrayDataset and a
        # device-resident copy
        transform.u8_scale_fields = {"image": 1.0 / 255.0}
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

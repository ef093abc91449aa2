"""Input pipeline: a numpy batcher and the reference's dataset transforms.

Counterpart of ``posterior_matching_tpu/data/datasets.py`` for what the
PM-VDVAE MNIST training CLI reads: :class:`ArrayDataset` (``:30-180``,
without the native gather, the resume fast-forward, the device-resident
copy and the kept remainder, which no ported caller uses) and
:func:`load_datasets` (``:372-402``). Masks are not added here: the
trainer's prologue draws them on the device. The CelebA crop and resize and
the mnist16 resize go through PIL, which the port does not use; they raise
until they are ported (``ROADMAP.md`` A5).
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np

from posterior_matching_torch.data.sources import load_arrays

Batch = Dict[str, np.ndarray]


class ArrayDataset:
    """A shuffling, batching iterator over in-memory arrays: iterating
    yields one epoch of dict batches, a last partial batch left out. With
    ``shuffle`` each epoch permutes the examples with the dataset's
    ``np.random.RandomState(seed)``; ``transform`` runs on each batch."""

    def __init__(self, data: Batch, batch_size: int, shuffle: bool = False,
                 seed: Optional[int] = None,
                 transform: Optional[Callable[[Batch], Batch]] = None):
        n = len(next(iter(data.values())))
        for k, v in data.items():
            if len(v) != n:
                raise ValueError(f"ragged dataset field {k}: {len(v)} rows, not {n}")
        self._data, self._n = data, n
        self.batch_size = batch_size
        self._shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        self._transform = transform

    def __iter__(self) -> Iterator[Batch]:
        idx = np.arange(self._n)
        if self._shuffle:
            self._rng.shuffle(idx)
        for start in range(0, self._n - self.batch_size + 1, self.batch_size):
            sel = idx[start:start + self.batch_size]
            batch = {k: v[sel] for k, v in self._data.items()}
            yield self._transform(batch) if self._transform else batch


def _transform(normalize_images: bool) -> Callable[[Batch], Batch]:
    """Drops ``id``; images to float32, over 255 with ``normalize_images``
    (``datasets.py:344-369``)."""
    def transform(batch: Batch) -> Batch:
        out = dict(batch)
        out.pop("id", None)
        if "image" in out:
            img = out["image"].astype(np.float32)
            out["image"] = img / 255.0 if normalize_images else img
        return out
    return transform


def load_datasets(config: Mapping, normalize_images: bool = True
                  ) -> Tuple[ArrayDataset, ArrayDataset]:
    """The training split (shuffled with ``shuffle_seed``) and the
    validation split (in order) from a ``data`` config
    (``datasets.py:372-402``)."""
    dataset = config["dataset"]
    if dataset != "mnist":
        raise NotImplementedError(f"dataset {dataset!r} is not ported yet (the port "
                                  "loads MNIST; CelebA and mnist16 need a PIL resize)")
    transform = _transform(normalize_images)
    train = ArrayDataset(load_arrays(dataset, config.get("train_split", "train")),
                         config["train_batch_size"], shuffle=True,
                         seed=config.get("shuffle_seed"), transform=transform)
    val = ArrayDataset(load_arrays(dataset, config.get("validation_split", "validation")),
                       config["val_batch_size"], transform=transform)
    return train, val

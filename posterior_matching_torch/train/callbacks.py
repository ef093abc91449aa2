"""Validation-time callbacks of the trainer.

Counterpart of ``posterior_matching_tpu/train/callbacks.py``:
:meth:`Trainer.fit <posterior_matching_torch.train.trainer.Trainer.fit>`
calls ``on_validation_step(model, generator, batch)`` of each
:class:`Callback` on every validation batch, then
``on_validation_end(train_state, step, logs)`` after the validation, with
the state as the JAX package's ``TrainState`` holds it and the logs it is
about to print (on rank 0 only, under a process group: the checkpoint and
the event files are written once). :class:`TensorBoardCallback` writes
those logs as TensorBoard events (:mod:`posterior_matching_torch.train.
tensorboard`, without tensorboardX, which the card does not have).

The JAX package's ``OrbaxCheckpointCallback`` (:68-103) is
:class:`SnapshotCallback` here: the same constructor, hooks and retention,
the snapshots written through ``torch.distributed.checkpoint`` (the name
says that Orbax is not used). As in the JAX package no CLI attaches it;
``train_state.pkl`` stays the checkpoint the CLIs write and read.
"""
from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from posterior_matching_torch.parallel import mesh
from posterior_matching_torch.train import tensorboard
from posterior_matching_torch.train.state import TrainState, save_train_state


class Callback:
    def on_validation_step(self, model, generator, batch: Dict[str, Any]) -> None:
        """One validation batch (tensors on the device), the model with its
        trained parameters in eval mode, and a generator on the device for
        the callback's draws."""

    def has_validation_step(self) -> bool:
        return type(self).on_validation_step is not Callback.on_validation_step

    def on_validation_end(self, train_state: TrainState, step: int,
                          logs: Dict[str, Any]) -> None:
        pass


class CheckpointCallback(Callback):
    """Writes the state to ``path`` (a ``train_state.pkl``) at every
    validation."""

    def __init__(self, path: str):
        self._path = path

    def on_validation_end(self, train_state, step, logs):
        mesh.require_rank0("the checkpoint")
        save_train_state(self._path, train_state)


class LearningRateLoggerCallback(Callback):
    """Adds the schedule's ``learning_rate`` at the step to the logs."""

    def __init__(self, schedule: Callable[[int], float]):
        self._schedule = schedule

    def on_validation_end(self, train_state, step, logs):
        logs["learning_rate"] = float(self._schedule(step))


class TensorBoardCallback(Callback):
    """Writes each validation's logs as events in ``path`` (a run
    directory's ``tb/``), routed by ndim as ``callbacks.py:52-64`` routes
    them: a 0-d value as a scalar, any other as an image batch ``[B, H, W,
    C]`` clipped to [0, 1]."""

    def __init__(self, path: str):
        mesh.require_rank0("TensorBoard events")
        self._writer = tensorboard.EventFileWriter(path)

    def on_validation_end(self, train_state, step, logs):
        for k, v in logs.items():
            v = np.asarray(v)
            if v.ndim == 0:
                self._writer.add(step, tensorboard.scalar_value(k, float(v)))
            else:
                self._writer.add(step, tensorboard.image_value(k, np.clip(v, 0.0, 1.0)))


# A snapshot directory being written: renamed to its step once whole.
_TMP = ".tmp-"
# The key of a snapshot's tree skeleton (JSON bytes as a uint8 tensor).
_TREE = "__tree__"


class SnapshotCallback(Callback):
    """Retained snapshots of the train state at each validation
    (``OrbaxCheckpointCallback``, ``callbacks.py:68-103``): the tree
    ``{"params", "state", "opt_state", "ema_params", "step"}`` of the state
    it is handed, saved through ``torch.distributed.checkpoint`` into
    ``directory/<step>``. A save is

    - atomic: written into a temporary directory beside it, renamed to the
      step once DCP has finished (and the directory synced), so a snapshot
      is whole or absent;
    - asynchronous: ``on_validation_end`` copies every array to the host
      and returns; a writer thread saves the copy, so later steps cannot
      change what is written. The next save, :meth:`restore_latest` and
      :meth:`close` wait for the save in flight, and raise its error;
    - retained: the newest ``max_to_keep`` snapshots are kept (all with
      None), older ones deleted.

    Only rank 0 saves, and DCP is run with ``no_dist``: it enters no
    collective of a process group, where the other ranks do not take part.
    """

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3):
        if max_to_keep is not None and max_to_keep < 1:
            raise ValueError(f"max_to_keep must be None or at least 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._writer = ThreadPoolExecutor(max_workers=1, thread_name_prefix="snapshot")
        self._pending: Optional[Future] = None

    def on_validation_end(self, train_state, step, logs):
        mesh.require_rank0("snapshots")
        self.wait()
        step = int(step)
        if os.path.exists(self._path(step)):
            raise ValueError(f"{self._path(step)}: a snapshot of step {step} exists")
        tensors: Dict[str, torch.Tensor] = {}
        skeleton = _flatten(snapshot_tree(train_state, step), (), tensors)
        tensors[_TREE] = torch.frombuffer(bytearray(json.dumps(skeleton).encode()),
                                          dtype=torch.uint8)
        self._pending = self._writer.submit(self._write, step, tensors)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _write(self, step: int, tensors: Dict[str, torch.Tensor]) -> None:
        import torch.distributed.checkpoint as dcp

        for name in os.listdir(self.directory):   # left by a process that died mid-save
            if name.startswith(_TMP):
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)
        tmp = os.path.join(self.directory, f"{_TMP}{step}")
        try:
            dcp.save(tensors, checkpoint_id=tmp, no_dist=True)
            os.replace(tmp, self._path(step))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        fd = os.open(self.directory, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        if self.max_to_keep is not None:
            for old in self.steps()[:-self.max_to_keep]:
                shutil.rmtree(self._path(old))

    def steps(self) -> List[int]:
        """The steps of the whole snapshots on disk, oldest first (a save in
        flight is not among them)."""
        return sorted(int(n) for n in os.listdir(self.directory) if n.isdigit())

    def wait(self) -> None:
        """Waits for the save in flight; raises its error."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def restore_latest(self) -> Optional[Dict[str, Any]]:
        """The newest snapshot's tree, as Orbax restores it without a target
        (:func:`~posterior_matching_torch.convert.orbax_tree`: numpy arrays,
        optax states as dicts of their fields), or None without one."""
        import torch.distributed.checkpoint as dcp
        from torch.distributed.checkpoint import FileSystemReader
        from torch.distributed.checkpoint.metadata import TensorStorageMetadata

        self.wait()
        steps = self.steps()
        if not steps:
            return None
        path = self._path(steps[-1])
        meta = FileSystemReader(path).read_metadata().state_dict_metadata
        if _TREE not in meta or not all(isinstance(m, TensorStorageMetadata)
                                        for m in meta.values()):
            raise ValueError(f"{path} is not a snapshot of this callback")
        tensors = {k: torch.empty(m.size, dtype=m.properties.dtype) for k, m in meta.items()}
        dcp.load(tensors, checkpoint_id=path, no_dist=True)
        skeleton = json.loads(tensors.pop(_TREE).numpy().tobytes())
        return _unflatten(skeleton, tensors)

    def close(self) -> None:
        """Waits for the save in flight and stops the writer thread."""
        try:
            self.wait()
        finally:
            self._writer.shutdown()


def snapshot_tree(train_state: TrainState, step: int) -> Dict[str, Any]:
    """What :class:`SnapshotCallback` saves of ``train_state`` at ``step``:
    the tree of ``callbacks.py:85-91`` in the form that
    :meth:`~SnapshotCallback.restore_latest` returns it
    (:func:`~posterior_matching_torch.convert.orbax_tree`)."""
    from posterior_matching_torch.convert import orbax_tree

    return orbax_tree({"params": train_state.params, "state": train_state.state,
                       "opt_state": train_state.opt_state, "ema_params": train_state.ema_params,
                       "step": int(step)})


def _flatten(tree: Any, path: Tuple[str, ...], tensors: Dict[str, torch.Tensor]) -> Any:
    """The JSON skeleton of a tree of dicts, lists and leaves: ``{"d":
    {...}}``, ``{"l": [...]}``, ``{"a": key}`` for an array, copied into
    ``tensors[key]`` (its path joined by ``/``), ``{"v": value}`` for
    None or a Python scalar."""
    if isinstance(tree, dict):
        return {"d": {k: _flatten(v, (*path, str(k)), tensors) for k, v in tree.items()}}
    if isinstance(tree, list):
        return {"l": [_flatten(v, (*path, str(i)), tensors) for i, v in enumerate(tree)]}
    if isinstance(tree, np.ndarray):
        key = "/".join(path)
        if key in tensors or key == _TREE:
            raise ValueError(f"two leaves of the tree have the path {key!r}")
        tensors[key] = torch.from_numpy(np.array(tree, order="C"))
        return {"a": key}
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"v": tree}
    raise TypeError(f"a snapshot holds no {type(tree).__name__} (at {'/'.join(path)})")


def _unflatten(node: Dict[str, Any], tensors: Dict[str, torch.Tensor]) -> Any:
    if "d" in node:
        return {k: _unflatten(v, tensors) for k, v in node["d"].items()}
    if "l" in node:
        return [_unflatten(v, tensors) for v in node["l"]]
    if "a" in node:
        return tensors[node["a"]].numpy()
    return node["v"]

"""Validation-time callbacks of the trainer.

Counterpart of ``posterior_matching_tpu/train/callbacks.py:12-41``:
:meth:`Trainer.fit <posterior_matching_torch.train.trainer.Trainer.fit>`
calls ``on_validation_step(model, generator, batch)`` of each
:class:`Callback` on every validation batch, then
``on_validation_end(train_state, step, logs)`` after the validation, with
the state as the JAX package's ``TrainState`` holds it and the logs it is
about to print (on rank 0 only, under a process group: the checkpoint and
the event files are written once). :class:`TensorBoardCallback` writes
those logs as TensorBoard events (:mod:`posterior_matching_torch.train.
tensorboard`, without tensorboardX, which the card does not have). The JAX package's
``OrbaxCheckpointCallback`` (:68-110) is left out: Orbax is not on the card
and no CLI uses it; ``train_state.pkl`` is the checkpoint.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np

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

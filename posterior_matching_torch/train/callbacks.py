"""Validation-time callbacks of the trainer.

Counterpart of ``posterior_matching_tpu/train/callbacks.py:12-41``:
:meth:`Trainer.fit <posterior_matching_torch.train.trainer.Trainer.fit>`
calls ``on_validation_step(model, generator, batch)`` of each
:class:`Callback` on every validation batch, then
``on_validation_end(train_state, step, logs)`` after the validation, with
the state as the JAX package's ``TrainState`` holds it and the logs it is
about to print. The
TensorBoard writer waits: it needs tensorboardX, which the port does not
use.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

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
        save_train_state(self._path, train_state)


class LearningRateLoggerCallback(Callback):
    """Adds the schedule's ``learning_rate`` at the step to the logs."""

    def __init__(self, schedule: Callable[[int], float]):
        self._schedule = schedule

    def on_validation_end(self, train_state, step, logs):
        logs["learning_rate"] = float(self._schedule(step))

"""Train state and the ``train_state.pkl`` checkpoint contract.

Counterpart of ``posterior_matching_tpu/train/state.py:20-55``: the same
field names (``params``, ``state``, ``opt_state``, ``ema_params``, ``step``)
holding plain numpy trees, so a run directory written by either package is
read by the other.

A pickle written by the JAX package names its classes by their JAX-side
import paths. A plain ``pickle.load`` would import the JAX package (and JAX
with it) to rebuild them, so :func:`load_train_state` maps those names onto
this package's own types instead.

The other way round, :func:`save_train_state` writes the ``TrainState``
under the JAX package's name, ``posterior_matching_tpu.train.state.
TrainState``, holding numpy trees only, so the JAX package's plain
``pickle.load`` reads it without this package or torch being importable.
Pickle's own ``save_global`` imports the module a class names to check it,
which would import JAX here; :class:`_JaxNamedPickler` writes those
references without the lookup: ``TrainState``'s, and each
:class:`ForeignRecord` class's own (so an optax state the port writes,
``convert.optax_opt_state``, is rebuilt as optax's by a plain
``pickle.load``).
"""
from __future__ import annotations

import copyreg
import functools
import pickle
from dataclasses import dataclass
from typing import Any


@dataclass
class TrainState:
    params: Any
    state: Any
    opt_state: Any = None
    ema_params: Any = None
    step: Any = 0


# Where the JAX package defines ``TrainState``: the name a checkpoint of
# either package gives it.
_JAX_TRAIN_STATE = ("posterior_matching_tpu.train.state", "TrainState")


class ForeignRecord:
    """Stand-in for an object of a JAX-side library (an optax state, say)
    in a checkpoint. Each foreign class path has its own subclass
    (:func:`foreign_class`; ``module`` and ``__name__`` say which); an
    instance keeps the constructor arguments (and pickled state) as read,
    and is written back under its class path with the same arguments, as
    pickle writes a named tuple."""

    module = ""

    def __new__(cls, *args):
        obj = super().__new__(cls)
        obj.args = args
        return obj

    def __setstate__(self, state):
        self.state = state

    def __reduce_ex__(self, protocol):
        out = (copyreg.__newobj__, (type(self), *self.args))
        return out + (self.state,) if hasattr(self, "state") else out

    def __repr__(self):
        return f"{type(self).__name__}{self.args!r}"


@functools.lru_cache(maxsize=None)
def foreign_class(module: str, name: str) -> type:
    """The :class:`ForeignRecord` subclass standing for ``module.name``,
    one per class path."""
    return type(name, (ForeignRecord,), {"module": module})


# Libraries whose classes a JAX-written checkpoint may name; importing any
# of them would pull in JAX.
_FOREIGN_ROOTS = frozenset(
    {"jax", "jaxlib", "flax", "optax", "chex", "ml_collections",
     "posterior_matching_tpu"}
)

_CLASS_MAP = {
    _JAX_TRAIN_STATE: TrainState,
    ("flax.core.frozen_dict", "FrozenDict"): dict,
}


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        mapped = _CLASS_MAP.get((module, name))
        if mapped is not None:
            return mapped
        if module.split(".")[0] in _FOREIGN_ROOTS:
            return foreign_class(module, name)
        return super().find_class(module, name)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if hasattr(tree, "detach"):  # torch.Tensor
        return tree.detach().cpu().numpy()
    return tree


class _JaxNamedPickler(pickle._Pickler):
    """The pure-Python pickler, with :class:`TrainState` written under the
    JAX package's module path and each :class:`ForeignRecord` class under
    its own. Every other global (numpy's reconstructors) is written and
    checked as usual."""

    def save_global(self, obj, name=None):
        if obj is TrainState:
            module, qualname = _JAX_TRAIN_STATE
        elif isinstance(obj, type) and issubclass(obj, ForeignRecord) and obj.module:
            module, qualname = obj.module, obj.__name__
        else:
            return super().save_global(obj, name)
        self.save(module)
        self.save(qualname)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def save_train_state(path: str, train_state: TrainState) -> None:
    """Writes ``train_state`` with every tensor as a numpy array. The trees
    should be in the JAX package's layout (``convert.pm_vqvae_trees``) for
    the JAX package to evaluate them."""
    host_state = TrainState(
        params=_to_numpy(train_state.params),
        state=_to_numpy(train_state.state),
        opt_state=_to_numpy(train_state.opt_state),
        ema_params=_to_numpy(train_state.ema_params),
        step=int(train_state.step),
    )
    with open(path, "wb") as fp:
        _JaxNamedPickler(fp, protocol=4).dump(host_state)


def load_train_state(path: str) -> TrainState:
    """Reads a ``train_state.pkl`` written by either package. Unpickling
    runs code named in the file: load only checkpoints this project wrote."""
    with open(path, "rb") as fp:
        out = _PortUnpickler(fp).load()
    if not isinstance(out, TrainState):
        raise TypeError(f"{path} holds a {type(out).__name__}, not a TrainState")
    return out


"""``SnapshotCallback``, the port's ``OrbaxCheckpointCallback``, on the CPU.

- Retention: of four validations' snapshots the newest ``max_to_keep``
  are kept (all with None), each a whole directory named by its step;
- ``restore_latest()`` is None before any snapshot; after ``Trainer.fit``
  it is the same step's ``train_state.pkl`` (``CheckpointCallback``'s)
  array for array, dtypes included;
- the save is asynchronous on a host copy: arrays changed in place after
  ``on_validation_end`` returns do not reach the snapshot;
- an interrupted save (the writer failing half-way) leaves no step
  directory and no temporary one; its error is raised by the next wait;
  the snapshots before it stay restorable;
- the tree (its keys, ``None`` where optax keeps an empty state, lists for
  tuples, each leaf's values and dtype) is what the JAX package's
  ``OrbaxCheckpointCallback.restore_latest()`` returns for the same numpy
  ``TrainState``, read by each package from one ``train_state.pkl``: a
  PM-VQVAE's (a frozen VQ-VAE: ``PartitionState``, ``MaskedNode``) and a
  PM-VDVAE's (the clipped chain, EMA parameters);
- over two gloo ranks the trainer calls the callback on rank 0 only, and
  DCP enters no collective: both ranks finish inside their time limit and
  see rank 0's one snapshot.
"""
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from posterior_matching_tpu.train.callbacks import OrbaxCheckpointCallback
from posterior_matching_tpu.train.state import load_train_state as jax_load
from posterior_matching_torch.data.datasets import ArrayDataset
from posterior_matching_torch.train import callbacks
from posterior_matching_torch.train.callbacks import (
    CheckpointCallback,
    SnapshotCallback,
    snapshot_tree,
)
from posterior_matching_torch.train.optim import Adam
from posterior_matching_torch.train.state import TrainState, load_train_state, save_train_state
from posterior_matching_torch.train.trainer import Trainer
from test_torch_resume import _case
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

X = np.random.RandomState(0).randn(32, 4).astype(np.float32)


def assert_same_tree(got, want, path="tree"):
    """The same containers and keys, None and Python scalars equal, and
    numpy arrays equal bit for bit with the same dtype."""
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), (path, list(got), list(want))
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{path}/{i}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
    else:
        assert got == want, path


def _trainer():
    torch.manual_seed(0)
    return Trainer(torch.nn.Linear(4, 4),
                   lambda model, batch, seed, training: (
                       (model(batch["features"]) - batch["features"]) ** 2).mean(),
                   optimizer=lambda params: Adam(params, lambda count: 1e-2), device="cpu")


def _state(step=0):
    params = {"w": np.arange(6, dtype=np.float32).reshape(2, 3) + step, "b": np.zeros(3)}
    return TrainState(params=params, state={}, opt_state=None, ema_params=None, step=step)


@pytest.mark.parametrize("max_to_keep", [1, 2, None])
def test_the_newest_snapshots_are_kept(max_to_keep, tmp_path):
    cb = SnapshotCallback(str(tmp_path / "snap"), max_to_keep=max_to_keep)
    assert cb.restore_latest() is None
    for step in (10, 20, 30, 40):
        cb.on_validation_end(_state(step), step, {})
    cb.close()
    kept = [10, 20, 30, 40][-(max_to_keep or 4):]
    assert cb.steps() == kept
    assert sorted(os.listdir(tmp_path / "snap")) == sorted(map(str, kept))
    assert_same_tree(cb.restore_latest(), snapshot_tree(_state(40), 40))


def test_restore_latest_is_the_checkpoint_of_its_step(tmp_path):
    snap = SnapshotCallback(str(tmp_path / "snap"), max_to_keep=2)
    trainer = _trainer()
    trainer.fit(ArrayDataset({"features": X}, 8, shuffle=True, seed=1), 6, validation_freq=2,
                callbacks=[snap, CheckpointCallback(str(tmp_path / "train_state.pkl"))])
    got = snap.restore_latest()   # waits for step 6's save
    assert snap.steps() == [4, 6]
    assert_same_tree(got, snapshot_tree(load_train_state(str(tmp_path / "train_state.pkl")), 6))
    assert got["step"] == 6 and got["opt_state"][0]["count"] == np.int32(6)
    snap.close()


def test_the_save_writes_a_host_copy(tmp_path):
    state = _state(3)
    want = snapshot_tree(state, 3)
    want["params"] = {k: v.copy() for k, v in want["params"].items()}
    cb = SnapshotCallback(str(tmp_path / "snap"))
    cb.on_validation_end(state, 3, {})
    for v in state.params.values():
        v.fill(np.nan)
    assert_same_tree(cb.restore_latest(), want)
    with pytest.raises(ValueError, match="a snapshot of step 3 exists"):
        cb.on_validation_end(_state(3), 3, {})
    cb.close()


def test_an_interrupted_save_leaves_no_step(tmp_path, monkeypatch):
    import torch.distributed.checkpoint as dcp

    cb = SnapshotCallback(str(tmp_path / "snap"))
    cb.on_validation_end(_state(1), 1, {})
    cb.wait()
    real_save = dcp.save

    def dies_half_way(state_dict, checkpoint_id, **kw):
        real_save(dict(list(state_dict.items())[:1]), checkpoint_id=checkpoint_id, **kw)
        raise OSError("the disk went away")

    monkeypatch.setattr(dcp, "save", dies_half_way)
    cb.on_validation_end(_state(2), 2, {})
    with pytest.raises(OSError, match="the disk went away"):
        cb.wait()
    assert os.listdir(tmp_path / "snap") == ["1"]
    monkeypatch.setattr(dcp, "save", real_save)
    assert_same_tree(cb.restore_latest(), snapshot_tree(_state(1), 1))
    # a temporary directory a dead process left is cleared by the next save
    os.makedirs(tmp_path / "snap" / f"{callbacks._TMP}7")
    cb.on_validation_end(_state(3), 3, {})
    cb.close()
    assert sorted(os.listdir(tmp_path / "snap")) == ["1", "3"]


@pytest.mark.parametrize("name", ["pm_vqvae", "pm_vdvae"])
def test_the_tree_is_orbaxs(name, tmp_path):
    trainer, _, _ = _case(name)
    trainer.init()
    path = str(tmp_path / "train_state.pkl")
    save_train_state(path, trainer.train_state())
    jax_cb = OrbaxCheckpointCallback(str(tmp_path / "orbax"), max_to_keep=2)
    jax_cb.on_validation_end(jax_load(path), 5, {})
    want = jax_cb.restore_latest()
    cb = SnapshotCallback(str(tmp_path / "snap"), max_to_keep=2)
    cb.on_validation_end(load_train_state(path), 5, {})
    got = cb.restore_latest()
    cb.close()
    # Orbax's dicts come back with their keys sorted
    sort = lambda t: ({k: sort(t[k]) for k in sorted(t)} if isinstance(t, dict)
                      else [sort(v) for v in t] if isinstance(t, list) else t)
    assert_same_tree(sort(got), sort(want))


def test_two_ranks_snapshot_on_rank_0_only(tmp_path):
    with open(tmp_path / "inputs.pkl", "wb") as fp:
        pickle.dump({"features": X, "workdir": str(tmp_path)}, fp)
    worker.spawn_command([sys.executable, str(worker.WORKER), str(tmp_path), "snapshots"],
                         timeout=90)
    ranks = [worker._load(tmp_path / f"snapshots.{r}.pkl") for r in range(2)]
    assert ranks[0]["steps"] == ranks[1]["steps"] == [4]
    assert_same_tree(ranks[0]["restored"], ranks[0]["checkpoint"])
    assert "restored" not in ranks[1]

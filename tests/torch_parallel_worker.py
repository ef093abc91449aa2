"""A rank of the port's multi-process CPU tests (not collected by pytest).

Run as ``python torch_parallel_worker.py <workdir> <task> [<task> ...]`` in
an environment that names the rank as ``python -m torch.distributed.run``
does (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``): it joins the gloo process group on the CPU
(``maybe_initialize_distributed(device="cpu")``; on card 0 over gloo where
``PM_PARALLEL_DEVICE=cuda``), runs each task of
:data:`TASKS` in turn, reading its inputs from ``<workdir>/inputs.pkl``
(written by the test) and writing what it saw to
``<workdir>/<task>.<rank>.pkl``. It imports no JAX: the tests hold its
results against the JAX package in their own process.

:func:`spawn` starts the ranks, each with its own time limit, and raises
with their output when one fails.
"""
from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

WORKER = Path(__file__).resolve()
REPO = WORKER.parents[1]
RANK_TIMEOUT = 120
# The ranks' device: the CPU, or the GPU (``cuda``: every rank on card 0,
# over gloo) where the environment names it.
DEVICE = os.environ.get("PM_PARALLEL_DEVICE", "cpu")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int, extra=None):
    env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    env.update(extra or {})
    return env


def spawn_command(argv, world: int = 2, cwd=None, env=None, timeout: int = RANK_TIMEOUT):
    """Runs ``argv`` as ``world`` ranks of one gloo group on the CPU;
    returns each rank's standard output. Raises, with every rank's output,
    when a rank exits non-zero or outlives ``timeout`` seconds."""
    port = free_port()
    procs = [subprocess.Popen(argv, cwd=cwd, env=rank_env(r, world, port, env),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    outs, failed = [], False
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, err = p.communicate()
            err += f"\n[killed after {timeout} s]"
            failed = True
        failed |= p.returncode != 0
        outs.append((p.returncode, out, err))
    if failed:
        raise AssertionError("\n".join(f"--- rank {r} (exit {rc})\n{out}\n{err[-4000:]}"
                                       for r, (rc, out, err) in enumerate(outs)))
    return [out for _, out, _ in outs]


def spawn(workdir, *tasks, world: int = 2):
    """Runs ``tasks`` of this worker in ``world`` ranks; returns each
    task's per-rank results."""
    spawn_command([sys.executable, str(WORKER), str(workdir), *tasks], world)
    return {t: [_load(Path(workdir) / f"{t}.{r}.pkl") for r in range(world)] for t in tasks}


def _load(path):
    with open(path, "rb") as fp:
        return pickle.load(fp)


# ---------------------------------------------------------------------------
# Tasks: inputs(dict) -> this rank's results (picklable)
# ---------------------------------------------------------------------------


def _numpy(tensors):
    return {k: v.detach().cpu().numpy().copy() for k, v in tensors.items()}


def task_mesh(inputs):
    import torch

    from posterior_matching_torch.parallel import mesh

    r, w = mesh.rank(), mesh.world_size()
    out = {"rank": r, "world": w}
    batch = {"x": torch.arange(12.0).reshape(6, 2), "y": torch.arange(6)}
    out["shard"] = _numpy(mesh.shard_batch(batch))
    try:
        mesh.shard_batch({"x": torch.zeros(5, 2)})
    except ValueError as err:
        out["refused"] = str(err)
    mixed = [torch.full((3, 2), float(r + 1)), torch.tensor(10.0 * (r + 1)),
             torch.arange(4.0) * (r + 1)]
    out["mean"] = [t.numpy() for t in mesh.all_reduce_mean(mixed)]
    out["sum"] = [t.numpy() for t in mesh.all_reduce_sum(mixed)]
    torch.manual_seed(100 + r)
    module = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.BatchNorm1d(2))
    module[1].num_batches_tracked.fill_(7 + r)
    mesh.broadcast_module(module)
    out["module"] = _numpy(module.state_dict())
    rows = torch.arange(6.0).reshape(3, 2) + 100 * r
    out["gathered"] = mesh.gather_rows(rows).numpy()
    out["gathered_int"] = mesh.gather_rows(torch.tensor([r, -r])).numpy()
    gen = torch.Generator().manual_seed(5)
    if r == 0:
        torch.rand(3, generator=gen)
    mesh.sync_generator(gen)
    out["after_sync"] = torch.rand(2, generator=gen).numpy()
    return out


def _global_batches(inputs, key="batches"):
    import torch

    return [{k: torch.from_numpy(v) for k, v in b.items()} for b in inputs[key]]


def task_pm_vqvae(inputs):
    """The toy PM-VQVAE of ``test_torch_train.py`` at the test's global
    batches (dropout 0, masks passed in)."""
    from posterior_matching_torch import convert
    from posterior_matching_torch.config import PM_VQVAE_CELEB_A_TRAIN
    from posterior_matching_torch.train.trainer import pm_vqvae_trainer

    cond, vq, pc = inputs["pm_vqvae"]
    model = convert.pm_vqvae_from_jax(*inputs["pm_vqvae_tree"], cond, vq, pc, device="cpu")
    trainer = pm_vqvae_trainer(model, PM_VQVAE_CELEB_A_TRAIN, seed=0, device="cpu")
    trainer.init()
    losses = [trainer.train_step(b)["loss"].item() for b in _global_batches(inputs)]
    return {"losses": losses, "state": _numpy(model.state_dict())}


def task_vq_ema(inputs):
    """Stage 1's trainer on the test's global image batches."""
    from posterior_matching_torch import convert
    from posterior_matching_torch.train.trainer import vqvae_trainer

    params, state, cfg = inputs["vqvae"]
    model = convert.vqvae_from_jax(params, state, cfg, device="cpu")
    trainer = vqvae_trainer(model, {"learning_rate": inputs["vqvae_lr"]}, seed=0, device="cpu")
    trainer.init()
    metrics = [{k: v.item() for k, v in trainer.train_step(b).items()}
               for b in _global_batches(inputs, "vq_batches")]
    return {"metrics": metrics, "state": _numpy(model.state_dict())}


def normals_shapes(model, batch):
    """The shapes of the standard normals that a PM-VDVAE training forward
    of ``batch`` draws, in call order."""
    import torch

    from posterior_matching_torch.distributions import normal
    from posterior_matching_torch.models import vdvae
    from posterior_matching_torch.train.trainer import pm_vdvae_metrics

    shapes, draw = [], normal.standard_normal

    def record(noise, shape, device):
        shapes.append(tuple(shape))
        return draw(noise, shape, device)

    normal.standard_normal = vdvae.standard_normal = record
    try:
        pm_vdvae_metrics(model, batch, torch.Generator(device=model.device).manual_seed(0))
    finally:
        normal.standard_normal = vdvae.standard_normal = draw
    return shapes


def vdvae_trainer(inputs, device=None):
    """``pm_vdvae_trainer`` on the test's weights (its ``vdvae_config``),
    its normals injected: step ``s`` draws the rank's rows of the test's
    global normals for that step, in call order."""
    import torch

    from posterior_matching_torch import convert
    from posterior_matching_torch.config import PM_VDVAE_MNIST_TRAIN
    from posterior_matching_torch.parallel import mesh
    from posterior_matching_torch.train.trainer import pm_vdvae_metrics, pm_vdvae_trainer

    device = device or DEVICE
    tree, cfg = inputs["vdvae_tree"], inputs["vdvae_config"]
    model = convert.pm_vdvae_from_jax(tree, cfg, device=device)
    trainer = pm_vdvae_trainer(model, dict(PM_VDVAE_MNIST_TRAIN, **inputs["vdvae_train"]),
                               seed=0, device=device)
    normals = inputs["vdvae_normals"]

    def loss_fn(model, batch, seed, training):
        eps = iter([torch.from_numpy(mesh.shard_batch(e)) for e in normals[trainer.step]])
        return pm_vdvae_metrics(model, batch, eps, training)

    trainer.loss_fn = loss_fn
    trainer.init()
    return trainer


def params_close(got, want, lr, steps, moment_tol, step_share):
    """Raises unless each parameter (and EMA parameter) of ``got`` is within
    ``step_share`` of the rate a step of ``want``'s, or, where ``want``'s
    gradient mean is within ``moment_tol`` of its tensor's scale of zero
    (its sign not determined at the gradients' precision: Adam moves it by
    up to the rate either way), within twice the rate a step."""
    import numpy as np

    for key in ("params", "ema"):
        for name, w in want[key].items():
            mu = want["mu"].get(name)
            tol = np.full(w.shape, step_share * lr * steps)
            if mu is not None:
                tol[np.abs(mu) <= moment_tol * np.abs(mu).max()] = 2 * lr * steps
            bad = np.abs(got[key][name] - w) > tol
            assert not bad.any(), (f"{key} {name}: {int(bad.sum())} of {bad.size} beyond the "
                                   f"bound, worst {float(np.abs(got[key][name] - w).max())}")


def trainer_state(trainer):
    opt = trainer.optimizer
    return {"params": _numpy(dict(trainer.model.named_parameters())),
            "ema": trainer.ema_params and _numpy(trainer.ema_params),
            "mu": _numpy(opt.mu), "nu": _numpy(opt.nu),
            "count": int(opt.count), "step": trainer.step}


def task_vdvae(inputs):
    trainer = vdvae_trainer(inputs)
    metrics = [{k: v.item() for k, v in trainer.train_step(b).items()}
               for b in _global_batches(inputs, "vdvae_batches")]
    return {"metrics": metrics, **trainer_state(trainer)}


def task_skip(inputs):
    """A stage-1 step under ``skip_nonfinite_updates`` whose NaN image lies
    in rank 1's rows only: the forward moves the EMA codebook on every rank
    (its statistics are summed over the ranks), and every rank must skip
    and restore it."""
    import torch

    from posterior_matching_torch import convert
    from posterior_matching_torch.train.trainer import vqvae_trainer

    params, state, cfg = inputs["vqvae"]
    model = convert.vqvae_from_jax(params, state, cfg, device="cpu")
    trainer = vqvae_trainer(model, {"learning_rate": 1e-3}, seed=0, device="cpu",
                            skip_nonfinite_updates=True)
    trainer.init()
    first, *_ = _global_batches(inputs, "vq_batches")
    trainer.train_step(first)
    before = _numpy(model.state_dict())
    bad = first["image"].clone()
    bad[-1] = float("nan")
    skipped = trainer.train_step({"image": bad})["skipped"].item()
    after = _numpy(model.state_dict())
    return {"skipped": skipped, "count": int(trainer.optimizer.count),
            "unchanged": sorted(k for k in before if (before[k] == after[k]).all()),
            "names": sorted(before)}


def task_dropout(inputs):
    """One PM-VQVAE step at dropout 0.5 on a global batch whose two halves
    are the same rows: each rank's own loss (before the reduction) and the
    seed its loss drew from."""
    from posterior_matching_torch import convert
    from posterior_matching_torch.config import PM_VQVAE_CELEB_A_TRAIN
    from posterior_matching_torch.train.trainer import pm_vqvae_loss, pm_vqvae_trainer

    cond, vq, pc = inputs["pm_vqvae"]
    model = convert.pm_vqvae_from_jax(*inputs["pm_vqvae_tree"], cond, vq,
                                      dict(pc, dropout=0.5), device="cpu")
    trainer = pm_vqvae_trainer(model, PM_VQVAE_CELEB_A_TRAIN, seed=0, device="cpu")
    seen = []

    def loss_fn(model, batch, seed, training):
        loss = pm_vqvae_loss(model, batch, seed, training)
        seen.append((seed, loss.item()))
        return loss

    trainer.loss_fn = loss_fn
    trainer.init()
    half = _global_batches(inputs)[0]
    n = half["image"].shape[0] // 2
    trainer.train_step({k: v[:n].repeat(2, *([1] * (v.ndim - 1))) for k, v in half.items()})
    return {"seed": seen[0][0], "loss": seen[0][1]}


def task_resume(inputs):
    """``Trainer.fit`` of the toy PM-VQVAE over an ``ArrayDataset`` of the
    test's global batches: to step 4 from the test's W = 1 checkpoint at
    step 2 (``resume_from``), and straight to step 4; rank 0's states."""
    import numpy as np

    from posterior_matching_torch import convert
    from posterior_matching_torch.config import PM_VQVAE_CELEB_A_TRAIN
    from posterior_matching_torch.data.datasets import ArrayDataset
    from posterior_matching_torch.train.state import load_train_state
    from posterior_matching_torch.train.trainer import pm_vqvae_trainer

    cond, vq, pc = inputs["pm_vqvae"]
    data = {k: np.concatenate([b[k] for b in inputs["batches"]]) for k in ("image", "mask")}
    out = {}
    for name, resume in (("straight", None), ("resumed", inputs["resume_checkpoint"])):
        model = convert.pm_vqvae_from_jax(*inputs["pm_vqvae_tree"], cond, vq, pc, device="cpu")
        trainer = pm_vqvae_trainer(model, PM_VQVAE_CELEB_A_TRAIN, seed=0, device="cpu")
        dataset = ArrayDataset(data, inputs["batches"][0]["image"].shape[0])
        trainer.fit(dataset, 4, validation_freq=2,
                    resume_from=None if resume is None else load_train_state(resume))
        out[name] = trainer_state(trainer)
    return out


def task_snapshots(inputs):
    """``Trainer.fit`` of a small linear model over the test's ``features``
    (4 steps, validating every 2) with a ``SnapshotCallback`` and a
    ``CheckpointCallback`` on every rank, which the trainer calls on rank 0
    only: rank 0's ``restore_latest()`` and its ``train_state.pkl`` as a
    snapshot tree; every rank's view of the snapshot steps after a
    barrier."""
    import torch

    from posterior_matching_torch.data.datasets import ArrayDataset
    from posterior_matching_torch.parallel import mesh
    from posterior_matching_torch.train.callbacks import (
        CheckpointCallback,
        SnapshotCallback,
        snapshot_tree,
    )
    from posterior_matching_torch.train.optim import Adam
    from posterior_matching_torch.train.state import load_train_state
    from posterior_matching_torch.train.trainer import Trainer

    torch.manual_seed(0)
    x = inputs["features"]
    trainer = Trainer(torch.nn.Linear(x.shape[1], x.shape[1]),
                      lambda model, batch, seed, training: (
                          (model(batch["features"]) - batch["features"]) ** 2).mean(),
                      optimizer=lambda params: Adam(params, lambda count: 1e-2), device="cpu")
    workdir = Path(inputs["workdir"])
    snap = SnapshotCallback(str(workdir / "snapshots"), max_to_keep=1)
    pkl = str(workdir / "train_state.pkl")
    trainer.fit(ArrayDataset({"features": x}, 8), 4, validation_freq=2,
                callbacks=[snap, CheckpointCallback(pkl)])
    out = {}
    if mesh.rank() == 0:
        out["restored"] = snap.restore_latest()
        out["checkpoint"] = snapshot_tree(load_train_state(pkl), 4)
    snap.close()
    torch.distributed.barrier()
    out["steps"] = snap.steps()
    return out


def imputation_eval(inputs):
    """``run_imputation_eval`` over the test's PM-VQVAE images (batches of
    4, 2 trials of 2 samples) with an imputation that zeroes the missing
    pixels, the embedder and PRD counted: ``(results or None, calls,
    the generator's state after)``."""
    import numpy as np
    import torch

    from posterior_matching_torch.data.datasets import ArrayDataset
    from posterior_matching_torch.eval import imputation
    from posterior_matching_torch.masking import get_mask_generator

    calls = {"embeddings": 0, "prd": 0}
    kept = imputation.get_inception_embeddings, imputation.compute_prd_from_embedding

    def counted(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    def evaluate(x, b, g):
        imp = (x * b)[:, None].expand(-1, 2, -1, -1, -1)
        return -10.0 * torch.log10(((imp.mean(1) - x) ** 2).mean((1, 2, 3))), imp

    images = np.concatenate([b["image"] for b in inputs["batches"]])
    gen = torch.Generator().manual_seed(91)
    imputation.get_inception_embeddings = counted("embeddings", kept[0])
    imputation.compute_prd_from_embedding = counted("prd", kept[1])
    try:
        results = imputation.run_imputation_eval(
            ArrayDataset({"image": images}, 4), evaluate,
            get_mask_generator("RectangleMaskGenerator", "cpu"), 2, 2, gen)
    finally:
        imputation.get_inception_embeddings, imputation.compute_prd_from_embedding = kept
    return results, calls, gen.get_state().numpy()


def task_imputation_eval(inputs):
    return imputation_eval(inputs)


TASKS = {name[len("task_"):]: fn for name, fn in globals().items() if name.startswith("task_")}


def main(argv) -> int:
    workdir, tasks = Path(argv[0]), argv[1:]
    import torch

    from posterior_matching_torch.parallel import mesh

    torch.set_num_threads(1)
    if not mesh.maybe_initialize_distributed(device=DEVICE, backend="gloo"):
        raise RuntimeError("the worker needs the launcher's environment")
    inputs = _load(workdir / "inputs.pkl")
    for task in tasks:
        result = TASKS[task](inputs)
        with open(workdir / f"{task}.{mesh.rank()}.pkl", "wb") as fp:
            pickle.dump(result, fp)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    sys.exit(main(sys.argv[1:]))

"""The port's data parallelism over two gloo ranks on the CPU.

Each module-scoped run spawns two ranks of ``torch_parallel_worker.py``
(the launcher's environment set by hand, each rank with its own time
limit) and holds what they saw:

- the mesh: ``shard_batch``'s contiguous rows and its refusal of a batch
  the ranks do not divide, ``all_reduce_mean`` / ``all_reduce_sum`` over
  tensors of mixed shapes in one bucket, ``broadcast_module`` (a float and
  an int buffer), ``gather_rows`` in rank order, ``sync_generator``; with
  no launcher's environment no group starts and every helper returns its
  input;
- PM-VDVAE: ``pm_vdvae_trainer`` at ``TINY_CONFIG`` with two ranks equals
  one process on the same global batch, each rank's normals its rows of
  the one-process run's: parameters, EMA parameters, Adam's moments and
  ``skipped`` after 2 steps, the global-norm clip active in both. The two
  sum in another order (two shards' means, then their mean): the moments,
  the gradients' running means and squares, within the repo's gradient
  bar, 1e-4 of scale (``test_torch_train.py``'s first-step gradients,
  ``chip_smoke.py``'s GRAD_TOL; on the GPU the chain kernels' row tiles
  change with the rows a rank holds, and a bias gradient there reads
  1.5e-5 to 1.7e-5 of scale off), and the parameters and their EMA
  within 5% of the learning rate a step, or within twice the rate where
  the gradient is within that bar of zero: Adam's first step moves a
  parameter by ``lr g / (|g| + eps)``, so a gradient whose sign the two
  orders of summation do not agree on moves it by up to the rate either
  way (on the GPU two of 16,384 decoder biases did, by 0.67 of the rate);
  a missing reduction flips whole swathes of updates, a clip of the local
  norm shows in the moments;
- the skip: a stage-1 VQ-VAE step whose NaN image lies in rank 1's rows
  only is skipped on both ranks, and every parameter and buffer (the EMA
  codebook, which the forward moved on both, among them) is restored;
- dropout: the two ranks, given the same rows, draw different dropout
  masks (different losses from seeds with the rank folded in);
- resume: two ranks resuming a one-process checkpoint at step 2 equal the
  straight two-rank run at step 4 (the first steps agree to rounding):
  the parameters within ``test_torch_train.py``'s 2e-6;
- the image evals' protocol: every rank embeds every imputation and runs
  PRD on the shared generator (so no rank waits in a collective while
  another does work that grows with the dataset), the generators end
  equal, and rank 0's results are the one-process run's bit for bit;
- ``maybe_initialize_distributed`` sets the rank's device before the group
  starts, picks gloo for the CPU and nccl for the GPU, and refuses nccl on
  the CPU; the single-device CLIs refuse ``WORLD_SIZE=2`` by name before
  any group starts.
"""
import pickle

import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from posterior_matching_torch import (
    convert,
    eval_greedy_acquisition,
    eval_pm_vae_uci,
    train_lookahead_posterior,
    train_pm_vade,
    train_pm_vae,
    train_pm_vqvae,
    train_vade,
    train_vqvae,
)
from posterior_matching_torch.config import PM_VDVAE_MNIST_TRAIN, PM_VQVAE_CELEB_A_TRAIN
from posterior_matching_torch.parallel import mesh
from posterior_matching_torch.train.trainer import pm_vqvae_trainer
from test_torch_train import COND, PC, VQ
from test_torch_vdvae import TINY_CONFIG
from test_torch_vqvae_train import CFG as VQ_CFG

VDVAE_TRAIN = {"gradient_clip": 20.0}   # below the toy's gradient norms
MOMENT_TOL, PARAM_STEP_SHARE, RESUME_PARAM_TOL = 1e-4, 0.05, 2e-6


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rng = np.random.RandomState(7)
    batches = [{"image": rng.rand(4, 16, 16, 3).astype(np.float32),
                "mask": (rng.rand(4, 16, 16, 1) > 0.5).astype(np.float32)} for _ in range(3)]
    vdvae_batches = [{"image": rng.randint(0, 256, (4, 8, 8, 1)).astype(np.float32),
                      "mask": (rng.rand(4, 8, 8, 1) > 0.5).astype(np.float32)}
                     for _ in range(2)]
    tree = convert.random_pm_vdvae_tree(TINY_CONFIG, seed=4)
    model = convert.pm_vdvae_from_jax(tree, TINY_CONFIG, device="cpu")
    shapes = worker.normals_shapes(model, {k: torch.from_numpy(v)
                                           for k, v in vdvae_batches[0].items()})
    assert all(s[0] == 4 for s in shapes), shapes
    normals = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(2)]
    out = {
        "batches": batches,
        "pm_vqvae": (COND, VQ, PC),
        "pm_vqvae_tree": convert.random_pm_vqvae_tree(COND, VQ, PC, seed=3),
        "vqvae": (*convert.init_vqvae_tree(VQ_CFG, seed=2), VQ_CFG),
        "vq_batches": [{"image": rng.rand(4, 8, 8, 1).astype(np.float32)}],
        "vdvae_tree": tree, "vdvae_config": TINY_CONFIG, "vdvae_train": VDVAE_TRAIN,
        "vdvae_batches": vdvae_batches, "vdvae_normals": normals,
    }
    workdir = tmp_path_factory.mktemp("parallel")
    # the one-process checkpoint the ranks resume: 2 steps of the stream
    cond, vq, pc = out["pm_vqvae"]
    trainer = pm_vqvae_trainer(convert.pm_vqvae_from_jax(*out["pm_vqvae_tree"], cond, vq, pc,
                                                         device="cpu"),
                               PM_VQVAE_CELEB_A_TRAIN, seed=0, device="cpu")
    trainer.init()
    for b in batches[:2]:
        trainer.train_step(b)
    out["resume_checkpoint"] = str(workdir / "train_state.pkl")
    trainer.save_checkpoint(out["resume_checkpoint"])
    with open(workdir / "inputs.pkl", "wb") as fp:
        pickle.dump(out, fp)
    return workdir, out


@pytest.fixture(scope="module")
def ranks(inputs):
    workdir, _ = inputs
    return worker.spawn(workdir, "mesh", "vdvae", "skip", "dropout", "resume",
                        "imputation_eval")


def test_shard_batch_takes_contiguous_rows_and_refuses_a_ragged_batch(ranks):
    for r, out in enumerate(ranks["mesh"]):
        assert (out["rank"], out["world"]) == (r, 2)
        np.testing.assert_array_equal(out["shard"]["x"],
                                      np.arange(12.0).reshape(6, 2)[3 * r:3 * r + 3])
        np.testing.assert_array_equal(out["shard"]["y"], np.arange(3 * r, 3 * r + 3))
        assert out["refused"] == "a global batch of 5 rows does not divide over 2 ranks"


def test_all_reduce_over_mixed_shapes_in_one_bucket(ranks):
    for out in ranks["mesh"]:
        want_sum = [np.full((3, 2), 3.0), np.float32(30.0), np.arange(4.0) * 3]
        for got, want in zip(out["sum"], want_sum):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(out["mean"], want_sum):
            np.testing.assert_array_equal(got, np.asarray(want) / 2)
        assert [m.shape for m in out["mean"]] == [(3, 2), (), (4,)]


def test_broadcast_module_and_sync_generator_take_rank_0s(ranks):
    a, b = (out["module"] for out in ranks["mesh"])
    torch.manual_seed(100)
    want = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.BatchNorm1d(2)).state_dict()
    for k in want:
        np.testing.assert_array_equal(a[k], b[k])
        if k != "1.num_batches_tracked":
            np.testing.assert_array_equal(a[k], want[k].numpy())
    assert a["1.num_batches_tracked"] == 7
    gen = torch.Generator().manual_seed(5)
    torch.rand(3, generator=gen)
    want = torch.rand(2, generator=gen).numpy()
    for out in ranks["mesh"]:
        np.testing.assert_array_equal(out["after_sync"], want)


def test_gather_rows_puts_the_ranks_rows_back_in_order(ranks):
    want = np.concatenate([np.arange(6.0).reshape(3, 2), np.arange(6.0).reshape(3, 2) + 100])
    for out in ranks["mesh"]:
        np.testing.assert_array_equal(out["gathered"], want)
        np.testing.assert_array_equal(out["gathered_int"], [0, 0, 1, -1])


def test_no_launcher_no_process_group(monkeypatch):
    for k in mesh.LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    assert not mesh.maybe_initialize_distributed(device="cpu")
    assert not mesh.distributed() and (mesh.rank(), mesh.world_size()) == (0, 1)
    batch = {"x": torch.arange(5.0)}
    assert mesh.shard_batch(batch) is batch
    ts = [torch.ones(2), torch.zeros(())]
    assert all(a is b for a, b in zip(mesh.all_reduce_mean(ts), ts))
    assert mesh.gather_rows(ts[0]) is ts[0]


def test_pm_vdvae_two_ranks_equal_one_process(inputs, ranks):
    _, data = inputs
    one = worker.vdvae_trainer(data)
    batches = worker._global_batches(data, "vdvae_batches")
    params = list(one.optimizer.params.values())
    grads = torch.autograd.grad(one.loss_fn(one.model, batches[0], 0, True)[0], params)
    norm = torch.sqrt(sum((g * g).sum() for g in grads)).item()
    assert norm > VDVAE_TRAIN["gradient_clip"], norm   # the clip acts on the first step
    metrics = [one.train_step(b) for b in batches]
    want = worker.trainer_state(one)
    for out in ranks["vdvae"]:
        assert out["count"] == want["count"] == 2 and out["step"] == 2
        assert [m["skipped"] for m in out["metrics"]] == [m["skipped"].item() for m in metrics]
        np.testing.assert_allclose([m["loss"] for m in out["metrics"]],
                                   [m["loss"].item() for m in metrics], rtol=1e-5)
        for key, tol in (("mu", MOMENT_TOL), ("nu", MOMENT_TOL)):
            for name, w in want[key].items():
                np.testing.assert_allclose(out[key][name], w, rtol=0,
                                           atol=tol * max(np.abs(w).max(), 1e-12),
                                           err_msg=f"{key} {name}")
        worker.params_close(out, want, PM_VDVAE_MNIST_TRAIN["lr"], len(batches), MOMENT_TOL,
                            PARAM_STEP_SHARE)
    for a, b in zip(*(ranks["vdvae"][r]["params"].values() for r in range(2))):
        np.testing.assert_array_equal(a, b)


def test_nonfinite_rows_on_one_rank_skip_every_rank(ranks):
    for out in ranks["skip"]:
        assert out["skipped"] == 1.0 and out["count"] == 1
        assert out["unchanged"] == out["names"]


def test_ranks_draw_different_dropout_masks(ranks):
    (s0, l0), (s1, l1) = ((o["seed"], o["loss"]) for o in ranks["dropout"])
    assert s0 != s1 and l0 != l1


def test_two_ranks_resume_a_one_process_checkpoint(ranks):
    for out in ranks["resume"]:
        straight, resumed = out["straight"], out["resumed"]
        assert straight["step"] == resumed["step"] == 4
        assert straight["count"] == resumed["count"] == 4
        for name, w in straight["params"].items():
            np.testing.assert_allclose(resumed["params"][name], w, rtol=0,
                                       atol=RESUME_PARAM_TOL, err_msg=name)


def test_imputation_eval_embeds_and_runs_prd_on_every_rank(inputs, ranks):
    (results, calls, state), (none, calls1, state1) = ranks["imputation_eval"]
    assert none is None and calls == calls1 == {"embeddings": 1 + 2 * 2, "prd": 2 * 2}
    np.testing.assert_array_equal(state, state1)
    want, _, want_state = worker.imputation_eval(inputs[1])
    np.testing.assert_array_equal(state, want_state)
    for name in ("psnrs", "prd_data", "f_scores", "per_trial_psnr"):
        np.testing.assert_array_equal(results[name], want[name], err_msg=name)
    assert results["psnrs"].shape == (2, 12)


def test_initialize_sets_the_device_and_picks_the_backend(monkeypatch):
    env = worker.rank_env(1, 2, 12345)
    for k in mesh.LAUNCHER_ENV:
        monkeypatch.setenv(k, env[k])
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: calls.append(("set_device", i)))
    monkeypatch.setattr(mesh.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw["rank"], kw["world_size"],
                                                            kw["timeout"].total_seconds())))
    monkeypatch.setattr(mesh.dist, "barrier", lambda: calls.append("barrier"))
    assert mesh.maybe_initialize_distributed()
    assert calls == [("set_device", 1), ("nccl", 1, 2, 120.0), "barrier"]
    calls.clear()
    assert mesh.maybe_initialize_distributed(backend="gloo")
    assert calls == [("set_device", 1), ("gloo", 1, 2, 120.0), "barrier"]
    calls.clear()
    assert mesh.maybe_initialize_distributed(device="cpu")
    assert calls == [("gloo", 1, 2, 120.0)]
    with pytest.raises(ValueError, match="nccl backend needs the GPU"):
        mesh.maybe_initialize_distributed(device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="unknown backend"):
        mesh.maybe_initialize_distributed(backend="mpi")


SINGLE_DEVICE = [
    (train_vqvae, ["--config", "vqvae_mnist"]),
    (train_pm_vqvae, ["--config", "pm_vqvae_mnist"]),
    (train_pm_vae, ["--config", "pm_vae_gas"]),
    (train_vade, ["--config", "vade_mnist"]),
    (train_pm_vade, ["--config", "pm_vade_mnist"]),
    (train_lookahead_posterior, ["--config", "lookahead_mnist16"]),
    (eval_pm_vae_uci, ["--run_dir", "r", "--dataset", "gas"]),
    (eval_greedy_acquisition, ["--run_dir", "r", "--dataset", "mnist16"]),
]


@pytest.mark.parametrize("module,argv", SINGLE_DEVICE,
                         ids=[m.__name__.rsplit(".", 1)[1] for m, _ in SINGLE_DEVICE])
def test_single_device_clis_refuse_two_ranks(module, argv, monkeypatch):
    for k, v in worker.rank_env(0, 2, 12345).items():
        if k in mesh.LAUNCHER_ENV:
            monkeypatch.setenv(k, v)
    started = []
    monkeypatch.setattr(mesh.dist, "init_process_group", lambda *a, **kw: started.append(a))
    name = module.__name__.rsplit(".", 1)[1]
    with pytest.raises(RuntimeError, match=f"{name} runs on one device.*WORLD_SIZE=2"):
        module.main([*argv, "--device", "cpu"])
    assert not started

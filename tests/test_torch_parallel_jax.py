"""Two gloo ranks of the port against the JAX ``Trainer`` on a two-device
mesh (``num_devices=2`` of the 8 CPU devices ``conftest.py`` forces), at
the same global batches.

- The toy PM-VQVAE of ``test_torch_train.py`` (dropout 0, masks passed
  in), global batch 4, 3 steps: the losses within 1e-5 relative, the
  parameters within 2e-6 absolute, ``vqvae.*`` bit for bit unchanged (that
  file's tolerances and reasons).
- Stage 1's VQ-VAE (the shapes of ``test_torch_vqvae_train.py``) under
  ``vqvae_trainer``, global batch 4, 2 steps: the EMA codebook,
  ``ema_cluster_size`` and ``ema_dw`` within 1e-6 of scale, as the JAX
  mesh computes them over the global batch; the losses and the global
  batch's perplexity within 1e-5 relative. A codebook that followed each
  rank's half alone sits far outside that bound.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_parallel_worker as worker
from posterior_matching_tpu.models.pm_vqvae import PMVQVAE as JaxPMVQVAE
from posterior_matching_tpu.models.vqvae import VQVAE as JaxVQVAE
from posterior_matching_tpu.train import Trainer as JaxTrainer
from posterior_matching_torch import convert
from test_torch_train import COND, LR, PC, VQ
from test_torch_vqvae_train import CFG as VQ_CFG
from test_torch_vqvae_train import EMA
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

VQ_LR = 1e-3
EMA_TOL = 1e-6


def _jax_steps(trainer, ts, batches):
    step = trainer._make_train_step()
    key, metrics = jax.random.PRNGKey(1), []
    for batch in batches:
        ts, m = step(ts, trainer._shard({k: jnp.asarray(v) for k, v in batch.items()}), key)
        metrics.append({k: float(v) for k, v in m.items()})
    return ts, metrics


def jax_pm_vqvae(tree, batches):
    model = JaxPMVQVAE.from_config(COND, VQ, PC)

    def loss_fn(params, state, key, step, batch, is_training):
        ll, _ = model.apply({"params": params, **state}, batch["image"], batch["mask"],
                            training=is_training, rngs={"dropout": key}, mutable=["vq_ema"])
        return -jnp.mean(ll), {}, state

    def init_fn(key, batch):
        k1, k2 = jax.random.split(key)
        variables = model.init({"params": k1, "dropout": k2}, batch["image"], batch["mask"],
                               training=True)
        return variables.pop("params"), dict(variables)

    optimizer = optax.chain(optax.scale_by_adam(),
                            optax.scale_by_schedule(optax.exponential_decay(**LR)),
                            optax.scale(-1.0))
    trainer = JaxTrainer(loss_fn, init_fn, optimizer, num_devices=2, seed=0,
                         trainable_predicate=lambda module, name, value:
                         not module.startswith("vqvae"))
    b0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    ts = trainer.init(b0, initial_params=tree[0], initial_state=tree[1])
    ts, metrics = _jax_steps(trainer, ts, batches)
    return [m["loss"] for m in metrics], jax.device_get(ts.params), jax.device_get(ts.state)


def jax_vqvae(params, state, batches):
    model = JaxVQVAE(**VQ_CFG)

    def loss_fn(params, state, key, step, batch, is_training):   # train_vqvae.py:84-98
        out, new_state = model.apply({"params": params, **state}, batch["image"],
                                     is_training=is_training, mutable=["vq_ema"])
        aux = {"perplexity": jnp.mean(out["vq_output"]["perplexity"]),
               "reconstruction_loss": jnp.mean(out["reconstruction_loss"]),
               "vq_loss": jnp.mean(out["vq_output"]["loss"])}
        return out["loss"], aux, new_state

    def init_fn(key, batch):
        variables = model.init(key, batch["image"], is_training=True)
        return variables.pop("params"), dict(variables)

    trainer = JaxTrainer(loss_fn, init_fn, optax.adam(VQ_LR), num_devices=2, seed=0)
    ts = trainer.init({"image": jnp.asarray(batches[0]["image"])}, initial_params=params,
                      initial_state=state)
    assert len(trainer.mesh.devices.ravel()) == 2
    ts, metrics = _jax_steps(trainer, ts, batches)
    return metrics, jax.device_get(ts.params), jax.device_get(ts.state)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.RandomState(11)
    inputs = {
        "batches": [{"image": rng.rand(4, 16, 16, 3).astype(np.float32),
                     "mask": (rng.rand(4, 16, 16, 1) > 0.5).astype(np.float32)}
                    for _ in range(3)],
        "pm_vqvae": (COND, VQ, PC),
        "pm_vqvae_tree": convert.random_pm_vqvae_tree(COND, VQ, PC, seed=3),
        "vqvae": (*convert.init_vqvae_tree(VQ_CFG, seed=5), VQ_CFG),
        "vq_batches": [{"image": rng.rand(4, 8, 8, 1).astype(np.float32)} for _ in range(2)],
        "vqvae_lr": VQ_LR,
    }
    workdir = tmp_path_factory.mktemp("parallel_jax")
    with open(workdir / "inputs.pkl", "wb") as fp:
        pickle.dump(inputs, fp)
    ranks = worker.spawn(workdir, "pm_vqvae", "vq_ema")
    return inputs, ranks


def test_pm_vqvae_two_ranks_match_the_jax_mesh(runs):
    inputs, ranks = runs
    losses, params, state = jax_pm_vqvae(inputs["pm_vqvae_tree"], inputs["batches"])
    want = convert.pm_vqvae_state_dict(params, state)
    sd0 = convert.pm_vqvae_state_dict(*inputs["pm_vqvae_tree"])
    for out in ranks["pm_vqvae"]:
        np.testing.assert_allclose(out["losses"], losses, rtol=1e-5)
        for name, w in want.items():
            got = out["state"][name]
            if name.startswith("vqvae."):
                np.testing.assert_array_equal(got, sd0[name], err_msg=name)
            else:
                np.testing.assert_allclose(got, w, rtol=0, atol=2e-6, err_msg=name)


def test_vq_ema_two_ranks_follow_the_global_batch_as_the_jax_mesh(runs):
    inputs, ranks = runs
    params, state, _ = inputs["vqvae"]
    metrics, _, new_state = jax_vqvae(params, state, inputs["vq_batches"])
    for out in ranks["vq_ema"]:
        for got, want in zip(out["metrics"], metrics):
            for k in ("loss", "perplexity", "reconstruction_loss", "vq_loss"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
        for name in EMA:
            want = np.asarray(new_state["vq_ema"]["vq"][name])
            np.testing.assert_allclose(out["state"][f"vq.{name}"], want, rtol=0,
                                       atol=EMA_TOL * np.abs(want).max(), err_msg=name)

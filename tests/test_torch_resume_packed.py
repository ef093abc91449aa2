"""A ``packed_chain`` checkpoint of the JAX package resumes in the port
(split from ``tests/test_torch_resume.py``, whose helpers it uses, so that the suite's
workers run its interpret-mode JAX training beside the rest).

A tiny PM-VQVAE trained 3 steps by the JAX trainer with and without
``PackedChainCodec`` (the fused chain in interpret mode, no dropout, masks
in the batch), each checkpoint continued by the port to step 5: the same
state within 1e-5 of scale.
"""
import jax.numpy as jnp
import numpy as np
import optax

from posterior_matching_torch import convert
from posterior_matching_torch.data.datasets import ArrayDataset
from posterior_matching_torch.train import trainer as tr
from posterior_matching_torch.train.state import load_train_state
from posterior_matching_tpu.data.datasets import ArrayDataset as JaxArrayDataset
from posterior_matching_tpu.models.pixelcnn import PackedChainCodec
from posterior_matching_tpu.train import Trainer as JaxTrainer
from posterior_matching_tpu.train.state import save_train_state as jax_save
from test_torch_resume import PC, SCHEDULE, VQ, _assert_close
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_packed_chain_checkpoint_resumes_in_the_port(tmp_path):
    """A tiny PM-VQVAE trained 3 steps by the JAX trainer with and without
    ``PackedChainCodec`` (fused chain in interpret mode, no dropout, masks
    in the batch); the port continues each to step 5: the same state within
    1e-5 of scale."""
    from posterior_matching_tpu.models.pm_vqvae import PMVQVAE as JaxPMVQVAE

    pc = dict(PC, fused_chain="interpret")
    jm = JaxPMVQVAE.from_config(16, VQ, pc)
    rng = np.random.RandomState(0)
    data = {"image": (rng.rand(16, 16, 16, 1) > 0.5).astype(np.float32),
            "mask": (rng.rand(16, 16, 16, 1) > 0.5).astype(np.float32)}
    params, state = convert.random_pm_vqvae_tree(16, VQ, PC, seed=2)

    def init_fn(key, batch):
        # the seeded tree is the whole model (the trainer merges it over
        # this): the same structure as JAX's eager init, without its ~30 s
        return params, state

    def jax_fit(packed):
        cell = []

        def codec(init_params):
            cell.append(PackedChainCodec(init_params, num_resnet=2, num_filters=8))
            return cell[0]

        def loss_fn(p, s, key, step, batch, is_training):
            chain = None
            if cell and cell[0].is_encoded(p):
                p, chain = cell[0].split_encoded(p)
            ll, _ = jm.apply({"params": p, **s}, batch["image"], batch["mask"],
                             training=is_training, rngs={"dropout": key}, mutable=["vq_ema"],
                             packed_chain=chain)
            return -jnp.mean(ll), {}, s

        jt = JaxTrainer(loss_fn, init_fn, optax.chain(
            optax.scale_by_adam(), optax.scale_by_schedule(optax.exponential_decay(**SCHEDULE)),
            optax.scale(-1.0)), trainable_predicate=lambda m, n, v: not m.startswith("vqvae"),
            seed=3, rng_impl=None, param_codec=codec if packed else None)
        return jt.fit(JaxArrayDataset(data, 8), 3, validation_freq=100,
                      initial_params=params, initial_state=state)

    out = []
    for packed in (False, True):
        path = str(tmp_path / f"packed{packed}.pkl")
        jax_save(path, jax_fit(packed))
        ts = load_train_state(path)
        assert ("packed" in str(ts.opt_state)) == packed
        model = convert.pm_vqvae_from_jax(params, state, 16, VQ, PC, device="cpu")
        pt = tr.pm_vqvae_trainer(model, {"lr_schedule": SCHEDULE}, device="cpu")
        pt.fit(ArrayDataset(data, 8), 5, validation_freq=100, resume_from=ts)
        out.append(_flat_pm_vqvae(pt.train_state(), pt.trainable))
    _assert_close(out[1], out[0])


def _flat_pm_vqvae(ts, trainable):
    count, mu, nu = convert.optax_moments(ts.opt_state, ts.params, trainable)
    flat = lambda t: convert.pm_vqvae_state_dict(t, ts.state)
    return count, {k: flat(t) for k, t in (("params", ts.params), ("mu", mu), ("nu", nu))}

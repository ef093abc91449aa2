"""Three steps of the port's stage-2 ``Trainer`` against three steps of the
JAX ``Trainer`` built as ``train_pm_vqvae.py:144-193`` builds it (optax
Adam under the exponential decay, the ``vqvae`` subtree frozen), from the
same tree and batches, at dropout 0 with the masks passed in.

Tolerances: the loss per step within 1e-5 relative; first-step gradients
within 1e-4 x each gradient's scale (float32 sums in another order through
both passes of the chain); parameters after 3 steps within 2e-6 absolute.
An Adam step moves a parameter by at most about the learning rate (3e-4),
whatever its gradient's size, so 2e-6 is under 1% of 3 steps' movement;
a gradient that is 0 in one framework and rounding-small in the other is
still divided by its own tiny second moment, and that is what the budget
allows for. The ``vqvae`` subtree must come out bit for bit unchanged in
both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from posterior_matching_tpu.models.pm_vqvae import PMVQVAE as JaxPMVQVAE
from posterior_matching_tpu.train import Trainer as JaxTrainer
from posterior_matching_torch import convert
from posterior_matching_torch.config import PM_VQVAE_CELEB_A_TRAIN
from posterior_matching_torch.train.trainer import pm_vqvae_loss, pm_vqvae_trainer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

VQ = {"output_channels": 3, "embedding_dim": 8, "num_embeddings": 16,
      "hidden_units": 8, "residual_blocks": 1, "residual_hidden_units": 4,
      "decay": 0.99, "use_ema": True, "commitment_cost": 0.25}
PC = {"image_shape": [4, 4], "num_resnet": 2, "num_hierarchies": 1,
      "num_filters": 8, "dropout": 0.0, "num_indices": 16}
COND, STEPS = 16, 3
LR = PM_VQVAE_CELEB_A_TRAIN["lr_schedule"]


def _batches():
    rng = np.random.RandomState(4)
    return [{"image": rng.rand(2, 16, 16, 3).astype(np.float32),
             "mask": (rng.rand(2, 16, 16, 1) > 0.5).astype(np.float32)}
            for _ in range(STEPS)]


@pytest.fixture(scope="module")
def jax_run():
    model = JaxPMVQVAE.from_config(COND, VQ, PC)
    batches = _batches()
    b0 = {k: jnp.asarray(v) for k, v in batches[0].items()}

    def loss_fn(params, state, key, step, batch, is_training):
        ll, _ = model.apply({"params": params, **state}, batch["image"],
                            batch["mask"], training=is_training,
                            rngs={"dropout": key}, mutable=["vq_ema"])
        return -jnp.mean(ll), {}, state

    def init_fn(key, batch):
        k1, k2 = jax.random.split(key)
        variables = model.init({"params": k1, "dropout": k2}, batch["image"],
                               batch["mask"], training=True)
        params = variables.pop("params")
        return params, dict(variables)

    optimizer = optax.chain(
        optax.scale_by_adam(),
        optax.scale_by_schedule(optax.exponential_decay(**LR)),
        optax.scale(-1.0),
    )
    trainer = JaxTrainer(
        loss_fn, init_fn, optimizer, num_devices=1, seed=0,
        trainable_predicate=lambda module, name, value: not module.startswith("vqvae"),
    )
    # the warm start of train_pm_vqvae.py:186-192, here with a whole seeded
    # tree (init alone creates no decoder parameters)
    params, state = convert.random_pm_vqvae_tree(COND, VQ, PC, seed=3)
    ts = trainer.init(b0, initial_params=params, initial_state=state)
    params0 = jax.device_get(ts.params)
    state0 = jax.device_get(ts.state)
    grads0 = jax.device_get(jax.jit(jax.grad(
        lambda p: loss_fn(p, ts.state, jax.random.PRNGKey(0), 0, b0, True)[0]))(ts.params))
    step = trainer._make_train_step()
    key = jax.random.PRNGKey(1)
    losses = []
    for batch in batches:
        ts, metrics = step(ts, trainer._shard({k: jnp.asarray(v) for k, v in batch.items()}), key)
        losses.append(float(metrics["loss"]))
    return params0, state0, grads0, losses, jax.device_get(ts.params), batches


def test_three_steps_match_jax(jax_run):
    params0, state0, grads0, losses, params3, batches = jax_run
    sd0 = convert.pm_vqvae_state_dict(params0, state0)
    model = convert.pm_vqvae_from_jax(params0, state0, COND, VQ, PC, device="cpu")
    trainer = pm_vqvae_trainer(model, PM_VQVAE_CELEB_A_TRAIN, seed=0, device="cpu")
    trainer.init()
    torch_batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]

    # first-step gradients
    names = list(trainer.optimizer.params)
    loss = pm_vqvae_loss(model, torch_batches[0], 0, True)
    grads = torch.autograd.grad(loss, [trainer.optimizer.params[n] for n in names])
    want_g = convert.pm_vqvae_state_dict(grads0, state0)
    assert set(names) == {n for n in want_g if not n.startswith("vqvae.")}
    for name, g in zip(names, grads):
        w = want_g[name]
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * scale, err_msg=name)

    got_losses = [trainer.train_step(b)["loss"].item() for b in torch_batches]
    np.testing.assert_allclose(got_losses, losses, rtol=1e-5)
    assert trainer.step == STEPS

    want_p = convert.pm_vqvae_state_dict(params3, state0)
    got_p = model.state_dict()
    for name, w in want_p.items():
        got = got_p[name].numpy()
        if name.startswith("vqvae."):
            np.testing.assert_array_equal(got, sd0[name], err_msg=name)
            np.testing.assert_array_equal(w, sd0[name], err_msg=name)
        else:
            np.testing.assert_allclose(got, w, rtol=0, atol=2e-6, err_msg=name)


def test_skip_nonfinite_updates_and_ema():
    """A step whose loss is not finite leaves the parameters and the
    optimizer alone and says so; the EMA of the parameters follows
    ``e = rate e + (1 - rate) p`` over every parameter
    (``train/trainer.py:244-260`` of the JAX package)."""
    from posterior_matching_torch.train.optim import Adam
    from posterior_matching_torch.train.trainer import Trainer

    model = torch.nn.Linear(3, 1)
    loss = lambda m, batch, seed, training: (m(batch["x"]) ** 2).mean() * batch["s"]
    trainer = Trainer(model, loss, optimizer=lambda params: Adam(params, lambda count: 0.1),
                      skip_nonfinite_updates=True, ema_rate=0.5, device="cpu")
    trainer.init()
    w0 = model.weight.detach().clone()
    x = torch.ones(2, 3)
    out = trainer.train_step({"x": x, "s": torch.tensor(float("nan"))})
    assert out["skipped"].item() == 1.0 and trainer.step == 1
    assert torch.equal(model.weight, w0) and trainer.optimizer.count == 0
    out = trainer.train_step({"x": x, "s": torch.tensor(1.0)})
    assert out["skipped"].item() == 0.0 and trainer.optimizer.count == 1
    assert not torch.equal(model.weight, w0)
    # two EMA updates: the first towards the unchanged weights, then 0.5 / 0.5
    torch.testing.assert_close(trainer.ema_params["weight"],
                               0.5 * w0 + 0.5 * model.weight.detach())


def test_pm_vqvae_updates_unchanged_by_the_optimizer_hook():
    """The trainer builds its optimizer through a hook now; the one
    ``pm_vqvae_trainer`` builds must update bit for bit as the Adam written
    out here as it stood before the hook: ``mu``/``nu`` in place,
    ``p -= lr (mu / c1) / (sqrt(nu / c2) + eps)`` with
    ``lr = init * rate ** (count / steps)``."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(5, 4), torch.nn.Linear(4, 1))
    ref = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = pm_vqvae_trainer(model, PM_VQVAE_CELEB_A_TRAIN, device="cpu")
    trainer.init()
    mu = {n: torch.zeros_like(p) for n, p in ref.items()}
    nu = {n: torch.zeros_like(p) for n, p in ref.items()}
    for step in range(4):
        grads = {n: torch.randn_like(p) * 10.0 ** (step - 2) for n, p in ref.items()}
        trainer.optimizer.step(grads)
        rate = LR["init_value"] * LR["decay_rate"] ** (step / LR["transition_steps"])
        c1, c2 = 1.0 - 0.9 ** (step + 1), 1.0 - 0.999 ** (step + 1)
        for n, g in grads.items():
            mu[n].mul_(0.9).add_((1.0 - 0.9) * g)
            nu[n].mul_(0.999).add_((1.0 - 0.999) * (g * g))
            ref[n] = ref[n] - rate * ((mu[n] / c1) / (torch.sqrt(nu[n] / c2) + 1e-8))
        for n, p in model.named_parameters():
            assert torch.equal(p.detach(), ref[n]), (step, n)

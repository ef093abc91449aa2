"""The port's stage-1 VQ-VAE training forward against the JAX package, and
the codebook's freezing.

- Two training forwards in a row (``is_training=True``) of the port's
  ``VQVAE`` and of the JAX ``VQVAE.apply(..., mutable=["vq_ema"])`` from the
  same initial variables and images: the loss, the reconstruction loss, the
  commitment loss and the perplexity within 1e-5 relative, the EMA state
  after each (codebook, cluster sizes, summed latents) within 1e-5 of
  scale, and every parameter's gradient of the loss within 1e-4 of scale
  (float32 convolutions summed in another order); the same codes each
  time.
- The codebook is a buffer, outside every optimizer. It does not move
  under ``is_training=False``, under ``vqvae_trainer``'s validation, or in
  a stage-2 step, though ``Trainer.train_step`` puts the model in
  ``train()`` mode; ``vqvae_trainer``'s step moves it. ``use_ema=False``
  is refused.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posterior_matching_tpu.models.vqvae import VQVAE as JaxVQVAE
from posterior_matching_torch import convert
from posterior_matching_torch.models.vqvae import VQVAE
from posterior_matching_torch.train.trainer import pm_vqvae_trainer, vqvae_trainer

CFG = {"output_channels": 1, "embedding_dim": 8, "num_embeddings": 16, "hidden_units": 8,
       "residual_blocks": 1, "residual_hidden_units": 4, "decay": 0.99, "use_ema": True,
       "commitment_cost": 0.25}
EMA = ("embeddings", "ema_cluster_size", "ema_dw")


def _images(seed, n=4, side=8):
    return np.random.RandomState(seed).rand(n, side, side, 1).astype(np.float32)


def test_training_forward_and_ema_match_jax():
    jm = JaxVQVAE(**CFG)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 1))))
    params, state = variables["params"], {"vq_ema": variables["vq_ema"]}
    port = convert.vqvae_from_jax(params, state, CFG, device="cpu")

    def jax_step(p, st, x):
        out, new = jm.apply({"params": p, **st}, x, is_training=True, mutable=["vq_ema"])
        aux = {"recon": out["reconstruction_loss"], "vq": out["vq_output"]["loss"],
               "perplexity": out["vq_output"]["perplexity"],
               "codes": out["vq_output"]["encoding_indices"]}
        return out["loss"], (aux, new)

    grad_fn = jax.jit(jax.value_and_grad(jax_step, has_aux=True))
    for i in range(2):
        x = _images(i)
        (loss, (aux, state)), jgrads = grad_fn(params, state, x)
        names, ps = zip(*port.named_parameters())
        out = port(torch.from_numpy(x), is_training=True)
        grads = dict(zip(names, torch.autograd.grad(out["loss"], ps)))
        np.testing.assert_array_equal(
            out["vq_output"]["encoding_indices"].numpy(), np.asarray(aux["codes"]))
        for got, want in ((out["loss"], loss), (out["reconstruction_loss"], aux["recon"]),
                          (out["vq_output"]["loss"], aux["vq"]),
                          (out["vq_output"]["perplexity"], aux["perplexity"])):
            np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
        for name in EMA:
            want = np.asarray(state["vq_ema"]["vq"][name])
            got = getattr(port.vq, name).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(),
                                       err_msg=f"step {i} {name}")
        want_sd = convert.vqvae_state_dict(jax.device_get(jgrads), state["vq_ema"])
        for name, g in grads.items():
            want = want_sd[name]
            np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                       atol=1e-4 * max(np.abs(want).max(), 1e-6), err_msg=name)


def test_codebook_is_a_buffer_moved_by_training_forwards_only():
    torch.manual_seed(0)
    model = VQVAE(**CFG)
    assert "vq.embeddings" not in dict(model.named_parameters())
    assert "vq.embeddings" in model.state_dict()
    before = {n: getattr(model.vq, n).clone() for n in EMA}
    x = torch.from_numpy(_images(3))
    model.train()
    model(x)
    model.encoding_indices(x)
    for n in EMA:
        assert torch.equal(getattr(model.vq, n), before[n]), n

    trainer = vqvae_trainer(model, {"learning_rate": 1e-3}, device="cpu")
    trainer.init()
    assert all(not n.startswith("vq.") for n in trainer.optimizer.params)
    metrics = trainer.validate([{"image": x}])
    assert set(metrics) == {"loss", "perplexity", "reconstruction_loss", "vq_loss"}
    for n in EMA:
        assert torch.equal(getattr(model.vq, n), before[n]), n
    trainer.train_step({"image": x})
    for n in EMA:
        assert not torch.equal(getattr(model.vq, n), before[n]), n
    with pytest.raises(NotImplementedError, match="use_ema"):
        VQVAE(**dict(CFG, use_ema=False))


def test_stage2_step_leaves_the_codebook():
    pc = {"image_shape": (2, 2), "num_resnet": 1, "num_hierarchies": 1, "num_filters": 8,
          "dropout": 0.5, "num_indices": 16}
    params, state = convert.random_pm_vqvae_tree(6, CFG, pc, seed=1)
    model = convert.pm_vqvae_from_jax(params, state, 6, CFG, pc, device="cpu")
    train = {"lr_schedule": {"init_value": 1e-3, "decay_rate": 0.9, "transition_steps": 1}}
    trainer = pm_vqvae_trainer(model, train, device="cpu")
    trainer.init()
    before = {k: v.clone() for k, v in model.vqvae.state_dict().items()}
    x = torch.from_numpy(_images(4))
    trainer.train_step({"image": x, "mask": (x > 0.5).float()})
    assert model.training
    for k, v in model.vqvae.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_skipped_nonfinite_step_keeps_the_codebook():
    """A stage-1 step on a NaN batch under ``skip_nonfinite_updates``: the
    forward moves the EMA codebook (to NaN) and the step is skipped, so the
    parameters, the Adam state and the codebook buffers are all restored,
    as the JAX trainer keeps its model state on a skipped step
    (``trainer.py:244-251``); the next finite step moves them again."""
    torch.manual_seed(1)
    model = VQVAE(**CFG)
    trainer = vqvae_trainer(model, {"learning_rate": 1e-3}, device="cpu",
                            skip_nonfinite_updates=True)
    x = torch.from_numpy(_images(5))
    trainer.train_step({"image": x})
    sd = lambda: {k: v.clone() for k, v in model.state_dict().items()}
    opt = lambda: (trainer.optimizer.count,
                   {k: v.clone() for k, v in trainer.optimizer.mu.items()},
                   {k: v.clone() for k, v in trainer.optimizer.nu.items()})
    before, opt_before = sd(), opt()
    forward = model.vq.forward
    moved = []

    def seen(*args, **kwargs):
        out = forward(*args, **kwargs)
        moved.append(bool(torch.isnan(model.vq.embeddings).any()))
        return out

    model.vq.forward = seen
    metrics = trainer.train_step({"image": torch.full_like(x, float("nan"))})
    del model.vq.forward
    assert moved == [True] and metrics["skipped"].item() == 1.0 and trainer.step == 2
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    count, mu, nu = opt()
    assert count == opt_before[0] == 1
    for k in mu:
        assert torch.equal(mu[k], opt_before[1][k]) and torch.equal(nu[k], opt_before[2][k]), k
    metrics = trainer.train_step({"image": x})
    assert metrics["skipped"].item() == 0.0 and trainer.optimizer.count == 2
    assert not torch.equal(model.vq.embeddings, before["vq.embeddings"])

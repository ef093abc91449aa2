"""Small VaDE, PM-VaDE and lookahead training steps and the mixture fit on
the GPU against the same on the CPU.

These paths have no hand-written kernel: their networks, heads and
distributions are plain PyTorch (convs as im2col GEMMs, TF32 off). So this
holds the GPU's libraries against the CPU, with the same weights (the JAX
initialisation drawn from a seed) and the same injected draws:

- ``-mean(elbo)`` of a narrow conv VaDE, the matching loss of a PM-VaDE
  with the autoregressive GMM partial posterior, and the lookahead loss on
  a narrow 16x16 PM-VAE (its three draws injected): the loss within 1e-5
  relative, every gradient within 1e-4 of its scale;
- ``GaussianMixture`` on well-separated blobs fitted on the GPU and on the
  CPU (each seeding its k-means from its own generator): the same mixture
  up to a permutation of the components, within 1e-6 relative, the same
  predictions.

These need an NVIDIA GPU; elsewhere they skip. On the card:
``python -m pytest --noconftest tests/test_torch_vade_gpu.py -q -m cuda``.
"""
import numpy as np
import pytest
import torch

from posterior_matching_torch import convert
from posterior_matching_torch.eval.gmm import GaussianMixture
from posterior_matching_torch.train.trainer import (
    lookahead_loss_fn,
    pm_vade_loss_fn,
    vade_loss_fn,
)

pytestmark = pytest.mark.cuda

VADE = {"num_components": 5, "latent_dim": 4, "encoder_net": "ConvEncoder",
        "decoder_net": "ConvDecoder", "decoder_dist": "Bernoulli",
        "encoder_net_config": {"conv_layers": [(8, 5, 1), (8, 5, 2), (16, 5, 1), (16, 5, 2),
                                               (16, 7, 1)]},
        "decoder_net_config": {"conv_layers": [(16, 7, 1), (16, 5, 2), (8, 5, 1), (8, 5, 2),
                                               (1, 5, 1)]},
        "partial_posterior_dist": "AutoregressiveGMM",
        "partial_posterior_dist_config": {"num_components": 3, "residual_blocks": 1,
                                          "hidden_units": 32}}
PM_VAE16 = {"latent_dim": 4, "encoder_net": "ConvEncoder", "decoder_net": "ConvDecoder",
            "posterior_dist": "TriLGaussian", "decoder_dist": "Bernoulli",
            "encoder_net_config": {"conv_layers": [(8, 3, 1), (8, 3, 2), (16, 3, 2),
                                                   (16, 1, 1)]},
            "decoder_net_config": {"conv_layers": [(16, 8, 1), (16, 5, 2), (8, 5, 1),
                                                   (1, 3, 1)]}}
LOOKAHEAD = {"num_features": 256, "lookahead_subsample": 16, "model_samples": 8}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def grads_on(build, loss_of, device):
    model = build(device)
    names, params = zip(*model.named_parameters())
    loss = loss_of(model, device)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.item(), {n: g.cpu() for n, g in zip(names, grads) if g is not None}


def assert_step_matches(build, loss_of, dev):
    lg, gg = grads_on(build, loss_of, dev)
    lc, gc = grads_on(build, loss_of, "cpu")
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    assert set(gg) == set(gc) and gc
    for name, want in gc.items():
        scale = max(want.abs().max().item(), 1e-12)
        err = (gg[name] - want).abs().max().item()
        assert err <= 1e-4 * scale, (name, err, scale)


@pytest.mark.parametrize("kind", ["vade", "pm_vade"])
def test_vade_step_matches_cpu(dev, kind):
    g = torch.Generator().manual_seed(0)
    x = (torch.rand(16, 28, 28, 1, generator=g) > 0.5).float()
    b = (torch.rand(16, 28, 28, 1, generator=g) > 0.5).float()
    eps = torch.randn(16, VADE["latent_dim"], generator=g)
    tree = convert.init_vade_tree(VADE, seed=3, partial=kind == "pm_vade")
    loss_fn = (vade_loss_fn if kind == "vade" else pm_vade_loss_fn)("image")
    assert_step_matches(
        lambda d: convert.vade_from_jax(tree, VADE, device=d),
        lambda m, d: loss_fn(m, {"image": x.to(d), "mask": b.to(d)}, iter([eps]), True), dev)


def test_lookahead_step_matches_cpu(dev):
    g = torch.Generator().manual_seed(1)
    x = (torch.rand(4, 16, 16, 1, generator=g) > 0.5).float()
    b = (torch.rand(4, 16, 16, 1, generator=g) > 0.8).float()
    lat = PM_VAE16["latent_dim"]
    draws = [torch.randn(8, 4, lat, generator=g), torch.randperm(256, generator=g)[:16],
             torch.randn(8 * 4 * 16, lat, generator=g)]
    tree = convert.init_lookahead_tree(LOOKAHEAD, PM_VAE16, seed=4)
    assert_step_matches(
        lambda d: convert.lookahead_from_jax(tree, LOOKAHEAD, PM_VAE16, device=d),
        lambda m, d: lookahead_loss_fn("image")(m, {"image": x.to(d), "mask": b.to(d)},
                                                iter(draws), True), dev)


def test_gmm_fit_on_the_device_matches_the_cpu(dev):
    rng = np.random.RandomState(0)
    centers = rng.randn(6, 10) * 15
    x = np.concatenate([c + rng.randn(500, 10) * (0.5 + rng.rand(10)) for c in centers])
    fits = [GaussianMixture(6, generator=torch.Generator(device=d).manual_seed(0)).fit(x)
            for d in (dev, "cpu")]
    gpu, cpu = fits
    perm = np.array([np.argmin(((cpu.means_ - m) ** 2).sum(-1)) for m in gpu.means_])
    assert sorted(perm) == list(range(6))
    np.testing.assert_allclose(gpu.weights_, cpu.weights_[perm], rtol=1e-6)
    np.testing.assert_allclose(gpu.means_, cpu.means_[perm], rtol=1e-6,
                               atol=1e-6 * np.abs(cpu.means_).max())
    np.testing.assert_allclose(gpu.covariances_, cpu.covariances_[perm], rtol=1e-6)
    np.testing.assert_allclose(gpu.lower_bound_, cpu.lower_bound_, rtol=1e-9)
    np.testing.assert_array_equal(perm[gpu.predict(x)], cpu.predict(x))

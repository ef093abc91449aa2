"""A small PM-VAE training step on the GPU against the same step on the CPU.

PM-VAE's path has no hand-written kernel: its networks, heads and
distributions are plain PyTorch, so this holds the GPU's libraries
(cuBLAS, cuDNN's convolutions and transposed convolutions, the batched
triangular solves), with TF32 off, against the CPU. Both families, at
narrow widths: the UCI residual MLPs with LayerNorm and a TriL partial
posterior, and the conv encoder and decoder (k = 5, s = 2 transposed
convs) with the autoregressive GMM partial posterior. The same weights
(the JAX initialisation drawn from a seed) and the same injected normals;
the loss within 1e-5 relative and every gradient within 1e-4 of its
scale. These need an NVIDIA GPU; elsewhere they skip. On the card:
``python -m pytest --noconftest tests/test_torch_pm_vae_gpu.py -q -m cuda``.
"""
import pytest
import torch

from posterior_matching_torch import convert
from posterior_matching_torch.train.trainer import pm_vae_loss_fn

pytestmark = pytest.mark.cuda

UCI = {
    "latent_dim": 8, "encoder_net": "ResidualMLP", "decoder_net": "ResidualMLP",
    "decoder_dist": "IdentityGaussian", "posterior_dist": "TriLGaussian",
    "decoder_dist_config": {"event_size": 10},
    "encoder_net_config": {"residual_blocks": 2, "hidden_units": 32, "layer_norm": True},
    "decoder_net_config": {"residual_blocks": 2, "hidden_units": 32, "layer_norm": True},
    "matching_ll_stop_gradients": True,
}
CONV = {
    "latent_dim": 6, "encoder_net": "ConvEncoder", "decoder_net": "ConvDecoder",
    "posterior_dist": "TriLGaussian", "partial_posterior_dist": "AutoregressiveGMM",
    "decoder_dist": "Bernoulli",
    "encoder_net_config": {"conv_layers": [(8, 5, 1), (8, 5, 2), (16, 5, 1), (16, 5, 2),
                                           (16, 7, 1)]},
    "decoder_net_config": {"conv_layers": [(16, 7, 1), (16, 5, 2), (8, 5, 1), (8, 5, 2),
                                           (1, 5, 1)]},
}
TRAIN = {"beta": {"schedule": "cyclic", "low_value": 0.0, "high_value": 1.0, "period": 10,
                  "delay": 2}}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def step_on(model_cfg, device, x, b, eps, data_key):
    model = convert.pm_vae_from_jax(convert.init_pm_vae_tree(model_cfg, seed=3), model_cfg,
                                    device=device)
    names, params = zip(*model.named_parameters())
    loss, _ = pm_vae_loss_fn(dict(TRAIN, model=model_cfg), data_key)(
        model, {data_key: x.to(device), "mask": b.to(device)}, iter([eps]), True, 6)
    grads = torch.autograd.grad(loss, params)
    return loss.item(), {n: g.cpu() for n, g in zip(names, grads)}


@pytest.mark.parametrize("family", ["uci", "conv"])
def test_pm_vae_step_matches_cpu(dev, family):
    g = torch.Generator().manual_seed(0)
    if family == "uci":
        cfg, key = UCI, "features"
        x = torch.randn(64, 10, generator=g)
        b = (torch.rand(64, 10, generator=g) > 0.5).float()
    else:
        cfg, key = CONV, "image"
        x = (torch.rand(16, 28, 28, 1, generator=g) > 0.5).float()
        b = (torch.rand(16, 28, 28, 1, generator=g) > 0.5).float()
    eps = torch.randn(len(x), cfg["latent_dim"], generator=g)
    lg, gg = step_on(cfg, dev, x, b, eps, key)
    lc, gc = step_on(cfg, "cpu", x, b, eps, key)
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    assert set(gg) == set(gc)
    for name, want in gc.items():
        scale = max(want.abs().max().item(), 1e-12)
        err = (gg[name] - want).abs().max().item()
        assert err <= 1e-4 * scale, (name, err, scale)

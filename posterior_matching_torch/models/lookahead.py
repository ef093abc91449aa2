"""Lookahead posteriors for active feature acquisition.

Counterpart of ``posterior_matching_tpu/models/lookahead.py:36-205``: a
linear head (:class:`LookaheadBlock`) gives one diagonal Gaussian per
candidate feature, the posterior after observing it; training fits them to
one-step-ahead partial-posterior samples of a frozen PM-VAE for a random
subsample of the features, and :meth:`LookaheadPosterior.
expected_info_gains` then estimates every feature's information gain in one
forward, where the PM-VAE's sampling estimator runs ``S (F + 1)`` of them.

The PM-VAE lives under ``pm_vae`` (its names as in
:class:`~posterior_matching_torch.models.vae.PosteriorMatchingVAE`); the
new modules are ``lookahead_encoder_net`` and ``lookahead_block``, whose
paths hold ``lookahead`` for the trainer's freezing predicate. Sampling
takes ``noise``: a ``torch.Generator``, or an iterator of draws in the
JAX package's order (below).
"""
from __future__ import annotations

import math
from typing import Any, Mapping, Optional, Sequence

import torch
from torch import nn

from posterior_matching_torch.distributions import MultivariateNormalDiag, Noise, softplus_scale
from posterior_matching_torch.models.networks import Dense, get_network
from posterior_matching_torch.models.vae import PosteriorMatchingVAE, _joined
from posterior_matching_torch.runtime import resolve_device


class LookaheadBlock(nn.Module):
    """``Dense(2 L F)`` on the flattened features: for each of the ``F``
    features a diagonal Gaussian's loc and softplus scale
    (``lookahead.py:36-53``)."""

    def __init__(self, in_shape: Sequence[int], event_size: int, num_features: int):
        super().__init__()
        self.event_size, self.num_features = event_size, num_features
        self.Dense_0 = Dense(math.prod(in_shape), 2 * event_size * num_features)

    def forward(self, x: torch.Tensor) -> MultivariateNormalDiag:
        params = self.Dense_0(x.reshape(x.shape[0], -1))
        params = params.reshape(x.shape[0], self.num_features, 2 * self.event_size)
        k = self.event_size
        return MultivariateNormalDiag(loc=params[..., :k], scale_diag=softplus_scale(params[..., k:]))


def draw_indices(noise: Noise, n: int, s: int, device) -> torch.Tensor:
    """``s`` of ``range(n)`` drawn without replacement (``jax.random.
    choice(..., replace=False)``, equal in distribution): the head of a
    random permutation from a generator, or the next injected tensor."""
    if isinstance(noise, torch.Generator):
        return torch.randperm(n, generator=noise, device=noise.device)[:s].to(device)
    inds = next(noise)
    if tuple(inds.shape) != (s,):
        raise ValueError(f"injected indices have shape {tuple(inds.shape)}, not ({s},)")
    return inds.to(device=device, dtype=torch.long)


class LookaheadPosterior(nn.Module):
    """A PM-VAE and its lookahead encoder (``lookahead.py:55-205``). Build
    it with :meth:`from_config`."""

    def __init__(self, pm_vae_config: Mapping[str, Any], lookahead_encoder_net: str,
                 lookahead_encoder_net_config, num_features: int,
                 lookahead_subsample: int = 16, model_samples: int = 64):
        super().__init__()
        self.num_features = num_features
        self.lookahead_subsample, self.model_samples = lookahead_subsample, model_samples
        self.pm_vae = PosteriorMatchingVAE.from_config(pm_vae_config, device="cpu")
        self.lookahead_encoder_net = get_network(lookahead_encoder_net,
                                                 lookahead_encoder_net_config,
                                                 _joined(self.pm_vae.data_shape))
        self.lookahead_block = LookaheadBlock(self.lookahead_encoder_net.out_shape,
                                              self.pm_vae.latent_dim, num_features)

    @classmethod
    def from_config(cls, config: Mapping[str, Any], pm_vae_config: Mapping[str, Any],
                    device: Optional[str] = None) -> "LookaheadPosterior":
        """From the ``lookahead_config.json`` and ``pm_vae_config.json``
        dicts (``lookahead.py:70-90``): the lookahead encoder defaults to
        the PM-VAE's encoder network; on ``device`` (the GPU unless
        ``"cpu"``)."""
        dev = resolve_device(device)
        return cls(
            pm_vae_config=pm_vae_config,
            lookahead_encoder_net=config.get("lookahead_encoder_net",
                                             pm_vae_config["encoder_net"]),
            lookahead_encoder_net_config=config.get("lookahead_encoder_net_config",
                                                    pm_vae_config.get("encoder_net_config")),
            num_features=config["num_features"],
            lookahead_subsample=config.get("lookahead_subsample", 16),
            model_samples=config.get("model_samples", 64),
        ).to(dev)

    @property
    def device(self) -> torch.device:
        return self.pm_vae.device

    def lookahead_posteriors(self, x_o_b: torch.Tensor) -> MultivariateNormalDiag:
        """The ``[B, F]`` batch of lookahead posteriors of ``x_o`` joined to
        ``b``."""
        return self.lookahead_block(self.lookahead_encoder_net(x_o_b))

    def forward(self, x: torch.Tensor, b: torch.Tensor, noise: Noise) -> torch.Tensor:
        """The training log-likelihood of each instance ``[B]``
        (``lookahead.py:113-182``). Three draws, in this order, from
        ``noise``: the partial posterior's ``S = model_samples`` samples,
        ``s = lookahead_subsample`` feature indices without replacement,
        and one sample of each of the ``S B s`` one-step partial
        posteriors. The frozen PM-VAE's part, whose outputs the reference
        stops the gradient of, runs outside autograd. A subsampled feature
        that ``b`` already observes is left out of an instance's mean,
        which is 0 where none is left (the divisor is clamped to 1 there,
        so the gradient stays finite)."""
        s_sub, s_mod, batch, f = (self.lookahead_subsample, self.model_samples, x.shape[0],
                                  self.num_features)
        x_o = x * b
        x_o_b = torch.cat([x_o, b], -1)
        with torch.no_grad():
            z = self.pm_vae.encode_partial(x_o_b).sample(noise, (s_mod,))   # [S, B, L]
            x_u = self.pm_vae._decode_flat(z).mean()                       # [S, B, D...]
            x_look = torch.where(b[None] == 1, x_o[None], x_u)
            one_hots = torch.eye(f, device=x.device, dtype=x.dtype).reshape(f, *b.shape[1:])
            inds = draw_indices(noise, f, s_sub, x.device)
            sub_one_hots = one_hots[inds]                                  # [s, D...]
            b_look = torch.maximum(b[:, None], sub_one_hots[None])        # [B, s, D...]
            x_o_look = x_look[:, :, None] * b_look[None]                  # [S, B, s, D...]
            valid = ((b[:, None] + sub_one_hots[None]).reshape(batch, s_sub, -1)
                     .amax(-1) < 2)                                        # [B, s]
            inp = torch.cat([x_o_look, b_look[None].expand(x_o_look.shape)], -1)
            flat = inp.reshape(s_mod * batch * s_sub, *inp.shape[3:])
            one_step_z = self.pm_vae.encode_partial(flat).sample(noise)
            one_step_z = one_step_z.reshape(s_mod, batch, s_sub, -1)
        lookahead = self.lookahead_posteriors(x_o_b)
        sub = MultivariateNormalDiag(loc=lookahead.loc[:, inds],
                                     scale_diag=lookahead.scale_diag[:, inds])
        lls = sub.log_prob(one_step_z).mean(0) * valid                    # [B, s]
        denom = valid.sum(-1)
        out = lls.sum(-1) / denom.clamp_min(1)
        return torch.where(denom == 0, torch.zeros_like(out), out)

    def batch_lookahead_gains(self, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """:meth:`expected_info_gains` of each of ``N`` instances: ``[N,
        F]``."""
        x_o_b = torch.cat([x * b, b], -1)
        current = self.pm_vae.encode(x).entropy()                          # [N]
        gains = (current[:, None] - self.lookahead_posteriors(x_o_b).entropy()).reshape(b.shape)
        return torch.where(b == 0, gains, torch.full_like(gains, -math.inf)).reshape(
            b.shape[0], -1)

    def expected_info_gains(self, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Every feature's information gain for one instance (no batch
        axis) in one forward, flattened, ``-inf`` where ``b`` observes it
        (``lookahead.py:184-199``): the PM-VAE posterior's entropy at the
        whole ``x`` minus each lookahead posterior's."""
        return self.batch_lookahead_gains(x[None], b[None])[0]

    # -- passthroughs for the acquisition engine -----------------------------

    def sampling_info_gains(self, x_o, b, noise: Noise, num_samples: int = 100):
        return self.pm_vae.expected_info_gains(x_o, b, noise, num_samples)

    def impute(self, x_o, b, noise: Noise, num_samples: int = 100):
        return self.pm_vae.impute(x_o, b, noise, num_samples)

"""Variational Deep Embedding (VaDE) and its posterior-matching variant.

Counterpart of ``posterior_matching_tpu/models/vade.py:31-237``: a VAE whose
prior over the latent space is a learned Gaussian mixture, its parameters
``logits`` (zeros), ``mu`` and ``log_scale`` (normal, std 1) at the top of
the tree beside the submodules ``encoder_net``, ``posterior_dist``,
``decoder_net`` and ``decoder_dist``; :class:`PosteriorMatchingVADE` adds
``partial_encoder_net`` and ``partial_posterior_dist``, a partial encoder of
``x b`` joined to ``b`` on the last axis, trained to match the posterior
for partially observed clustering. Parameters keep the flax names, so a
state-dict name is the JAX tree path joined by dots
(``convert.vade_state_dict``).

Sampling takes ``noise`` (:data:`~posterior_matching_torch.distributions.
Noise`): a ``torch.Generator``, or an iterator of the caller's draws in the
order of the JAX package's ``make_rng("sample")`` calls (one a method). No
method runs its networks in training mode: the JAX model never passes
``is_training`` to them, so there is no dropout.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
from torch import nn

from posterior_matching_torch.distributions import MultivariateNormalDiag, Noise
from posterior_matching_torch.models.heads import DiagonalGaussianHead, get_distribution
from posterior_matching_torch.models.networks import get_network
from posterior_matching_torch.models.vae import _data_shape, _joined, sum_over_event
from posterior_matching_torch.runtime import resolve_device


class VADE(nn.Module):
    """Build it with :meth:`from_config`."""

    def __init__(self, num_components: int, latent_dim: int, encoder_net: str,
                 encoder_net_config, decoder_net: str, decoder_net_config,
                 decoder_dist: str, decoder_dist_config):
        super().__init__()
        self.num_components, self.latent_dim = num_components, latent_dim
        self.logits = nn.Parameter(torch.zeros(num_components))
        self.mu = nn.Parameter(torch.randn(num_components, latent_dim))
        self.log_scale = nn.Parameter(torch.randn(num_components, latent_dim))
        self.decoder_net = get_network(decoder_net, decoder_net_config, (latent_dim,))
        self.decoder_dist = get_distribution(decoder_dist, decoder_dist_config,
                                             self.decoder_net.out_shape)
        self.data_shape = _data_shape(decoder_dist, decoder_dist_config or {},
                                      self.decoder_net.out_shape)
        self.encoder_net = get_network(encoder_net, encoder_net_config, self.data_shape)
        self.posterior_dist = DiagonalGaussianHead(self.encoder_net.out_shape, latent_dim)

    @staticmethod
    def _kwargs(config: Mapping[str, Any]) -> dict:
        return dict(num_components=config["num_components"], latent_dim=config["latent_dim"],
                    encoder_net=config["encoder_net"],
                    encoder_net_config=config.get("encoder_net_config"),
                    decoder_net=config["decoder_net"],
                    decoder_net_config=config.get("decoder_net_config"),
                    decoder_dist=config["decoder_dist"],
                    decoder_dist_config=config.get("decoder_dist_config"))

    @classmethod
    def from_config(cls, config: Mapping[str, Any], device: Optional[str] = None):
        """From a ``model_config.json`` dict (``vade.py:44-57``), on
        ``device`` (the GPU unless ``"cpu"``)."""
        dev = resolve_device(device)
        return cls(**cls._kwargs(config)).to(dev)

    @property
    def device(self) -> torch.device:
        return self.logits.device

    # -- pieces --------------------------------------------------------------

    def encode(self, x: torch.Tensor) -> MultivariateNormalDiag:
        return self.posterior_dist(self.encoder_net(x))

    def decode(self, z: torch.Tensor):
        return self.decoder_dist(self.decoder_net(z))

    def decode_log_prob(self, z: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """log p(x | z), summed over the event."""
        return sum_over_event(self.decode(z).log_prob(x))

    def log_p_z_given_c(self, z: torch.Tensor) -> torch.Tensor:
        """``[..., L]`` latents -> ``[..., K]`` log densities of the mixture's
        components, one broadcast log-prob."""
        comp = MultivariateNormalDiag(loc=self.mu, scale_diag=torch.exp(self.log_scale))
        return comp.log_prob(z[..., None, :])

    def log_pi(self) -> torch.Tensor:
        return torch.log_softmax(self.logits, -1)

    # -- public API ----------------------------------------------------------

    def pretrain_loss(self, x: torch.Tensor) -> torch.Tensor:
        """The deterministic autoencoder's loss: ``-mean log p(x | E[z])``."""
        return -self.decode_log_prob(self.encode(x).mean(), x).mean()

    def encode_mean(self, x: torch.Tensor) -> torch.Tensor:
        return self.encode(x).mean()

    def _responsibilities(self, z: torch.Tensor) -> torch.Tensor:
        """q(c | z) averaged over the leading sample axis of ``z``."""
        return torch.softmax(self.log_p_z_given_c(z) + self.log_pi(), -1).mean(0)

    def predict_cluster(self, x: torch.Tensor, noise: Noise,
                        num_samples: int = 10) -> torch.Tensor:
        """Cluster responsibilities q(c | x) ``[B, K]``, averaged over
        ``num_samples`` posterior samples."""
        return self._responsibilities(self.encode(x).sample(noise, (num_samples,)))

    def elbo(self, x: torch.Tensor, noise: Noise) -> torch.Tensor:
        """The VaDE evidence lower bound ``[B]`` (``vade.py:140-173``). As
        in the reference, the prior term takes the *raw* ``logits``, not
        their log-softmax: that shifts the bound by ``logsumexp(logits)``
        and changes its gradient with respect to them; q(c | x) does not
        depend on the choice."""
        posterior = self.encode(x)
        z = posterior.sample(noise)
        log_p_x_given_z = self.decode_log_prob(z, x)
        log_p_z_given_c = self.log_p_z_given_c(z)                     # [B, K]
        logits = self.logits[None]
        log_q_c_given_x = torch.log_softmax(log_p_z_given_c + logits, -1)
        gamma = torch.exp(log_q_c_given_x)
        e_log_p_z_given_c = (gamma * log_p_z_given_c).sum(-1)
        e_log_p_c = (gamma * logits).sum(-1)
        e_log_q_c_given_x = (gamma * log_q_c_given_x).sum(-1)
        return (log_p_x_given_z + e_log_p_z_given_c + e_log_p_c
                - posterior.log_prob(z) - e_log_q_c_given_x)


class PosteriorMatchingVADE(VADE):
    """VaDE and a partial encoder for partially observed clustering
    (``vade.py:176-237``)."""

    def __init__(self, partial_encoder_net: str, partial_encoder_net_config,
                 partial_posterior_dist: str, partial_posterior_dist_config, **kwargs):
        super().__init__(**kwargs)
        self.partial_encoder_net = get_network(partial_encoder_net, partial_encoder_net_config,
                                               _joined(self.data_shape))
        self.partial_posterior_dist = get_distribution(
            partial_posterior_dist, partial_posterior_dist_config,
            self.partial_encoder_net.out_shape)

    @classmethod
    def from_config(cls, config: Mapping[str, Any], device: Optional[str] = None):
        """The partial encoder defaults to the encoder's network and the
        partial posterior to the TriL Gaussian (``vade.py:184-203``)."""
        dev = resolve_device(device)
        partial_cfg = dict(config.get("partial_posterior_dist_config") or {})
        partial_cfg["event_size"] = config["latent_dim"]
        return cls(
            partial_encoder_net=config.get("partial_encoder_net", config["encoder_net"]),
            partial_encoder_net_config=config.get("partial_encoder_net_config",
                                                  config.get("encoder_net_config")),
            partial_posterior_dist=config.get("partial_posterior_dist", "TriLGaussian"),
            partial_posterior_dist_config=partial_cfg,
            **cls._kwargs(config),
        ).to(dev)

    def encode_partial(self, x_o_b: torch.Tensor):
        return self.partial_posterior_dist(self.partial_encoder_net(x_o_b))

    def partial_predict_cluster(self, x: torch.Tensor, b: torch.Tensor, noise: Noise,
                                num_samples: int = 10) -> torch.Tensor:
        """q(c | x_o) ``[B, K]`` from the partial encoder's samples."""
        partial_posterior = self.encode_partial(torch.cat([x * b, b], -1))
        return self._responsibilities(partial_posterior.sample(noise, (num_samples,)))

    def posterior_matching_ll(self, x: torch.Tensor, b: torch.Tensor,
                              noise: Noise) -> torch.Tensor:
        """log q(z | x_o) ``[B]`` at ``z ~ q(z | x)``, its gradient stopped."""
        posterior = self.encode(x)
        partial_posterior = self.encode_partial(torch.cat([x * b, b], -1))
        return partial_posterior.log_prob(posterior.sample(noise).detach())

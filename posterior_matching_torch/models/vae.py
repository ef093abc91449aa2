"""The Posterior-Matching VAE.

Counterpart of ``posterior_matching_tpu/models/vae.py:31-284``: a VAE (an
encoder and posterior head, a decoder and likelihood head, a standard
normal prior) and a partial encoder, fed ``x_o = x b`` joined to ``b`` on
the last axis, whose partially observed posterior q(z | x_o) is trained to
match the full posterior by maximising ``log q(z | x_o)`` at ``z ~ q(z |
x)``. ``impute``, ``is_log_prob`` and ``expected_info_gains`` decode all
their samples in one flat decoder forward, as the JAX package does.

Parameters keep the flax names (``encoder_net``, ``posterior_dist``,
``decoder_net``, ``decoder_dist``, ``partial_encoder_net``,
``partial_posterior_dist``, then each network's and head's own), so a
state-dict name is the JAX tree path joined by dots
(``convert.pm_vae_state_dict``). The data's shape is the likelihood's
event: the decoder's output for the Bernoulli head, ``(event_size,)`` for
the Gaussian heads.

Sampling takes ``noise`` (:data:`~posterior_matching_torch.distributions.
Noise`): a ``torch.Generator``, or an iterator of the caller's standard
normals in the order in which the JAX package calls ``make_rng("sample")``
(the posterior, then the partial posterior, one draw each). Dropout, in
training only, draws from its own generator.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from posterior_matching_torch.distributions import MultivariateNormalDiag, Noise
from posterior_matching_torch.models.heads import get_distribution
from posterior_matching_torch.models.networks import get_network
from posterior_matching_torch.runtime import resolve_device
from posterior_matching_torch.utils import logmeanexp


def sum_over_event(x: torch.Tensor) -> torch.Tensor:
    """Sums every axis but the leading batch axis."""
    return x if x.ndim <= 1 else x.reshape(x.shape[0], -1).sum(-1)


def _data_shape(head: str, head_config: Mapping[str, Any], net_out: Sequence[int]):
    """The data's shape (no batch axis): the event of the likelihood head on
    features of shape ``net_out``."""
    if head == "Bernoulli":
        return tuple(net_out)
    if head == "OneDimensionalGMM":
        return (*net_out[:-1], head_config["event_size"])
    return (head_config["event_size"],)


def _joined(shape: Sequence[int]) -> Tuple[int, ...]:
    """The shape of ``x_o`` joined to ``b`` on the last axis."""
    return (*shape[:-1], 2 * shape[-1])


class PosteriorMatchingVAE(nn.Module):
    """Build it with :meth:`from_config`."""

    def __init__(self, latent_dim: int, encoder_net: str, encoder_net_config,
                 decoder_net: str, decoder_net_config, partial_encoder_net: str,
                 partial_encoder_net_config, posterior_dist: str, posterior_dist_config,
                 decoder_dist: str, decoder_dist_config, partial_posterior_dist: str,
                 partial_posterior_dist_config, matching_ll_stop_gradients: bool = False):
        super().__init__()
        self.latent_dim = latent_dim
        self.matching_ll_stop_gradients = matching_ll_stop_gradients
        self.decoder_net = get_network(decoder_net, decoder_net_config, (latent_dim,))
        self.decoder_dist = get_distribution(decoder_dist, decoder_dist_config,
                                             self.decoder_net.out_shape)
        self.data_shape = _data_shape(decoder_dist, decoder_dist_config or {},
                                      self.decoder_net.out_shape)
        self.encoder_net = get_network(encoder_net, encoder_net_config, self.data_shape)
        self.posterior_dist = get_distribution(posterior_dist, posterior_dist_config,
                                               self.encoder_net.out_shape)
        self.partial_encoder_net = get_network(partial_encoder_net, partial_encoder_net_config,
                                               _joined(self.data_shape))
        self.partial_posterior_dist = get_distribution(
            partial_posterior_dist, partial_posterior_dist_config,
            self.partial_encoder_net.out_shape)

    @classmethod
    def from_config(cls, config: Mapping[str, Any],
                    device: Optional[str] = None) -> "PosteriorMatchingVAE":
        """From a ``model_config.json`` dict (``vae.py:55-101``), on
        ``device`` (the GPU unless ``"cpu"``). As in the JAX package only
        the ``partial_posterior_dist*`` keys are read: the UCI configs'
        ``masked_posterior_*`` keys are ignored, so their partial posterior
        is the posterior's TriL Gaussian."""
        dev = resolve_device(device)
        posterior_cfg = dict(config.get("posterior_dist_config") or {})
        posterior_cfg["event_size"] = config["latent_dim"]
        partial_cfg = dict(config.get("partial_posterior_dist_config") or posterior_cfg)
        partial_cfg["event_size"] = config["latent_dim"]
        model = cls(
            latent_dim=config["latent_dim"],
            encoder_net=config["encoder_net"],
            encoder_net_config=config.get("encoder_net_config"),
            decoder_net=config["decoder_net"],
            decoder_net_config=config.get("decoder_net_config"),
            partial_encoder_net=config.get("partial_encoder_net", config["encoder_net"]),
            partial_encoder_net_config=config.get("partial_encoder_net_config",
                                                  config.get("encoder_net_config")),
            posterior_dist=config["posterior_dist"],
            posterior_dist_config=posterior_cfg,
            decoder_dist=config["decoder_dist"],
            decoder_dist_config=config.get("decoder_dist_config"),
            partial_posterior_dist=config.get("partial_posterior_dist",
                                              config["posterior_dist"]),
            partial_posterior_dist_config=partial_cfg,
            matching_ll_stop_gradients=config.get("matching_ll_stop_gradients", False),
        )
        return model.to(dev)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    # -- pipelines -----------------------------------------------------------

    def encode(self, x, training: bool = False, dropout: Optional[torch.Generator] = None):
        return self.posterior_dist(self.encoder_net(x, training, dropout))

    def decode(self, z, training: bool = False, dropout: Optional[torch.Generator] = None):
        return self.decoder_dist(self.decoder_net(z, training, dropout))

    def encode_partial(self, x_o_b, training: bool = False,
                       dropout: Optional[torch.Generator] = None):
        return self.partial_posterior_dist(self.partial_encoder_net(x_o_b, training, dropout))

    def prior(self) -> MultivariateNormalDiag:
        zeros = torch.zeros(self.latent_dim, device=self.device)
        return MultivariateNormalDiag(loc=zeros, scale_diag=torch.ones_like(zeros))

    def _decode_flat(self, z: torch.Tensor):
        """``z [S..., B, L]`` through one decoder forward: the distribution
        with batch ``[S..., B]``."""
        lead = z.shape[:-1]
        dist = self.decode(z.reshape(-1, z.shape[-1]))
        return dataclasses.replace(dist, **{
            f.name: getattr(dist, f.name).reshape(*lead, *getattr(dist, f.name).shape[1:])
            for f in dataclasses.fields(dist)})

    # -- public API ----------------------------------------------------------

    def forward(self, x: torch.Tensor, b: torch.Tensor, noise: Noise, training: bool = False,
                dropout: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """``reconstruction_ll``, ``kl`` and ``matching_ll``, each ``[B]``
        (``vae.py:169-196``)."""
        posterior = self.encode(x, training, dropout)
        z = posterior.sample(noise)
        decoded = self.decode(z, training, dropout)
        reconstruction_ll = sum_over_event(decoded.log_prob(x))
        kl = posterior.kl_divergence(self.prior())
        x_o_b = torch.cat([x * b, b], -1)
        partial_posterior = self.encode_partial(x_o_b, training, dropout)
        if self.matching_ll_stop_gradients:
            z = z.detach()
        return {"reconstruction_ll": reconstruction_ll, "kl": kl,
                "matching_ll": partial_posterior.log_prob(z)}

    def impute(self, x_o: torch.Tensor, b: torch.Tensor, noise: Noise,
               num_samples: int = 100) -> torch.Tensor:
        """``[num_samples, *x_o.shape]``: decoded means of q(z | x_o)
        samples, with the observed values kept (``vae.py:198-212``)."""
        x_o = x_o * b
        partial_posterior = self.encode_partial(torch.cat([x_o, b], -1))
        z = partial_posterior.sample(noise, (num_samples,))
        x_u = self._decode_flat(z).mean()
        return torch.where(b[None] != 0, x_o[None], x_u)

    def is_log_prob(self, x: torch.Tensor, b: torch.Tensor, noise: Noise,
                    num_samples: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
        """Importance-sampled ``log p(x)`` and ``log p(x_u | x_o)``, each
        ``[B]`` (``vae.py:214-254``)."""
        s, n = num_samples, x.shape[0]
        x_o_b = torch.cat([x * b, b], -1)
        posterior = self.encode(x)
        partial_posterior = self.encode_partial(x_o_b)
        z = posterior.sample(noise, (s,))
        z_xo = partial_posterior.sample(noise, (s,))
        prior = self.prior()
        x_b = x[None].expand(s, *x.shape)
        log_p_xgz = sum_over_event(
            self._decode_flat(z).log_prob(x_b).reshape(s * n, -1)).reshape(s, n)
        log_p_xogz = sum_over_event(
            (self._decode_flat(z_xo).log_prob(x_b) * b[None]).reshape(s * n, -1)).reshape(s, n)
        log_p_x = logmeanexp(log_p_xgz + prior.log_prob(z) - posterior.log_prob(z), 0)
        log_p_xo = logmeanexp(
            log_p_xogz + prior.log_prob(z_xo) - partial_posterior.log_prob(z_xo), 0)
        return log_p_x, log_p_x - log_p_xo

    def expected_info_gains(self, x: torch.Tensor, b: torch.Tensor, noise: Noise,
                            num_samples: int = 100) -> torch.Tensor:
        """The expected information gain of observing each feature of one
        instance ``x`` (no batch axis), ``-inf`` where ``b`` already observes
        it, flattened (``vae.py:256-284``): the partial posterior's entropy
        before, minus its mean over ``num_samples`` imputations after, all
        ``S (F + 1)`` masked inputs in one forward."""
        return self.batch_info_gains(x[None], b[None], noise, num_samples)[0]

    def batch_info_gains(self, x: torch.Tensor, b: torch.Tensor, noise: Noise,
                         num_samples: int = 100) -> torch.Tensor:
        """:meth:`expected_info_gains` of each of ``N`` instances ``x [N,
        D...]`` at once: ``[N, F]``, the ``S N (F + 1)`` masked inputs in one
        forward. The samples are drawn for the batch, ``[S, N, L]``: for
        ``N = 1`` the single instance's draw."""
        x_o = x * b
        partial_posterior = self.encode_partial(torch.cat([x_o, b], -1))
        z = partial_posterior.sample(noise, (num_samples,))         # [S, N, L]
        x_u = self._decode_flat(z).mean()                           # [S, N, D...]
        n, f = b.shape[0], math.prod(b.shape[1:])
        one_hots = torch.eye(f, device=x.device, dtype=x.dtype).reshape(f, *b.shape[1:])
        masks = torch.cat([b[:, None], torch.maximum(b[:, None], one_hots[None])], 1)
        x_o_u = torch.where(b[None] == 1, x_o[None], x_u)          # [S, N, D...]
        xs = x_o_u[:, :, None] * masks[None]                        # [S, N, F + 1, D...]
        inp = torch.cat([xs, masks[None].expand(xs.shape)], -1)
        ents = self.encode_partial(inp.reshape(-1, *inp.shape[3:])).entropy()
        ents = ents.reshape(num_samples, n, f + 1).mean(0)
        gains = (ents[:, :1] - ents[:, 1:]).reshape(b.shape)
        return torch.where(b == 0, gains, torch.full_like(gains, -math.inf)).reshape(n, f)

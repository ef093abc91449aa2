"""Distribution heads: modules mapping features to distributions.

Counterpart of ``posterior_matching_tpu/models/heads.py:40-262``: the
Bernoulli, identity-scale Gaussian, diagonal and TriL Gaussian,
per-dimension GMM and autoregressive GMM heads and :func:`get_distribution`.
Each head is built from its input's shape (no batch axis) and keeps flax's
parameter names; heads that flatten their input flatten it in NHWC order,
as the JAX package does.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from posterior_matching_torch.distributions import (
    GMM1D,
    Bernoulli,
    MultivariateNormalDiag,
    MultivariateNormalTriL,
    Noise,
    Normal,
    fill_scale_tril,
    softplus_scale,
    tril_size,
)
from posterior_matching_torch.models.networks import (
    Dense,
    pure_residual_mlp_apply,
    pure_residual_mlp_params,
)


def _flatten(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


class BernoulliHead(nn.Module):
    """The features as Bernoulli logits."""

    def __init__(self, in_shape: Sequence[int]):
        super().__init__()

    def forward(self, x: torch.Tensor) -> Bernoulli:
        return Bernoulli(logits=x)


class IdentityGaussianHead(nn.Module):
    """A Dense loc and one learned scalar log-scale."""

    def __init__(self, in_shape: Sequence[int], event_size: int):
        super().__init__()
        self.Dense_0 = Dense(math.prod(in_shape), event_size)
        self.log_scale = nn.Parameter(torch.zeros(()))

    def forward(self, x: torch.Tensor) -> Normal:
        loc = self.Dense_0(_flatten(x))
        return Normal(loc=loc, scale=torch.exp(self.log_scale).expand(loc.shape))


class DiagonalGaussianHead(nn.Module):
    def __init__(self, in_shape: Sequence[int], event_size: int):
        super().__init__()
        self.event_size = event_size
        self.Dense_0 = Dense(math.prod(in_shape), 2 * event_size)

    def forward(self, x: torch.Tensor) -> MultivariateNormalDiag:
        params = self.Dense_0(_flatten(x))
        k = self.event_size
        return MultivariateNormalDiag(loc=params[:, :k], scale_diag=softplus_scale(params[:, k:]))


class TriLGaussianHead(nn.Module):
    """``Dense(k + k (k + 1) / 2)``: the loc, then the scale through
    ``fill_scale_tril``."""

    def __init__(self, in_shape: Sequence[int], event_size: int):
        super().__init__()
        self.event_size = event_size
        self.Dense_0 = Dense(math.prod(in_shape), event_size + tril_size(event_size))

    def forward(self, x: torch.Tensor) -> MultivariateNormalTriL:
        params = self.Dense_0(_flatten(x))
        k = self.event_size
        return MultivariateNormalTriL(loc=params[:, :k],
                                      scale_tril=fill_scale_tril(params[:, k:], k))


def _gmm(params: torch.Tensor, k: int) -> GMM1D:
    return GMM1D(logits=params[..., :k], means=params[..., k:-k],
                 scales=softplus_scale(params[..., -k:]))


class OneDimensionalGMMHead(nn.Module):
    """A K-component mixture per event dimension, batch ``[..., D]``."""

    def __init__(self, in_shape: Sequence[int], event_size: int, num_components: int = 10):
        super().__init__()
        self.event_size, self.k = event_size, num_components
        self.Dense_0 = Dense(in_shape[-1], 3 * num_components * event_size)

    def forward(self, x: torch.Tensor) -> GMM1D:
        params = self.Dense_0(x).reshape(*x.shape[:-1], self.event_size, 3 * self.k)
        return _gmm(params, self.k)


# ---------------------------------------------------------------------------
# Autoregressive GMM
# ---------------------------------------------------------------------------


def _agmm_net_out(net_params, x_o, mask, context, event_size, k) -> GMM1D:
    """One batched forward of the conditional net on ``[..., D]`` /
    ``[..., D]`` / ``[..., C]`` inputs: a GMM1D with batch ``[..., D]``."""
    inp = torch.cat([x_o, mask, context], -1)
    out = pure_residual_mlp_apply(net_params, inp.reshape(-1, inp.shape[-1]))
    return _gmm(out.reshape(*inp.shape[:-1], event_size, 3 * k), k)


class AutoregressiveGMM:
    """An autoregressive per-dimension GMM over ``[..., B, D]`` given a
    context ``[B, C]`` (``heads.py:126-212``): dimension ``i``'s mixture
    comes from the net fed ``(x_<i, mask_<i, context)``."""

    def __init__(self, context: torch.Tensor, net_params, event_size: int, num_components: int):
        self.context, self.net_params = context, net_params
        self.event_size, self.num_components = event_size, num_components

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        """All D teacher-forced conditionals in one batched forward: row
        ``i`` sees ``value`` under the strictly-lower-triangular mask."""
        d = self.event_size
        masks = (torch.arange(d, device=value.device)[None, :]
                 < torch.arange(d, device=value.device)[:, None]).to(value.dtype)
        v = value[..., None, :]                       # [..., B, 1, D]
        x_o = v * masks                               # [..., B, D, D]
        bshape = x_o.shape[:-2]
        m = masks.expand(*bshape, d, d)
        ctx = self.context[..., None, :].expand(*bshape, d, self.context.shape[-1])
        gmm = _agmm_net_out(self.net_params, x_o, m, ctx, d, self.num_components)
        lls = gmm.log_prob(v)                         # [..., B, D(step), D(dims)]
        return torch.diagonal(lls, dim1=-2, dim2=-1).sum(-1)

    def sample(self, noise: Noise, sample_shape=()) -> torch.Tensor:
        """Dimension by dimension (``heads.py:180-206``): step ``i`` runs the
        net on the dimensions drawn so far and draws dimension ``i`` from
        its mixture, taking a component and a normal of shape ``[n, B]``
        from ``noise`` (:class:`~posterior_matching_torch.distributions.
        GMM1D`)."""
        n = math.prod(sample_shape)
        b, d = self.context.shape[0], self.event_size
        ctx = self.context[None].expand(n, b, self.context.shape[-1])
        x = self.context.new_zeros(n, b, d)
        for i in range(d):
            mask = (torch.arange(d, device=x.device) < i).to(x.dtype).expand(n, b, d)
            gmm = _agmm_net_out(self.net_params, x * mask, mask, ctx, d, self.num_components)
            step = GMM1D(gmm.logits[..., i, :], gmm.means[..., i, :], gmm.scales[..., i, :])
            x = torch.where(torch.arange(d, device=x.device) == i, step.sample(noise)[..., None], x)
        return x.reshape(*sample_shape, b, d)

    def entropy(self) -> torch.Tensor:
        raise NotImplementedError(
            "AutoregressiveGMM has no closed-form entropy (nor does the reference's)")


class AutoregressiveGMMHead(nn.Module):
    """The context (the flattened features) and the conditional net's
    parameters ``ar_net_*`` (``heads.py:215-241``)."""

    def __init__(self, in_shape: Sequence[int], event_size: int, num_components: int = 10,
                 residual_blocks: int = 2, hidden_units: int = 256):
        super().__init__()
        self.event_size, self.num_components = event_size, num_components
        pure_residual_mlp_params(
            self, 2 * event_size + math.prod(in_shape), hidden_units, residual_blocks,
            3 * num_components * event_size, name="ar_net")
        self.residual_blocks = residual_blocks

    def net_params(self):
        """The conditional net's parameters as the tree
        ``pure_residual_mlp_apply`` takes."""
        layer = lambda name: {"w": getattr(self, f"ar_net_{name}_w"),
                              "b": getattr(self, f"ar_net_{name}_b")}
        return {"in": layer("in"), "out": layer("out"),
                "blocks": [{"a": layer(f"block{i}_a"), "b": layer(f"block{i}_b")}
                           for i in range(self.residual_blocks)]}

    def forward(self, x: torch.Tensor) -> AutoregressiveGMM:
        return AutoregressiveGMM(_flatten(x), self.net_params(), self.event_size,
                                 self.num_components)


_DISTRIBUTIONS = {
    "Bernoulli": BernoulliHead,
    "IdentityGaussian": IdentityGaussianHead,
    "DiagonalGaussian": DiagonalGaussianHead,
    "TriLGaussian": TriLGaussianHead,
    "OneDimensionalGMM": OneDimensionalGMMHead,
    "AutoregressiveGMM": AutoregressiveGMMHead,
}


def get_distribution(distribution_type: str,
                     distribution_config: Optional[Mapping[str, Any]],
                     in_shape: Sequence[int]) -> nn.Module:
    """A head by the reference's registry name (``heads.py:254-262``),
    built for features of shape ``in_shape`` (no batch axis)."""
    cfg: Dict[str, Any] = dict(distribution_config or {})
    return _DISTRIBUTIONS[distribution_type](tuple(in_shape), **cfg)

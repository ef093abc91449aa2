"""A mixture of 1-D normals on the last parameter axis.

Counterpart of ``posterior_matching_tpu/distributions/mixture.py:11-52``
(the reference's ``MixtureSameFamily(Categorical, Normal)``):
``logits`` / ``means`` / ``scales`` are ``[..., K]``, the batch shape is
``[...]`` and the event a scalar.

``sample`` draws a component, then a normal. Both come from ``noise``: a
``torch.Generator`` (the component by the Gumbel-max rule on its uniforms,
as ``jax.random.categorical`` picks it), or an iterator that hands out the
component indices (integers) and then the standard normals, each of shape
``sample_shape + batch``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from posterior_matching_torch.distributions.normal import Noise, Normal, standard_normal


def categorical(noise: Noise, logits: torch.Tensor, shape) -> torch.Tensor:
    """Indices into the last axis of ``logits`` (broadcast to ``shape``),
    drawn from ``noise`` or handed out by it."""
    if not isinstance(noise, torch.Generator):
        comp = next(noise)
        if tuple(comp.shape) != tuple(shape):
            raise ValueError(f"injected components have shape {tuple(comp.shape)}, "
                             f"the sample needs {tuple(shape)}")
        return comp.to(logits.device, torch.long)
    u = torch.rand((*shape, logits.shape[-1]), generator=noise, device=noise.device)
    u = u.to(logits.device).clamp_min(torch.finfo(u.dtype).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), -1)


@dataclass
class GMM1D:
    logits: torch.Tensor
    means: torch.Tensor
    scales: torch.Tensor

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        comp_lp = Normal(self.means, self.scales).log_prob(x[..., None])
        mix_lp = torch.log_softmax(self.logits, -1)
        return torch.logsumexp(comp_lp + mix_lp, -1)

    def mean(self) -> torch.Tensor:
        return (torch.softmax(self.logits, -1) * self.means).sum(-1)

    def sample(self, noise: Noise, sample_shape=()) -> torch.Tensor:
        shape = (*sample_shape, *self.logits.shape[:-1])
        comp = categorical(noise, self.logits, shape)[..., None]
        k = self.logits.shape[-1]
        mu = self.means.expand(*shape, k).gather(-1, comp)[..., 0]
        sd = self.scales.expand(*shape, k).gather(-1, comp)[..., 0]
        return mu + sd * standard_normal(noise, shape, mu.device)

"""Gaussian distributions for PM-VDVAE.

Counterpart of ``posterior_matching_tpu/distributions/normal.py``'s
``MultivariateNormalDiag`` and ``MultivariateNormalTriL`` with ``log_prob``,
``sample`` and the KL divergences diag || diag and diag || TriL. The event
is the last axis.

``sample`` takes its standard normals from ``noise``: a ``torch.Generator``
(drawn on the generator's device), or an iterator of tensors that hands out
the caller's own normals in the order the samples are drawn. The JAX
package draws one ``make_rng("sample")`` key per call in the same order,
which is how the tests feed both packages the same normals.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Union

import torch

from posterior_matching_torch.distributions._math import LOG_2PI, kl_diag_tril

Noise = Union[torch.Generator, Iterator[torch.Tensor]]


def standard_normal(noise: Noise, shape, device) -> torch.Tensor:
    """``shape`` standard normals on ``device`` from ``noise``."""
    if isinstance(noise, torch.Generator):
        return torch.randn(shape, generator=noise, device=noise.device).to(device)
    eps = next(noise)
    if tuple(eps.shape) != tuple(shape):
        raise ValueError(f"injected normals have shape {tuple(eps.shape)}, "
                         f"the sample needs {tuple(shape)}")
    return eps.to(device)


@dataclass
class MultivariateNormalDiag:
    loc: torch.Tensor
    scale_diag: torch.Tensor

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        z = (x - self.loc) / self.scale_diag
        return -0.5 * (z * z + LOG_2PI).sum(-1) - torch.log(self.scale_diag).sum(-1)

    def sample(self, noise: Noise) -> torch.Tensor:
        eps = standard_normal(noise, self.loc.shape, self.loc.device)
        return self.loc + self.scale_diag * eps

    def kl_divergence(self, other) -> torch.Tensor:
        if isinstance(other, MultivariateNormalDiag):
            var_ratio = (self.scale_diag / other.scale_diag) ** 2
            t1 = ((self.loc - other.loc) / other.scale_diag) ** 2
            return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio)).sum(-1)
        if isinstance(other, MultivariateNormalTriL):
            k = self.loc.shape[-1]
            batch = torch.broadcast_shapes(
                self.loc.shape[:-1], self.scale_diag.shape[:-1],
                other.loc.shape[:-1], other.scale_tril.shape[:-2],
            )
            return kl_diag_tril(
                self.loc.expand(*batch, k), self.scale_diag.expand(*batch, k),
                other.loc.expand(*batch, k), other.scale_tril.expand(*batch, k, k),
            )
        raise NotImplementedError(type(other))


@dataclass
class MultivariateNormalTriL:
    loc: torch.Tensor
    scale_tril: torch.Tensor

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        diff = x - self.loc
        k = diff.shape[-1]
        tril = self.scale_tril.expand(*diff.shape, k)
        z = torch.linalg.solve_triangular(tril, diff[..., None], upper=False)[..., 0]
        log_det = torch.log(torch.diagonal(self.scale_tril, dim1=-2, dim2=-1)).sum(-1)
        return -0.5 * (z * z).sum(-1) - 0.5 * k * LOG_2PI - log_det

    def sample(self, noise: Noise) -> torch.Tensor:
        eps = standard_normal(noise, self.loc.shape, self.loc.device)
        return self.loc + (self.scale_tril @ eps[..., None])[..., 0]

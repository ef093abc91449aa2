"""Gaussian distributions.

Counterpart of ``posterior_matching_tpu/distributions/normal.py``:
``Normal`` (elementwise, :29-64), ``MultivariateNormalDiag`` and
``MultivariateNormalTriL`` (the event is the last axis) with ``log_prob``,
``sample``, ``mean`` and ``entropy``, and the KL divergences diag || diag,
diag || TriL (PM-VDVAE's) and TriL || diag (PM-VAE's posterior against its
prior, :189-203).

``sample`` takes its standard normals from ``noise``: a ``torch.Generator``
(drawn on the generator's device), or an iterator of tensors that hands out
the caller's own normals in the order the samples are drawn. The JAX
package draws one ``make_rng("sample")`` key per call in the same order,
which is how the tests feed both packages the same normals. A leading
``sample_shape`` draws normals of shape ``sample_shape + loc.shape``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Union

import torch

from posterior_matching_torch.distributions._math import LOG_2PI, kl_diag_tril

HALF_LOG_2PI = 0.5 * LOG_2PI
LOG_2PIE = LOG_2PI + 1.0

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


def _normals(noise: Noise, loc: torch.Tensor, sample_shape) -> torch.Tensor:
    return standard_normal(noise, (*sample_shape, *loc.shape), loc.device)


@dataclass
class Normal:
    """Elementwise normal: ``loc`` and ``scale`` of one shape."""

    loc: torch.Tensor
    scale: torch.Tensor

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        z = (x - self.loc) / self.scale
        return -0.5 * z * z - torch.log(self.scale) - HALF_LOG_2PI

    def sample(self, noise: Noise, sample_shape=()) -> torch.Tensor:
        return self.loc + self.scale * _normals(noise, self.loc, sample_shape)

    def mean(self) -> torch.Tensor:
        return self.loc

    def entropy(self) -> torch.Tensor:
        return 0.5 * LOG_2PIE + torch.log(self.scale)


@dataclass
class MultivariateNormalDiag:
    loc: torch.Tensor
    scale_diag: torch.Tensor

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        z = (x - self.loc) / self.scale_diag
        return -0.5 * (z * z + LOG_2PI).sum(-1) - torch.log(self.scale_diag).sum(-1)

    def sample(self, noise: Noise, sample_shape=()) -> torch.Tensor:
        return self.loc + self.scale_diag * _normals(noise, self.loc, sample_shape)

    def mean(self) -> torch.Tensor:
        return self.loc

    def entropy(self) -> torch.Tensor:
        k = self.loc.shape[-1]
        return 0.5 * k * LOG_2PIE + torch.log(self.scale_diag).sum(-1)

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
        return -0.5 * (z * z).sum(-1) - 0.5 * k * LOG_2PI - self._log_det()

    def _log_det(self) -> torch.Tensor:
        return torch.log(torch.diagonal(self.scale_tril, dim1=-2, dim2=-1)).sum(-1)

    def sample(self, noise: Noise, sample_shape=()) -> torch.Tensor:
        eps = _normals(noise, self.loc, sample_shape)
        return self.loc + (self.scale_tril @ eps[..., None])[..., 0]

    def mean(self) -> torch.Tensor:
        return self.loc

    def entropy(self) -> torch.Tensor:
        return 0.5 * self.loc.shape[-1] * LOG_2PIE + self._log_det()

    def kl_divergence(self, other) -> torch.Tensor:
        """KL(self || a diagonal MVN): ``0.5 (|L / s|_F^2 + |(m_q - m_p) /
        s|^2 - k) + log|diag s| - log|L|`` (``normal.py:189-203``)."""
        if not isinstance(other, MultivariateNormalDiag):
            raise NotImplementedError(type(other))
        k = self.loc.shape[-1]
        lp = self.scale_tril.expand(*self.loc.shape, k)
        inv_sq = 1.0 / other.scale_diag
        trace = ((lp * inv_sq[..., :, None]) ** 2).sum((-2, -1))
        maha = (((other.loc - self.loc) * inv_sq) ** 2).sum(-1)
        log_det_q = torch.log(other.scale_diag).sum(-1)
        return 0.5 * (trace + maha - k) + log_det_q - self._log_det()

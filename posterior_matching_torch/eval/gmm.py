"""A diagonal-covariance Gaussian mixture fitted by EM, on the device.

The port's counterpart of ``sklearn.mixture.GaussianMixture(n_components,
covariance_type="diag", max_iter=300, n_init=10)`` as ``train_vade.py:
152-158`` fits it, with sklearn's defaults ``tol=1e-3`` and
``reg_covar=1e-6`` and its algorithm:

- each of the ``n_init`` initialisations is one k-means run (``n_init=1``:
  :func:`~posterior_matching_torch.eval.prd.kmeans`, k-means++ seeding
  from an explicit generator and Lloyd steps, at most 300), whose labels
  as one-hot responsibilities give the first M-step (the weights over
  ``n``);
- then E-step, M-step, until the lower bound (the mean log-likelihood of
  the E-step) moves by less than ``tol``, or ``max_iter`` iterations;
- the M-step's counts carry sklearn's ``10 eps``, its variances are
  ``E[x^2] - mean^2 + reg_covar``;
- the initialisation with the greatest final lower bound is kept, and
  :meth:`GaussianMixture.predict` is the argmax of the weighted log
  densities.

All the initialisations run at once, batched, in float64 on the device;
one that has converged keeps its parameters while the others go on. The
k-means draws are the generator's, so a fit equals sklearn's only in
distribution (sklearn's k-means++ is the greedy variant); on data whose
components are well separated both find the same mixture.
"""
from __future__ import annotations

import math
import warnings
from typing import Tuple

import numpy as np
import torch

from posterior_matching_torch.eval.prd import kmeans

_EPS = float(np.finfo(np.float64).eps)
TOL, REG_COVAR = 1e-3, 1e-6   # sklearn's defaults, which train_vade.py keeps


def _m_step(x: torch.Tensor, resp: torch.Tensor,
            reg_covar: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``resp [R, n, K]`` -> the counts ``[R, K]``, means and diagonal
    covariances ``[R, K, d]`` (sklearn's ``_estimate_gaussian_parameters``)."""
    nk = resp.sum(1) + 10 * _EPS
    rt = resp.transpose(1, 2)
    means = (rt @ x) / nk[..., None]
    covariances = (rt @ (x * x)) / nk[..., None] - means ** 2 + reg_covar
    return nk, means, covariances


def _weighted_log_prob(x: torch.Tensor, weights, means, covariances) -> torch.Tensor:
    """``log w_k + log N(x | mean_k, diag covariance_k)``: ``[R, n, K]``
    (sklearn's ``_estimate_log_gaussian_prob`` for ``"diag"``)."""
    prec_chol = 1.0 / torch.sqrt(covariances)
    log_det = torch.log(prec_chol).sum(-1)
    prec = prec_chol ** 2
    log_prob = ((means ** 2 * prec).sum(-1)[:, None, :]
                - 2.0 * x @ (means * prec).transpose(1, 2)
                + (x * x) @ prec.transpose(1, 2))
    d = x.shape[-1]
    return (-0.5 * (d * math.log(2 * math.pi) + log_prob) + log_det[:, None, :]
            + torch.log(weights)[:, None, :])


class GaussianMixture:
    """``fit(x)`` then ``predict(x)``; the fitted ``weights_ [K]``,
    ``means_ [K, d]`` and ``covariances_ [K, d]`` (the diagonals) are
    float64 numpy arrays, as sklearn's are, with ``lower_bound_``,
    ``n_iter_`` and ``converged_``. ``generator`` draws the k-means
    seeding, and its device is where the fit runs: numpy data is copied
    there, and a tensor on another device is refused."""

    def __init__(self, n_components: int, *, generator: torch.Generator,
                 max_iter: int = 300, n_init: int = 10):
        self.n_components, self.max_iter, self.n_init = n_components, max_iter, n_init
        self.generator = generator

    def _x(self, x) -> torch.Tensor:
        device = self.generator.device
        if not torch.is_tensor(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float64, device=device)
        if x.device.type != device.type:
            raise ValueError(f"data on {x.device}, generator on {device}")
        return x.to(device, torch.float64)

    def fit(self, x) -> "GaussianMixture":
        x = self._x(x)
        n, k, r = x.shape[0], self.n_components, self.n_init
        if n < k:
            raise ValueError(f"{n} samples for {k} components")
        labels = kmeans(x, k, runs=r, n_init=1, generator=self.generator, max_iter=300)
        resp = torch.nn.functional.one_hot(labels, k).double()
        nk, means, covs = _m_step(x, resp, REG_COVAR)
        weights = nk / n
        lower = torch.full((r,), -math.inf, dtype=torch.float64, device=x.device)
        active = torch.ones(r, dtype=torch.bool, device=x.device)
        n_iter = torch.zeros(r, dtype=torch.long, device=x.device)
        for it in range(1, self.max_iter + 1):
            weighted = _weighted_log_prob(x, weights, means, covs)
            log_norm = torch.logsumexp(weighted, -1)                 # [R, n]
            bound = log_norm.mean(-1)
            nk_new, means_new, covs_new = _m_step(
                x, torch.exp(weighted - log_norm[..., None]), REG_COVAR)
            keep = lambda new, old: torch.where(
                active.view(-1, *([1] * (new.ndim - 1))), new, old)
            weights = keep(nk_new / nk_new.sum(-1, keepdim=True), weights)
            means, covs = keep(means_new, means), keep(covs_new, covs)
            change = bound - lower
            lower = keep(bound, lower)
            n_iter = keep(torch.full_like(n_iter, it), n_iter)
            active = active & ~(change.abs() < TOL)
            if not bool(active.any()):
                break
        best = int(torch.argmax(lower))
        self.converged_ = not bool(active[best])
        if not self.converged_:
            warnings.warn("Best performing initialization did not converge.")
        self.lower_bound_ = float(lower[best])
        self.lower_bounds_ = lower.cpu().numpy()
        self.n_iter_ = int(n_iter[best])
        self._params = (weights[best:best + 1], means[best:best + 1], covs[best:best + 1])
        self.weights_, self.means_, self.covariances_ = (
            p[0].cpu().numpy() for p in self._params)
        return self

    def predict(self, x) -> np.ndarray:
        """The component of greatest weighted log density of each row."""
        return _weighted_log_prob(self._x(x), *self._params)[0].argmax(-1).cpu().numpy()

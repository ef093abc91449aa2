"""Numerical helpers of the distribution library.

Counterpart of ``posterior_matching_tpu/distributions/_math.py`` for the
pieces PM-VDVAE needs: :func:`fill_triangular` (:25-35, row-major packing as
``jnp.tril_indices`` gives it, not tfp's rotated layout),
:func:`fill_scale_tril` (:38-48), :func:`softplus_scale` (:51-54) and
:func:`kl_diag_tril` (:194-271). The JAX package unrolls its small
triangular solves and hand-writes their adjoints because XLA's batched
TriangularSolve is slow on a TPU; they run outside any Pallas kernel, so
here ``torch.linalg.solve_triangular`` and autograd take their place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LOG_2PI = math.log(2.0 * math.pi)


def tril_size(dim: int) -> int:
    """Number of entries in a lower-triangular ``dim x dim`` matrix."""
    return dim * (dim + 1) // 2


def fill_triangular(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Packs the last axis of ``x`` (``dim (dim + 1) / 2`` long) into a lower
    triangular ``[..., dim, dim]``, row-major: ``[[v0 0 0], [v1 v2 0], [v3
    v4 v5]]``."""
    rows, cols = torch.tril_indices(dim, dim, device=x.device)
    out = x.new_zeros((*x.shape[:-1], dim, dim))
    out[..., rows, cols] = x
    return out


def fill_scale_tril(x: torch.Tensor, dim: int, diag_shift: float = 1e-5) -> torch.Tensor:
    """An unconstrained vector -> a lower-triangular scale with positive
    diagonal ``softplus(raw) + diag_shift`` (tfp's ``FillScaleTriL``)."""
    tril = fill_triangular(x, dim)
    diag = F.softplus(torch.diagonal(tril, dim1=-2, dim2=-1)) + diag_shift
    return tril - torch.diag_embed(torch.diagonal(tril, dim1=-2, dim2=-1)) + torch.diag_embed(diag)


def softplus_scale(x: torch.Tensor, shift: float = 1e-5) -> torch.Tensor:
    """``softplus(x) + 1e-5``, the models' positive-scale transform."""
    return F.softplus(x) + shift


def kl_diag_tril(loc_p: torch.Tensor, scale_p: torch.Tensor, loc_q: torch.Tensor,
                 tril_q: torch.Tensor) -> torch.Tensor:
    """KL(N(loc_p, diag(scale_p)^2) || N(loc_q, L L^T)) as the JAX package
    computes it: one solve of ``L M = [D | d]`` (``D = diag(scale_p)``,
    ``d = loc_q - loc_p``), then ``0.5 (|M|_F^2 - k) + log|L| - log|D|``.
    Batch dims must match (callers broadcast first)."""
    k = tril_q.shape[-1]
    rhs = torch.cat([torch.diag_embed(scale_p), (loc_q - loc_p)[..., None]], dim=-1)
    m = torch.linalg.solve_triangular(tril_q, rhs, upper=False)
    quad = (m * m).sum((-2, -1))
    log_det_q = torch.log(torch.diagonal(tril_q, dim1=-2, dim2=-1)).sum(-1)
    log_det_p = torch.log(scale_p).sum(-1)
    return 0.5 * (quad - k) + log_det_q - log_det_p

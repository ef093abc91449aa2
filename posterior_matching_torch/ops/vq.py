"""Nearest-codebook search and the straight-through estimator.

Counterpart of ``posterior_matching_tpu/ops/vq.py``. The search is
``argmax_k(2 z.e_k - |e_k|^2)``, which is ``argmin_k |z - e_k|^2`` (``|z|^2``
does not depend on k), with ties going to the lower index as
``jnp.argmax`` and ``torch.argmax`` break them.

On the GPU it is the hand-written kernel ``csrc/vq_search.cu`` (replacing
the Pallas ``_vq_kernel``, ``ops/vq.py:35``, ``pallas_call`` :68), which
never writes the ``[N, K]`` score matrix out: one launch a call, scores on
the tensor cores in 3xTF32. Beside it is the plain PyTorch
version, :func:`nearest_codebook_indices_plain`, which the wrapper runs only
for tensors on the CPU; for CUDA tensors it launches the kernel or raises.
The search is piecewise constant in its inputs, so it runs under
``no_grad``.
"""
from __future__ import annotations

import torch

from posterior_matching_torch.ops import _build

# The kernel's limit on the code width D (csrc/vq_search.cu kMaxD).
MAX_EMBEDDING_DIM = 256


def nearest_codebook_indices_plain(
    z: torch.Tensor, codebook: torch.Tensor
) -> torch.Tensor:
    """``z [N, D]``, ``codebook [K, D]`` -> int32 ``[N]``."""
    scores = 2.0 * (z @ codebook.T) - (codebook * codebook).sum(-1)[None, :]
    return torch.argmax(scores, dim=-1).to(torch.int32)


class _VqSearch:
    """Wrapper of ``csrc/vq_search.cu``: one kernel launch a call (the
    codebook's norms are taken inside it), the library and its entry point
    resolved at the first call. ``launches`` counts kernel launches; the
    plain version (CPU tensors) does not count."""

    def __init__(self):
        self.launches = 0
        self._lib = None

    @torch.no_grad()
    def __call__(self, z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
        z = z.detach()
        codebook = codebook.detach()
        if _build.on_cpu((z, codebook)):
            return nearest_codebook_indices_plain(z, codebook)
        n, d = z.shape
        k = codebook.shape[0]
        if not 1 <= d <= MAX_EMBEDDING_DIM:
            raise ValueError(
                f"vq_search kernel needs 1 <= D <= {MAX_EMBEDDING_DIM}, got {d}"
            )
        zp = _build.check("z", z, (n, d))
        cp = _build.check("codebook", codebook, (k, d))
        out = torch.empty(n, dtype=torch.int32, device=z.device)
        if self._lib is None:
            self._lib = _build.load_fn(
                "vq_search", "pm_vq_search", [_build.P] * 3 + [_build.I] * 3 + [_build.P]
            )
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = self._lib.pm_vq_search(zp, cp, out.data_ptr(), n, k, d, stream)
        self.launches += 1
        _build.raise_on(self._lib, err, "vq_search")
        return out


nearest_codebook_indices = _VqSearch()


def vq_straight_through(z: torch.Tensor, quantized: torch.Tensor) -> torch.Tensor:
    """Forward value ``quantized``, gradient to ``z`` (``vq.py:104-108``)."""
    return z + (quantized - z).detach()

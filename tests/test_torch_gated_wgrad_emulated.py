"""The gated chain's weight-gradient kernel (``csrc/gated_levels.cuh``'s
``wgrad`` and ``reduce_splits``), float32 build, emulated on the CPU,
against plain PyTorch.

The emulation, its helpers and ``data_gemm``'s cases are
``test_torch_gated_kernel_emulated.py``'s; each entry point and build is
tested from a file of its own, so that the suite's workers (``--dist
loadfile``) run them side by side. Tolerance as on the GPU: 1e-4 of the
tensor's scale. Skips where no C++20 compiler is found.
"""
import ctypes

import pytest
import torch

from posterior_matching_torch.ops import gated_chain as gc
from test_torch_gated_kernel_emulated import (
    A_CELU,
    A_CELU_DROP,
    KEEP,
    SEED,
    _arr,
    _close,
    _operand,
    _ptr,
    _rand,
    _shift,
    gated_library,
    kBM_ROWS,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return gated_library(tmp_path_factory, bf16=False)


# (N as a multiple of F, grid, taps (skh, skw, pad_top, pad_left), levels,
# dropout, rows a split or None for one split): conv_a's and an aux
# product's kinds (N = F), conv_b's (2F, dropout), ragged rows, and row
# splits (the last one short) added by reduce_splits; at 128 filters and at
# 64.
_WGRAD_CASES = [
    (1, 4, 4, (2, 2, 1, 1), 2, False, None, "taps0"),
    (2, 3, 5, (2, 3, 1, 1), 2, True, None, "taps1"),
    (2, 4, 4, (1, 1, 0, 0), 2, True, 16, "taps2"),
    (1, 3, 5, (2, 2, 1, 1), 1, False, 16, "taps3"),
]


def _wgrad_id(f, c):
    nf, h, w, _, L, drop, rows, taps = c
    return "-".join(map(str, (nf * f, h, w, taps, L, drop, rows)))


@pytest.mark.parametrize("F,nf,h,w,taps,L,drop,rows", [
    *(pytest.param(128, *c[:-1], id=_wgrad_id(128, c)) for c in _WGRAD_CASES),
    *(pytest.param(64, *c[:-1], id="f64-" + _wgrad_id(64, c)) for c in _WGRAD_CASES),
])
def test_emulated_wgrad_matches_plain(emu, F, nf, h, w, taps, L, drop, rows):
    N = nf * F
    gen = torch.Generator().manual_seed(100 * N + 10 * h + L)
    b, base, sub = 2, 3, 1
    R = b * h * w
    skh, skw, pt, pl = taps
    keep = KEEP if drop else 1.0
    S = 1 if rows is None else -(-R // rows)
    srcs = [_rand(gen, R, F) for _ in range(L)]
    # the cotangents, followed by NaNs: a read past the last row shows
    gcot = torch.cat([_rand(gen, L * R * N), torch.full((kBM_ROWS * N,), float("nan"))])
    gcot = gcot[: L * R * N].view(L, R, N)
    outs = [torch.full((skh * skw * 2 * F, N), float("nan")) for _ in range(L)]
    part = torch.full((L * S * skh * skw * 2 * F * N,), float("nan")) if S > 1 else None
    assert emu.emu_wgrad(
        F, N, L, b, h, w, (ctypes.c_int * 4)(*taps), int(drop), SEED, gc.keep_threshold(keep),
        base, sub, 1.0 / keep, _arr(srcs), _arr(outs), _ptr(gcot), _ptr(part), S,
        rows or R) == 0
    for lvl in range(L):
        mask = gc.dropout_keep_mask(SEED, 2 * (base + lvl) + sub, b, h, w, 2 * F, keep)
        a = _operand(srcs[lvl], A_CELU_DROP if drop else A_CELU, (b, h, w), mask, keep)
        want = torch.cat([_shift(a, i - pt, j - pl).reshape(R, -1).T @ gcot[lvl]
                          for i in range(skh) for j in range(skw)])
        _close(outs[lvl], want, f"level {lvl}")

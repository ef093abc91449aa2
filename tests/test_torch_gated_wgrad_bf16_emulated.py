"""The gated chain's weight-gradient kernel ``wgrad``
(``csrc/gated_levels.cuh``), its bf16 build (``-DPM_CORE_BF16=1``),
emulated on the CPU, against plain PyTorch on the rounded operands.

The emulation and its helpers are ``test_torch_gated_kernel_emulated.py``'s,
the cases ``test_torch_gated_wgrad_emulated.py``'s, the bf16 tolerance
``test_torch_gated_kernel_bf16_emulated.py``'s; each entry point and build
is tested from a file of its own, so that the suite's workers (``--dist
loadfile``) run them side by side. Skips where no C++20 compiler is found.
"""
import ctypes

import pytest
import torch

from posterior_matching_torch.ops import gated_chain as gc
from test_torch_gated_kernel_bf16_emulated import TOL_BF, _bf, _rb
from test_torch_gated_kernel_emulated import (
    A_CELU,
    A_CELU_DROP,
    KEEP,
    SEED,
    _arr,
    _operand,
    _ptr,
    _rand,
    _shift,
    gated_library,
)
from test_torch_gated_wgrad_emulated import _WGRAD_CASES, _wgrad_id
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    return {"bf16": gated_library(tmp_path_factory, bf16=True)}


@pytest.mark.parametrize("F,nf,h,w,taps,L,drop,rows", [
    *(pytest.param(128, *c[:-1], id=_wgrad_id(128, c)) for c in _WGRAD_CASES[1:3]),
    *(pytest.param(64, *c[:-1], id="f64-" + _wgrad_id(64, c)) for c in _WGRAD_CASES[::3]),
])
def test_emulated_wgrad_bf16_matches_plain(builds, F, nf, h, w, taps, L, drop, rows):
    """The bf16 path of wgrad: the bf16 sources' concat_elu (and mask)
    rounded to bf16 as they are staged along K, the float32 cotangent rows
    rounded at the fragment load, the row splits summed in float32 in split
    order."""
    emu = builds["bf16"]
    N = nf * F
    gen = torch.Generator().manual_seed(100 * N + 10 * h + L + 3)
    b, base, sub = 2, 3, 1
    R = b * h * w
    skh, skw, pt, pl = taps
    keep = KEEP if drop else 1.0
    S = 1 if rows is None else -(-R // rows)
    srcs = [_bf(_rand(gen, R, F)) for _ in range(L)]
    gcot = _rand(gen, L, R, N)
    outs = [torch.full((skh * skw * 2 * F, N), float("nan")) for _ in range(L)]
    part = torch.full((L * S * skh * skw * 2 * F * N,), float("nan")) if S > 1 else None
    assert emu.emu_wgrad(
        F, N, L, b, h, w, (ctypes.c_int * 4)(*taps), int(drop), SEED, gc.keep_threshold(keep),
        base, sub, 1.0 / keep, _arr(srcs), _arr(outs), _ptr(gcot), _ptr(part), S,
        rows or R) == 0
    for lvl in range(L):
        mask = gc.dropout_keep_mask(SEED, 2 * (base + lvl) + sub, b, h, w, 2 * F, keep)
        a = _rb(_operand(srcs[lvl].float(), A_CELU_DROP if drop else A_CELU, (b, h, w), mask,
                         keep))
        want = torch.cat([_shift(a, i - pt, j - pl).reshape(R, -1).double().T
                          @ _rb(gcot[lvl]).double()
                          for i in range(skh) for j in range(skw)]).float()
        err = (outs[lvl] - want).abs().max().item()
        assert err <= TOL_BF * max(1.0, want.abs().max().item()), (lvl, err)

"""The gated chain's GEMM kernel ``data_gemm`` (``csrc/gated_common.cuh``),
its bf16 build (``-DPM_CORE_BF16=1``), emulated on the CPU, against plain
PyTorch on the rounded operands.

The emulation, its helpers and the float32 build's cases are
``test_torch_gated_kernel_emulated.py``'s; each entry point and build is
tested from a file of its own, so that the suite's workers (``--dist
loadfile``) run them side by side. ``mma.sync`` m16n8k16 bf16 is emulated
warp by warp. Skips where no C++20 compiler is found.
"""
import ctypes

import pytest
import torch

from posterior_matching_torch.ops import gated_chain as gc
from test_torch_gated_kernel_emulated import (
    A_CELU,
    A_CELU_DROP,
    A_IDENT,
    BLOCK_ID,
    E_BIAS,
    E_CELU_BWD,
    E_GATE,
    KEEP,
    SEED,
    _arr,
    _operand,
    _ptr,
    _rand,
    _shift,
    gated_library,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    return {"bf16": gated_library(tmp_path_factory, bf16=True)}


# A float32 output of bf16 products against the same products of the rounded
# operands summed in float64: the sums differ in their order only, but an
# operand that concat_elu's exp rounds one float32 ulp apart on the two sides
# can round to the neighbouring bf16 value (one bf16 ulp, 2^-8, of one term),
# so 2e-3 of the tensor's scale. A rounded output: at most 2% of its values
# one bf16 ulp from the rounded reference, none further than 2^-7 of scale.
TOL_BF = 2e-3
FLIP_SHARE = 0.02


def _bf(t):
    return t.to(torch.bfloat16)


def _rb(t):
    return t.to(torch.bfloat16).float()


def _close_bf16(got, want, what):
    """A bf16 output ``got`` against the float32 ``want`` it rounds."""
    got, scale = got.float(), max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= 2 ** -7 * scale, what
    share = (got != _rb(want)).float().mean().item()
    assert share <= FLIP_SHARE, (what, share)


_GEMM_CASES_BF = [("bias", 4, 4), ("gate_drop", 3, 5), ("celu_bwd", 4, 4),
                  ("celu_bwd_drop", 3, 5), ("celu_bwd_act", 4, 4), ("celu_bwd_round", 3, 5)]


@pytest.mark.parametrize("F,case,h,w", [
    *(pytest.param(128, *c, id="-".join(map(str, c))) for c in _GEMM_CASES_BF),
    *(pytest.param(64, *c, id="f64-" + "-".join(map(str, c))) for c in _GEMM_CASES_BF),
])
def test_emulated_data_gemm_bf16_matches_plain(builds, F, case, h, w):
    """The bf16 path of data_gemm: A rounded to bf16 after concat_elu and
    the mask, bf16 weights through the ring, m16n8k16 MMAs, and each
    epilogue's rounding (a1 and b1 saved in bf16, the gate taken on the
    saved b1, x' rounded; a backward output in float32, in bf16
    (``celu_bwd_act``: a skip's or the chain input's cotangent) or as a
    float32 carry rounded to bf16 (``celu_bwd_round``: the stream's))."""
    emu = builds["bf16"]
    gen = torch.Generator().manual_seed(sum(map(ord, case)) * 100 + 10 * h + w + F + 7)
    b = 2
    grid, R = (b, h, w), b * h * w
    key = gc.stream_key(SEED, BLOCK_ID)
    mask = gc.dropout_keep_mask(SEED, BLOCK_ID, b, h, w, 2 * F, KEEP)
    drop = case in ("gate_drop", "celu_bwd_drop")
    keep = KEEP if drop else 1.0
    s = 0.05
    if case == "bias":
        N, epi, mode = F, E_BIAS, A_CELU
        x, aux = _bf(_rand(gen, R, F)), _bf(_rand(gen, R, F))
        taps = [(-1, 0), (0, -1)]
        srcs = [x, x, aux]
        ws = [_bf(_rand(gen, 2 * F, F, scale=s)) for _ in range(3)]
        terms = [(F, 2 * F, mode, dy, dx, F, 0) for dy, dx in taps] + [(F, 2 * F, mode, 0, 0,
                                                                       F, 0)]
    elif case == "gate_drop":
        N, epi, mode = 2 * F, E_GATE, A_CELU_DROP
        a1 = _bf(_rand(gen, R, F))
        taps = [(-1, -1), (-1, 0), (0, 0)]
        srcs = [a1] * 3
        ws = [_bf(_rand(gen, 2 * F, 2 * F, scale=s)) for _ in taps]
        terms = [(F, 2 * F, mode, dy, dx, 2 * F, 0) for dy, dx in taps]
    else:
        N, epi, mode = 2 * F, E_CELU_BWD, A_IDENT
        c = 2 * F if case in ("celu_bwd", "celu_bwd_round") else F
        src = _rand(gen, R, c)
        taps = [(1, 0), (0, 1), (1, 1)]
        srcs = [src] * 3
        ws = [_bf(_rand(gen, 2 * F, c, scale=s)) for _ in taps]   # B(k, n) = w[n, k]
        terms = [(c, c, mode, dy, dx, c, 1) for dy, dx in taps]
    bias = _rand(gen, N, scale=s) if epi != E_CELU_BWD else None
    proj = _rand(gen, b, N) if epi == E_GATE else None
    xres = _bf(_rand(gen, R, F)) if epi == E_GATE else None
    z = _bf(_rand(gen, R, F)) if epi == E_CELU_BWD else None
    base1 = _rand(gen, R, F) if epi == E_CELU_BWD else None
    base2 = _bf(_rand(gen, R, F)) if case == "celu_bwd" else None
    out_c = epi != E_CELU_BWD or case == "celu_bwd_act"
    out = torch.full((R, N if epi != E_CELU_BWD else F), float("nan"),
                     dtype=torch.bfloat16 if out_c else torch.float32)
    out2 = torch.full((R, F), float("nan"), dtype=torch.bfloat16) if epi == E_GATE else None
    ints = (ctypes.c_int * (7 * len(terms)))(*[v for t in terms for v in t])
    assert emu.emu_data_gemm(
        N, b, h, w, len(terms), _arr(srcs), _arr(ws), ints, key, gc.keep_threshold(keep),
        1.0 / keep, int(drop), epi, _ptr(bias), _ptr(proj), _ptr(xres), _ptr(z),
        _ptr(base1), _ptr(base2), _ptr(out), _ptr(out2), int(out_c),
        int(case == "celu_bwd_round")) == 0

    acc = torch.zeros(R, N, dtype=torch.float64)
    for src, wt, (_, _, md, dy, dx, _, trans) in zip(srcs, ws, terms):
        a = _rb(_shift(_operand(src.float(), md, grid, mask, keep), dy, dx).reshape(R, -1))
        acc = acc + a.double() @ (wt.T if trans else wt).double()
    acc = acc.float()
    img = torch.arange(R) // (h * w)
    if epi == E_BIAS:
        _close_bf16(out, acc + bias, "out")
    elif epi == E_GATE:
        b1 = acc + bias + proj[img]
        _close_bf16(out, b1, "out")
        act, gate = out.float()[:, :F], out.float()[:, F:]   # the saved b1
        _close_bf16(out2, xres.float() + torch.sigmoid(gate) * act, "out2")
    else:
        g = acc * mask.reshape(R, 2 * F) / keep if drop else acc
        zf = z.float()
        dpos = torch.where(zf > 0, torch.ones_like(zf), torch.exp(zf))
        dneg = torch.where(-zf > 0, torch.ones_like(zf), torch.exp(-zf))
        extra = base2.float() if base2 is not None else 0.0
        want = base1 + extra + g[:, :F] * dpos - g[:, F:] * dneg
        if out_c or case == "celu_bwd_round":
            _close_bf16(out, want, "out")
        else:
            err = (out - want).abs().max().item()
            assert err <= TOL_BF * max(1.0, want.abs().max().item()), err

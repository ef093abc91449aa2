"""The gated chain's GEMM kernels (``csrc/gated_common.cuh``'s ``data_gemm``,
``csrc/gated_levels.cuh``'s ``wgrad`` and ``reduce_splits``), emulated on the
CPU, against plain PyTorch.

The headers are compiled with ``g++`` against ``tests/cuda_emulation``: each
block runs as one thread per CUDA thread, ``mma.sync`` m16n8k8 TF32 is
emulated warp by warp by the PTX ISA's fragment layout (its operands read
as TF32) and a ``cp.async`` copy lands when it is issued. That runs the
kernels' own tiles, fragment layouts, operand gathers (tap shifts,
concat_elu, the dropout hash), B ring across term and chunk boundaries,
3xTF32 split, ragged rows, row splits and epilogues without a GPU; the
card's timing, memory model and PTX are left to the GPU tests. Toy grids
(2 images of 4 x 4 and, ragged, 3 x 5) at both built widths: 128 filters
and 64 (digits16's; conv_a's N = 64 is one n8 tile a warp).
Tolerance as on the GPU: 1e-4 of the tensor's scale. This file holds the
emulation, its helpers and ``data_gemm``'s float32 cases; ``wgrad``'s and
the bf16 build's are in ``test_torch_gated_{wgrad,kernel_bf16,wgrad_bf16}_
emulated.py``, one entry point and build a file, so that the suite's
workers (``--dist loadfile``) run them side by side. Skips where no C++20
compiler is found.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from posterior_matching_torch.ops import _build, gated_chain as gc
from test_torch_row_kernel_emulated import _replace_helpers, write_ptx_header
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

EMULATION = Path(__file__).resolve().parent / "cuda_emulation"
TOL = 1e-4
A_IDENT, A_CELU, A_CELU_DROP = 0, 1, 2
E_BIAS, E_GATE, E_CELU_BWD = 0, 1, 2
_SMEM = "extern __shared__ __align__(16) float smem[];"


def emulated_headers(out: Path):
    """Writes ``gated_common.cuh`` and ``gated_levels.cuh`` into ``out`` with
    their PTX helpers replaced, their dynamic shared memory the harness's
    array, and ``gated_levels.cuh`` cut before its launches."""
    common = (_build.CSRC / "gated_common.cuh").read_text()
    levels = (_build.CSRC / "gated_levels.cuh").read_text()
    levels = levels[: levels.index("// ---- launches")] + "}  // namespace gsk\n"
    assert common.count(_SMEM) == 1 and levels.count(_SMEM) == 1
    write_ptx_header(out)
    (out / "gated_common.cuh").write_text(
        _replace_helpers(common, "gated_common.cuh").replace(_SMEM, ""))
    (out / "gated_levels.cuh").write_text(
        _replace_helpers(levels, "gated_levels.cuh").replace(_SMEM, ""))


def gated_library(tmp_path_factory, bf16: bool):
    """The harness compiled against the emulated headers: the float32 build,
    or with ``bf16`` the bf16 one (``-DPM_CORE_BF16=1``). Each test file
    compiles the one build its cases run."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the emulated kernels")
    out = tmp_path_factory.mktemp("gated_emulation")
    emulated_headers(out)
    name, flags = ("bf16", ["-DPM_CORE_BF16=1"]) if bf16 else ("f32", [])
    lib = out / f"libgated_emulated_{name}.so"
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-w", *flags,
         "-I", str(out), "-I", str(EMULATION), "-o", str(lib),
         str(EMULATION / "gated_harness.cpp")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode and "<barrier>" in proc.stdout:
        pytest.skip("needs a C++20 standard library (<barrier>)")
    assert proc.returncode == 0, proc.stdout[-4000:]
    cdll = ctypes.CDLL(str(lib))
    P, I, U, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    cdll.emu_data_gemm.argtypes = ([I] * 5 + [P] * 3 + [U, U, F32, I, I] + [P] * 8 + [I, I])
    cdll.emu_data_gemm.restype = I
    cdll.emu_wgrad.argtypes = ([I] * 6 + [P, I, U, U, I, I, F32] + [P] * 4 + [I, I])
    cdll.emu_wgrad.restype = I
    return cdll


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return gated_library(tmp_path_factory, bf16=False)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _arr(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _rand(gen, *shape, scale=1.0):
    return (scale * torch.randn(shape, generator=gen)).contiguous()


def _elu(z):
    return torch.where(z > 0, z, torch.exp(torch.clamp(z, max=0.0)) - 1.0)


def _shift(x, dy, dx):
    """``x [B, H, W, C]`` read at (y + dy, x + dx), zero off the grid."""
    b, h, w, c = x.shape
    out = torch.zeros_like(x)
    ys, yd = slice(max(dy, 0), min(h, h + dy)), slice(max(-dy, 0), min(h, h - dy))
    xs, xd = slice(max(dx, 0), min(w, w + dx)), slice(max(-dx, 0), min(w, w - dx))
    out[:, yd, xd] = x[:, ys, xs]
    return out


def _operand(src, mode, grid, mask=None, keep=1.0):
    """A term's source through concat_elu and the mask, ``[B, H, W, K]``."""
    x = src.reshape(*grid, -1)
    if mode == A_IDENT:
        return x
    x = torch.cat([_elu(x), _elu(-x)], -1)
    return x * mask * (1.0 / keep) if mode == A_CELU_DROP else x


def _close(got, want, what):
    err = (got - want).abs().max().item()
    assert err / max(1.0, want.abs().max().item()) <= TOL, (what, err)


def _close_all(pairs):
    for what, got, want in pairs:
        _close(got, want, what)


SEED, BLOCK_ID, KEEP = 1234, 7, 0.5
kBM_ROWS = 64   # rows of a tile (gated_common.cuh kBM)


# Each epilogue at the N it runs at in the chain: conv_a and an aux term
# (E_BIAS, N = F), conv_b with dropout, gate and residual (E_GATE, 2F), the
# transposed conv_b and conv_a products with concat_elu's derivative
# (E_CELU_BWD, trans B, with and without dropout); 4 x 4 images and the
# ragged 3 x 5 (30 rows of a 64-row tile); at 128 filters and at 64.
_GEMM_CASES = [("bias", 4, 4), ("bias", 3, 5), ("gate_drop", 4, 4), ("gate_drop", 3, 5),
               ("celu_bwd", 4, 4), ("celu_bwd_drop", 3, 5)]


@pytest.mark.parametrize("F,case,h,w", [
    *(pytest.param(128, *c, id="-".join(map(str, c))) for c in _GEMM_CASES),
    *(pytest.param(64, *c, id="f64-" + "-".join(map(str, c))) for c in _GEMM_CASES),
])
def test_emulated_data_gemm_matches_plain(emu, F, case, h, w):
    gen = torch.Generator().manual_seed(sum(map(ord, case)) * 100 + 10 * h + w + F)
    b = 2
    grid, R = (b, h, w), b * h * w
    key = gc.stream_key(SEED, BLOCK_ID)
    mask = gc.dropout_keep_mask(SEED, BLOCK_ID, b, h, w, 2 * F, KEEP)
    drop = case in ("gate_drop", "celu_bwd_drop")
    keep = KEEP if drop else 1.0
    s = 0.05
    if case == "bias":
        N, epi, mode = F, E_BIAS, A_CELU
        x, aux = _rand(gen, R, F), _rand(gen, R, F)
        taps = [(-1, 0), (0, -1)]
        srcs = [x, x, aux]
        ws = [_rand(gen, 2 * F, F, scale=s) for _ in range(3)]
        terms = [(F, 2 * F, mode, dy, dx, F, 0) for dy, dx in taps] + [(F, 2 * F, mode, 0, 0,
                                                                       F, 0)]
    elif case == "gate_drop":
        N, epi, mode = 2 * F, E_GATE, A_CELU_DROP
        a1 = _rand(gen, R, F)
        taps = [(-1, -1), (-1, 0), (0, 0)]
        srcs = [a1] * 3
        ws = [_rand(gen, 2 * F, 2 * F, scale=s) for _ in taps]
        terms = [(F, 2 * F, mode, dy, dx, 2 * F, 0) for dy, dx in taps]
    else:
        N, epi, mode = 2 * F, E_CELU_BWD, A_IDENT
        c = 2 * F if case == "celu_bwd" else F   # db1 [R, 2F] or da1 [R, F]
        src = _rand(gen, R, c)
        taps = [(1, 0), (0, 1), (1, 1)]
        srcs = [src] * 3
        ws = [_rand(gen, 2 * F, c, scale=s) for _ in taps]   # B(k, n) = w[n, k]
        terms = [(c, c, mode, dy, dx, c, 1) for dy, dx in taps]
    bias = _rand(gen, N, scale=s) if epi != E_CELU_BWD else None
    proj = _rand(gen, b, N) if epi == E_GATE else None
    xres = _rand(gen, R, F) if epi == E_GATE else None
    z = _rand(gen, R, F) if epi == E_CELU_BWD else None
    base1 = _rand(gen, R, F) if epi == E_CELU_BWD else None
    base2 = _rand(gen, R, F) if case == "celu_bwd" else None
    out = torch.full((R, N if epi != E_CELU_BWD else F), float("nan"))
    out2 = torch.full((R, F), float("nan")) if epi == E_GATE else None
    ints = (ctypes.c_int * (7 * len(terms)))(*[v for t in terms for v in t])
    assert emu.emu_data_gemm(
        N, b, h, w, len(terms), _arr(srcs), _arr(ws), ints, key, gc.keep_threshold(keep),
        1.0 / keep, int(drop), epi, _ptr(bias), _ptr(proj), _ptr(xres), _ptr(z),
        _ptr(base1), _ptr(base2), _ptr(out), _ptr(out2), int(epi != E_CELU_BWD), 0) == 0

    acc = torch.zeros(R, N)
    for src, wt, (_, _, md, dy, dx, _, trans) in zip(srcs, ws, terms):
        a = _shift(_operand(src, md, grid, mask, keep), dy, dx).reshape(R, -1)
        acc = acc + a @ (wt.T if trans else wt)
    img = torch.arange(R) // (h * w)
    if epi == E_BIAS:
        _close(out, acc + bias, "out")
    elif epi == E_GATE:
        b1 = acc + bias + proj[img]
        _close_all([("out", out, b1), ("out2", out2, xres + torch.sigmoid(b1[:, F:]) * b1[:, :F])])
    else:
        g = acc * mask.reshape(R, 2 * F) / keep if drop else acc
        dpos = torch.where(z > 0, torch.ones_like(z), torch.exp(z))
        dneg = torch.where(-z > 0, torch.ones_like(z), torch.exp(-z))
        want = base1 + (base2 if base2 is not None else 0.0) + g[:, :F] * dpos - g[:, F:] * dneg
        _close(out, want, "out")

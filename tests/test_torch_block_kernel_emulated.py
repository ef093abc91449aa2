"""The block chain's kernels (``csrc/block_chain_fwd.cu`` and
``block_chain_bwd.cu`` on the GEMM core ``csrc/vdvae_gemm.cuh``), emulated
on the CPU, against ``block_chain_plain`` and its autograd.

Each source is compiled with ``g++`` against ``tests/cuda_emulation`` and
its C entry point (``pm_block_chain_fwd`` / ``pm_block_chain_bwd``) is
called on CPU tensors, as the wrappers call it on the card: every launch of
the run (c1..c4 and their data gradients, the wide products' column tiles,
the two weight-gradient launches, the split sums and the bias sums) runs
block by block, each block as one thread per CUDA thread, ``mma.sync``
m16n8k8 TF32 emulated warp by warp (see
``test_torch_decoder_kernel_emulated.py``, whose rewriting of the core this
test reuses). Each source is built twice: with the fewest rows a split sums
set to 32, so that a toy run of 70 or 80 rows cuts its weight gradients
into two splits (its products on 16-row tiles, the last ragged), and
"wide", with one block taken to fill a wave, so that a toy run's products
take 64-row tiles (ragged) while its weight gradients sum all rows in one
split. The cases hold a non-square 7 x 5 image with 3 x 3 taps at every
border and 1 x 1 runs (k = 1, where the c2/c3 weight gradients join the
c1/c4 launch), at both geometries the kernels are built for. Tolerance as
on the GPU: 1e-4 of each tensor's scale. Skips where no C++20 compiler is
found.

The bf16 builds' cases are ``test_torch_block_kernel_bf16_emulated.py``'s
(a file of their own, so that the suite's workers build and run the two
dtypes side by side), with the bars defined here: the bf16 builds
(``-DPM_CORE_BF16=1``: c1..c3 and their gradients as
``mma.sync`` m16n8k16 bf16 products, emulated by the same layout rules) are
built once each, with the fewest rows a split sums set to 32, and held
against the bf16 plain version on a 3 x 3 run of MNIST's (192, 48) and a
1 x 1 run of digits16's (64, 16). Both sides round the same float32 values
to bf16, but their float32 sums differ in order, so a save that lies within
that difference of a bf16 rounding boundary rounds the other way (one ulp,
2^-8 of its value) and the backward, which reads the saves, carries the
difference on. Hence three checks: the forward's outputs within BF16_TOL of
each tensor's scale (at most BF16_SHARE of the elements beyond 1e-4 of it)
and its saves equal but for at most SAVE_FLIPS of their elements; the
backward kernel against the plain backward fed the kernel's
own saves (``bf16_chain_bwd``) at the forward's bar; and the whole against
autograd through ``block_chain_plain`` within END_TOL of scale, the room a
flipped save's effect takes (2.3e-3 at most in these cases).
"""
import ctypes

import pytest
import torch

from posterior_matching_torch.ops import block_chain as bc
from test_torch_decoder_kernel_emulated import _call, _close, _nan, compile_builds, \
    emulated_sources
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
SOURCES = ("block_chain_fwd.cu", "block_chain_bwd.cu")
BUILDS = {"fwd_split": (SOURCES[0], ["-DPM_CORE_MIN_SPLIT_ROWS=32"]),
          "bwd_split": (SOURCES[1], ["-DPM_CORE_MIN_SPLIT_ROWS=32"]),
          "fwd_wide": (SOURCES[0], ["-DPM_CORE_WAVE_BLOCKS=1"]),
          "bwd_wide": (SOURCES[1], ["-DPM_CORE_WAVE_BLOCKS=1"]),
          "fwd_bf16": (SOURCES[0], ["-DPM_CORE_BF16=1", "-DPM_CORE_MIN_SPLIT_ROWS=32"]),
          "bwd_bf16": (SOURCES[1], ["-DPM_CORE_BF16=1", "-DPM_CORE_MIN_SPLIT_ROWS=32"])}
BF16_TOL = 5e-4
BF16_SHARE = 0.01
SAVE_FLIPS = 0.05
END_TOL = 1e-2


def block_libraries(tmp_path_factory, names):
    """The builds ``names`` of BUILDS compiled against the emulated sources,
    their entry points typed."""
    out = tmp_path_factory.mktemp("block_emulation")
    emulated_sources(out, ("block_chain_common.cuh", *SOURCES))
    libs = compile_builds(out, "block_harness.cpp", "BLOCK_SOURCE",
                          {n: BUILDS[n] for n in names})
    P, I = ctypes.c_void_p, ctypes.c_int
    for name in names:
        if name.startswith("fwd"):
            libs[name].pm_block_chain_fwd.argtypes = [P, I, P, I, P]
            libs[name].pm_block_chain_fwd.restype = I
        else:
            libs[name].pm_block_chain_bwd.argtypes = [P, I, P, I, P]
            libs[name].pm_block_chain_bwd.restype = I
            libs[name].pm_block_chain_bwd_part_floats.argtypes = [P, I]
            libs[name].pm_block_chain_bwd_part_floats.restype = ctypes.c_longlong
    return libs


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return block_libraries(tmp_path_factory, ("fwd_split", "bwd_split", "fwd_wide", "bwd_wide"))


def emulated_chain(fwd, bwd, cfg, x0, weights, g, runs):
    """The forward's outputs and the backward's gradients through the
    emulated entry points, the backward run ``runs`` times (a list of each
    run's gradients); and the floats of ``part`` the backward asked for."""
    L, R, c, m = cfg.n_levels, cfg.rows, cfg.c, cfg.mid
    outs = {"xout": _nan(L, R, c),
            **{h: _nan(L, R, m).to(cfg.cdtype) for h in ("h1", "h2", "h3")}}
    names = (*bc._FWD_PTRS, "hs") if cfg.bf16 else bc._FWD_PTRS
    _call(fwd.pm_block_chain_fwd, names, {"x0": x0, **weights, **outs, "hs": _nan(3, R, m)},
          cfg)
    ints = cfg.ints()
    part = bwd.pm_block_chain_bwd_part_floats(ints, len(ints))
    assert part >= 0
    out = []
    for _ in range(runs):
        grads = {"dx0": _nan(R, c), **{"d" + n: _nan(*s) for n, s in cfg.weight_shapes().items()}}
        scratch = {"dxs": _nan(L, R, c), "part": _nan(max(part, 1)),
                   **{"d" + h: _nan(L, R, m) for h in ("h1", "h2", "h3")}}
        _call(bwd.pm_block_chain_bwd, bc._BWD_PTRS,
              {"g": g, "x0": x0, **outs, **weights, **grads, **scratch}, cfg)
        out.append(grads)
    return outs, out, part


# (b, h, w, L, k, (width, mid), split): PM-VDVAE MNIST's (192, 48) at
# 2 x 7 x 5 (70 rows: 16-row tiles, the last ragged; the weight gradients in
# two splits) and at 4 x 1 x 1 (k = 1: one 64-row tile of 4 rows); digits16's
# (64, 16) at 2 x 7 x 5 (two 64-row tiles, the last of 6 rows; c1's K = 64
# four slabs, c4's N = 64 four column tiles) and at 80 x 1 x 1 (k = 1, two
# splits). The backward runs twice, bit for bit, but in the costliest case.
@pytest.mark.parametrize("b,h,w,L,k,geo,split", [
    (2, 7, 5, 2, 3, (192, 48), True), (4, 1, 1, 2, 1, (192, 48), False),
    (2, 7, 5, 2, 3, (64, 16), False), (80, 1, 1, 2, 1, (64, 16), True),
])
def test_emulated_block_chain_matches_autograd(emu, b, h, w, L, k, geo, split):
    c, m = geo
    gen = torch.Generator().manual_seed(b * 100 + h * 10 + k + c)
    x = torch.randn(b, h, w, c, generator=gen)
    weights = {n: (torch.randn((L, *s), generator=gen) * s[0] ** -0.5).contiguous()
               for n, s in bc.weight_shapes(c, m, k)}
    leaves = [x.requires_grad_(True), *(weights[n].requires_grad_(True) for n in bc.NAMES)]
    want = bc.block_chain_plain(x, weights, mid=m, k=k)
    cot = torch.randn(want.shape, generator=gen)
    grads_p = torch.autograd.grad(want, leaves, cot)

    cfg = bc.ChainConfig(x, L, m, k)
    R = cfg.rows
    flat = lambda t: t.detach().reshape(R, c).contiguous()
    kind = "split" if split else "wide"
    outs, grads, part = emulated_chain(emu[f"fwd_{kind}"], emu[f"bwd_{kind}"], cfg, flat(x),
                                       {n: weights[n].detach() for n in bc.NAMES}, flat(cot),
                                       1 if (c, k) == (192, 3) else 2)
    assert (part > 0) == split   # the weight gradients went through row splits
    _close(outs["xout"][-1], flat(want), "x_final")
    for name, gp in zip(("x0", *bc.NAMES), grads_p):
        key = "dx0" if name == "x0" else "d" + name
        got = grads[-1][key]
        _close(got.reshape(gp.shape), gp, name)
        assert torch.equal(grads[0][key], got), f"{name}: a relaunch changed the bits"


def _bf16_close(got, want, what, tol=BF16_TOL):
    err = (got - want).abs()
    scale = max(1.0, want.abs().max().item())
    share = (err > 1e-4 * scale).float().mean().item()
    assert err.max().item() / scale <= tol, (what, err.max().item() / scale)
    if tol == BF16_TOL:
        assert share <= BF16_SHARE, (what, share)


def _saves_close(got, want, what):
    """bf16 saves equal to ``want`` rounded but for at most SAVE_FLIPS of
    them, each within 2^-6 of the tensor's scale (a value rounded the
    other way, or a later product moved by an operand that was)."""
    got, want = got.float(), bc.round_bf16(want)
    assert (got != want).float().mean().item() <= SAVE_FLIPS, what
    assert (got - want).abs().max() <= 2.0 ** -6 * want.abs().max(), what

"""The decoder chain's kernels (``csrc/decoder_chain_fwd.cu`` and
``decoder_chain_bwd.cu`` on the GEMM core ``csrc/vdvae_gemm.cuh``),
emulated on the CPU, against ``dec_chain_plain`` and its autograd.

Each source is compiled with ``g++`` against ``tests/cuda_emulation`` and
its C entry point (``pm_decoder_chain_fwd`` / ``pm_decoder_chain_bwd``) is
called on CPU tensors, as the wrappers call it on the card: every launch of
the run (the grouped p / m / q products, the column tiles of the wide heads,
the z steps, the three weight-gradient kinds, the split sums and the bias
sums) runs block by block, each block as one thread per CUDA thread,
``mma.sync`` m16n8k8 TF32 emulated warp by warp by the PTX ISA's fragment
layout (its operands read as TF32), a ``cp.async`` copy landing at once.
That runs the core's row tiles (ragged), the 3x3 taps read from one staged
slab with its halo (masked at the image's borders), the 3xTF32 split, the B
ring across term, slab and tap boundaries and the row splits without a GPU;
the card's timing, memory model and PTX are left to the GPU tests. Each
source is built twice: with the fewest rows a split sums set to 32, so that
a toy run of 98 rows cuts its weight gradients into two splits (its products
on 16-row tiles), and "wide", with one block taken to fill a wave, so that a
toy run's products take 64-row tiles (the last one ragged) while its weight
gradients sum all its rows in one split (several 64-row chunks for 196
rows). Tolerance as on the GPU: 1e-4 of each tensor's scale. Skips where no
C++20 compiler is found.

The bf16 builds' cases are ``test_torch_decoder_kernel_bf16_emulated.py``'s
(a file of their own, so that the suite's workers build and run the two
dtypes side by side). The bf16 builds (``-DPM_CORE_BF16=1``) are built once
each, with the fewest
rows a split sums set to 32, and held against ``dec_chain_plain`` at bf16
on digits16's (64, 16, 8) at 2 x 7 x 7 with 3 x 3 taps and at 80 x 1 x 1
(k = 1), two levels each, with the checks and bars of
``test_torch_block_kernel_emulated.py``'s bf16 cases: the forward's
outputs and saves, the backward kernel against ``bf16_dec_chain_bwd`` fed
the kernel's saves, and the whole against autograd through the plain run.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from posterior_matching_torch.ops import _build, decoder_chain as dc
from test_torch_row_kernel_emulated import _replace_helpers, write_ptx_header
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

EMULATION = Path(__file__).resolve().parent / "cuda_emulation"
TOL = 1e-4
_SMEM = "extern __shared__ __align__(16) float smem[];"
_LAUNCH = "k<<<grid, threads, smem_bytes, stream>>>(args...);"
_EMU_LAUNCH = ("emu_launch_grid(grid.x, grid.y, grid.z, threads, threads, smem_bytes, "
               "[&] { k(args...); });")
SOURCES = ("decoder_chain_fwd.cu", "decoder_chain_bwd.cu")
# the builds: (source, extra flags); "wide" ones fill a wave with one
# block, so a toy run's products take 64-row tiles
BUILDS = {"fwd": (SOURCES[0], []), "bwd_split": (SOURCES[1], ["-DPM_CORE_MIN_SPLIT_ROWS=32"]),
          "fwd_wide": (SOURCES[0], ["-DPM_CORE_WAVE_BLOCKS=1"]),
          "bwd_wide": (SOURCES[1], ["-DPM_CORE_WAVE_BLOCKS=1"]),
          "fwd_bf16": (SOURCES[0], ["-DPM_CORE_BF16=1", "-DPM_CORE_MIN_SPLIT_ROWS=32"]),
          "bwd_bf16": (SOURCES[1], ["-DPM_CORE_BF16=1", "-DPM_CORE_MIN_SPLIT_ROWS=32"])}


def emulated_sources(out: Path, files=("decoder_chain_common.cuh", *SOURCES)):
    """Writes the chain sources ``files`` (the decoder's by default) and the
    GEMM core into ``out``, the core's PTX helpers replaced, its launches
    emulated and the dynamic shared memory the harness's array."""
    core = (_build.CSRC / "vdvae_gemm.cuh").read_text()
    assert core.count(_LAUNCH) == 1
    core = _replace_helpers(core.replace(_LAUNCH, _EMU_LAUNCH), "vdvae_gemm.cuh")
    (out / "vdvae_gemm.cuh").write_text(core.replace(_SMEM, ""))
    write_ptx_header(out)
    for name in files:
        text = (_build.CSRC / name).read_text()
        assert "<<<" not in text and "asm" not in text, name
        (out / name).write_text(text.replace(_SMEM, ""))


def compile_builds(out: Path, harness: str, macro: str, builds):
    """Compiles ``harness`` (in tests/cuda_emulation) once per build of
    ``builds`` ({name: (source, extra flags)}), the source named to it by
    ``macro``, against the emulated sources in ``out``, all at once; skips
    without a C++20 compiler. Returns the loaded libraries by build name."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the emulated kernels")
    procs = {}
    for name, (src, flags) in builds.items():
        lib = out / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [cxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-w",
             f'-D{macro}="{src}"', *flags,
             "-I", str(out), "-I", str(EMULATION), "-o", str(lib),
             str(EMULATION / harness)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode and "<barrier>" in log:
            pytest.skip("needs a C++20 standard library (<barrier>)")
        assert proc.returncode == 0, log[-4000:]
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def decoder_libraries(tmp_path_factory, names):
    """The builds ``names`` of BUILDS compiled against the emulated sources,
    their entry points typed."""
    out = tmp_path_factory.mktemp("decoder_emulation")
    emulated_sources(out)
    libs = compile_builds(out, "decoder_harness.cpp", "DECODER_SOURCE",
                          {n: BUILDS[n] for n in names})
    P, I = ctypes.c_void_p, ctypes.c_int
    for name in names:
        if name.startswith("fwd"):
            libs[name].pm_decoder_chain_fwd.argtypes = [P, I, P, I, P]
            libs[name].pm_decoder_chain_fwd.restype = I
        else:
            libs[name].pm_decoder_chain_bwd.argtypes = [P, I, P, I, P]
            libs[name].pm_decoder_chain_bwd.restype = I
            libs[name].pm_decoder_chain_bwd_part_floats.argtypes = [P, I]
            libs[name].pm_decoder_chain_bwd_part_floats.restype = ctypes.c_longlong
    return libs


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return decoder_libraries(tmp_path_factory, ("fwd", "bwd_split", "fwd_wide", "bwd_wide"))


def _call(fn, names, tensors, cfg):
    ptrs = (ctypes.c_void_p * len(names))(*[tensors[n].data_ptr() for n in names])
    ints = cfg.ints()
    assert fn(ptrs, len(names), ints, len(ints), None) == 0


def _nan(*shape):
    return torch.full(shape, float("nan"))


def _close(got, want, what):
    err = (got - want).abs().max().item()
    assert err / max(1.0, want.abs().max().item()) <= TOL, (what, err)


def emulated_chain(fwd, bwd, cfg, inputs, cots, runs):
    """The forward's outputs and the backward's gradients through the
    emulated entry points, the backward run `runs` times (a list of each
    run's gradients)."""
    shapes = cfg.shapes()
    L, R, c, m, ld = cfg.n_levels, cfg.rows, cfg.c, cfg.mid, cfg.ld
    outs = {n: _nan(*shapes[n]).to(cfg.dtype_of(n))
            for n in ("xout", "post", "prior", "masked", "u", *dc.SAVES)}
    names = (*dc._FWD_PTRS, "hs") if cfg.bf16 else dc._FWD_PTRS
    _call(fwd.pm_decoder_chain_fwd, names, {**inputs, **outs, "hs": _nan(12, R, m)}, cfg)
    ints = cfg.ints()
    part = bwd.pm_decoder_chain_bwd_part_floats(ints, len(ints))
    assert part >= 0
    out = []
    for _ in range(runs):
        grads = {"dx0": _nan(R, c), "dacts": _nan(R, c), "dmacts": _nan(R, c)}
        grads.update({"d" + n: _nan(*shapes[n]) for n in dc.NAMES})
        scratch = {"dxs": _nan(L, R, c), "dus": _nan(L, R, c), "dpost": _nan(L, R, 2 * ld),
                   "zs": _nan(L, R, ld), "part": _nan(max(part, 1))}
        scratch.update({"d" + s: _nan(L, R, m) for s in dc.SAVES})
        if cfg.bf16:   # the bf16 build rebuilds post and u into scratch
            scratch.update(post=_nan(*shapes["post"]), u=_nan(*shapes["u"]))
        _call(bwd.pm_decoder_chain_bwd, dc._BWD_PTRS,
              {**cots, **inputs, **outs, **grads, **scratch}, cfg)
        out.append(grads)
    return outs, out, part


def _case(seed, b, h, w, L, k, c, m, ld):
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s, scale=1.0: (scale * torch.randn(s, generator=gen)).contiguous()
    x0, acts, macts = (rnd(b, h, w, c) for _ in range(3))
    eps = rnd(L, b, h, w, ld)
    weights = {n: rnd(L, *s, scale=s[0] ** -0.5) for n, s in dc.weight_shapes(c, c, m, ld, k)}
    return x0, acts, macts, eps, weights, gen


# (b, h, w, L, k, geometry, split): PM-VDVAE MNIST's (192, 48, 16) at
# 2 x 7 x 7 (98 rows: 16-row tiles, the last ragged; 3x3 taps at every
# border; the weight gradients in two row splits) and at 4 x 1 x 1 (1x1
# taps, one 64-row tile of 4 rows, two levels); digits16's (64, 16, 8) at
# 2 x 7 x 7 (its 44-wide masked head a column tile of 48 with 4 masked; two
# levels, two row splits) and at 4 x 7 x 7 (64-row tiles, the last ragged;
# 196 rows a split: four 64-row chunks through the weight gradients'
# ring). The backward runs twice, bit for bit, but in the costliest case.
@pytest.mark.parametrize("b,h,w,L,k,geo,split", [
    (2, 7, 7, 1, 3, (192, 48, 16), True), (4, 1, 1, 2, 1, (192, 48, 16), False),
    (2, 7, 7, 2, 3, (64, 16, 8), True), (4, 7, 7, 1, 3, (64, 16, 8), False),
])
def test_emulated_decoder_chain_matches_autograd(emu, b, h, w, L, k, geo, split):
    c, m, ld = geo
    x0, acts, macts, eps, weights, gen = _case(b * 100 + h * 10 + k + c, b, h, w, L, k, c, m, ld)
    leaves = [x0, acts, macts, *(weights[n] for n in dc.NAMES)]
    for t in leaves:
        t.requires_grad_(True)
    want = dc.dec_chain_plain(x0, acts, macts, eps, weights, ld=ld, k=k)
    cot = [torch.randn(t.shape, generator=gen) for t in want]
    grads_p = torch.autograd.grad(want, leaves, cot)

    cfg = dc.DecConfig(x0, acts, L, m, ld, k)
    R = cfg.rows
    flat = lambda t: t.detach().reshape(R, t.shape[-1]).contiguous()
    lvl = lambda t: t.detach().reshape(L, R, t.shape[-1]).contiguous()
    inputs = {"x0": flat(x0), "acts": flat(acts), "macts": flat(macts), "eps": lvl(eps),
              **{n: weights[n].detach().contiguous() for n in dc.NAMES}}
    cots = {"g": flat(cot[0]), "gpost": lvl(cot[1]), "gprior": lvl(cot[2]),
            "gmask": lvl(cot[3])}
    mnist_3x3 = (h, k, c) == (7, 3, 192)
    fwd, bwd = ("fwd", "bwd_split") if split else ("fwd_wide", "bwd_wide")
    outs, grads, part = emulated_chain(emu[fwd], emu[bwd], cfg, inputs, cots,
                                       1 if mnist_3x3 else 2)
    assert (part > 0) == split   # the weight gradients went through row splits
    for name, got, ref in zip(("x_final", "post", "prior", "masked"),
                              (outs["xout"][-1], outs["post"], outs["prior"], outs["masked"]),
                              want):
        _close(got, flat(ref) if name == "x_final" else lvl(ref), name)
    for name, gp, t in zip(("x0", "acts", "macts", *dc.NAMES), grads_p, leaves):
        key = {"x0": "dx0", "acts": "dacts", "macts": "dmacts"}.get(name, "d" + name)
        got = grads[-1][key]
        _close(got.reshape(gp.shape), gp, name)
        assert torch.equal(grads[0][key], got), f"{name}: a relaunch changed the bits"

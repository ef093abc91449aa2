"""The gated chain's six entry points (``csrc/gated_stream_{fwd,bwd}.cu``,
``csrc/gated_levels_{fwd,bwd}.cu``: the stream, the pair and the segment),
emulated on the CPU whole, through the port's own wrappers and autograd
Functions, against the plain versions.

Every ``<<<...>>>`` launch of the sources is turned into a call of
``tests/cuda_emulation``'s ``emu_launch_grid`` and each source compiled with
``g++`` into its own library (``gated_chain_harness.cpp``), as the card's
``nvcc`` builds it; the wrappers (:mod:`posterior_matching_torch.ops.
gated_chain`) then run on CPU tensors with their device test, their kernel
loader and their CUDA stream replaced. That runs the launch sequences of
``gated_levels.cuh`` — the pointer lists, the level strides of the
stream's stacks, the carries between levels and how each mode rounds them,
the epilogues' outputs in the compute dtype — without a GPU, at 64 filters
on 2 x 4 x 4 grids, a 2-level up pass and a 2-level down pass with skips,
keep 0.5 (the kernels' dropout hash, which the plain version draws too).

bf16 (the ``_bf16`` builds) against :class:`~posterior_matching_torch.ops.
gated_chain.Bf16Levels` (the stream's carries rounded, the segment's
float32, the pair's one level): kernel and plain round the same float32
sums, which their order and concat_elu's ``exp`` may put one float32 ulp
apart, so a rounded value may land one bf16 ulp (2^-8) away, and a flip
carries into the next products. Outputs and every gradient are held to
1e-2 of their scale (tighter than the JAX package's bf16 gradient
tolerance, 2e-2, ``tests/test_gated_chain.py:357``) and their mean error to
1e-4 of scale (most come out equal: a few dozen products of bf16 values
sum exactly in float32 in any order); the stream's relaunch is equal bit
for bit. The float32 builds (their carries moved into scratch of their
own) against the plain float32 version at 1e-4 of scale, the GPU tests'
bound: those cases are ``test_torch_gated_chain_f32_emulated.py``'s, which
builds the float32 libraries, so that the suite's workers (``--dist
loadfile``) build and run the two dtypes side by side. Skips where no C++20
compiler is found.
"""
import re

import pytest
import torch

from posterior_matching_torch.ops import _build, gated_chain as gc
from test_torch_decoder_kernel_emulated import compile_builds
from test_torch_row_kernel_emulated import _replace_helpers, write_ptx_header
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SOURCES = ("gated_stream_fwd.cu", "gated_stream_bwd.cu", "gated_levels_fwd.cu",
           "gated_levels_bwd.cu")
_SMEM = "extern __shared__ __align__(16) float smem[];"
F, B, H, W, CD, L, KEEP, SEED = 64, 2, 4, 4, 16, 2, 0.5, 11
TOL_BF, MEAN_BF, TOL_F32 = 1e-2, 1e-4, 1e-4


def _top_split(text: str):
    """``text`` split at its commas outside brackets."""
    parts, depth, cur = [], 0, ""
    for ch in text:
        depth += ch in "([<{" and 1 or 0
        depth -= ch in ")]>}" and 1 or 0
        if ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    return [*parts, cur]


def emulate_launches(src: str) -> str:
    """Each ``k<<<grid, threads, smem, stream>>>(args);`` of ``src`` as a
    synchronous ``emu_launch_grid`` over the same grid."""
    out, pos = [], 0
    for m in re.finditer(r"<<<", src):
        if m.start() < pos:
            continue
        start = src.rfind("\n", 0, m.start()) + 1
        indent = len(src[start:]) - len(src[start:].lstrip())
        kernel = src[start + indent: m.start()]
        end_cfg = src.index(">>>(", m.end())
        grid, threads, smem, _ = _top_split(src[m.end(): end_cfg])
        depth, i = 0, end_cfg + 3
        while True:
            depth += {"(": 1, ")": -1}.get(src[i], 0)
            if depth == 0:
                break
            i += 1
        args = src[end_cfg + 4: i]
        assert src[i + 1] == ";", src[start: i + 2]
        out.append(src[pos:start])
        out.append(f"{' ' * indent}{{ const dim3 g_ = dim3({grid}); "
                   f"emu_launch_grid(g_.x, g_.y, g_.z, {threads}, {threads}, {smem}, "
                   f"[&] {{ {kernel}({args}); }}); }}")
        pos = i + 2
    return "".join(out) + src[pos:]


def chain_libraries(tmp_path_factory, bf16: bool):
    """The gated sources with their launches emulated, compiled: the four
    ``_bf16`` builds, or the two float32 builds of the pair and segment
    sources (the float32 stream's are the GPU tests')."""
    out = tmp_path_factory.mktemp("gated_chain_emulation")
    write_ptx_header(out)
    for name in ("gated_common.cuh", "gated_levels.cuh", *SOURCES):
        text = emulate_launches((_build.CSRC / name).read_text())
        assert "<<<" not in text
        (out / name).write_text(_replace_helpers(text, name).replace(_SMEM, ""))
    builds = {}
    for src in SOURCES:
        stem = src.removesuffix(".cu")
        if bf16:
            builds[stem + "_bf16"] = (src, ["-DPM_CORE_BF16=1"])
        elif stem.startswith("gated_levels"):
            builds[stem] = (src, [])
    return compile_builds(out, "gated_chain_harness.cpp", "GATED_SOURCE", builds)


@pytest.fixture(scope="module")
def chain_libs(tmp_path_factory):
    return chain_libraries(tmp_path_factory, bf16=True)


@pytest.fixture
def emulated(chain_libs, monkeypatch):
    """The wrappers run the emulated libraries on CPU tensors."""
    monkeypatch.setattr(_build, "on_cpu", lambda tensors: False)
    monkeypatch.setattr(_build, "load", lambda name: chain_libs[name])

    def check_all(tensors, shapes, cfg):
        for name, shape in shapes.items():
            assert tensors.get(name) is not None, name
            _build.check(name, tensors[name], shape, cfg.dtype(name))

    monkeypatch.setattr(gc, "_check_all", check_all)

    class _Stream:
        cuda_stream = None

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())


def _case(down: bool, seed: int):
    gen = torch.Generator().manual_seed(seed)
    taps = gc.chain_taps()
    shapes = gc.weight_shapes(F, CD, *taps, down)
    rnd = lambda *s, scale=1.0: (scale * torch.randn(s, generator=gen)).requires_grad_(True)
    ws = [{n: rnd(*s, scale=0.1 if len(s) == 1 else s[0] ** -0.5) for n, s in shapes}
          for _ in range(L)]
    act = lambda: rnd(B, H, W, F).to(torch.bfloat16).detach().requires_grad_(True)
    xv, xh, cond = act(), act(), rnd(B, CD)
    sk = [(act(), act()) for _ in range(L)] if down else None
    return xv, xh, sk, cond, ws


def _leaves(xv, xh, sk, cond, ws):
    return [xv, xh, cond, *(t for pair in (sk or ()) for t in pair),
            *(t for w in ws for t in w.values())]


def _run(mode, plain, case, dtype, base):
    """Outputs and gradients of one mode's call (``plain``: the plain
    version) for a fixed loss of every level output."""
    xv, xh, sk, cond, ws = case
    kw = dict(keep=KEEP, seed=SEED, compute_dtype=dtype)
    if mode == "stream":
        w = gc.stack_levels(ws)
        skips = None if sk is None else tuple(torch.stack([p[i] for p in sk]) for i in (0, 1))
        fn = gc.gated_stream_plain if plain else gc.gated_stream
        ov, oh = fn(xv, xh, skips, cond, w, base_pair=base, **kw)
        outs = [t for l in range(L) for t in (ov[l], oh[l])]
    elif mode == "pair":
        fn = gc.gated_pair_plain if plain else gc.gated_pair
        outs = list(fn(xv, xh, sk and sk[0], cond, ws[0], pair_index=base, **kw))
    else:
        fn = gc.gated_segment_plain if plain else gc.gated_segment
        outs = [t for pair in fn(xv, xh, sk, cond, ws, base_pair=base, **kw) for t in pair]
    if mode == "pair":
        leaves = [xv, xh, cond, *(sk[0] if sk else ()), *ws[0].values()]
    else:
        leaves = _leaves(*case)
    loss = sum((torch.sin(o.float()) * (0.5 + i)).sum() for i, o in enumerate(outs))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [o.detach().float() for o in outs], [g.float() for g in grads]


def _held(got, want, tol, mean_tol, what):
    for i, (a, b) in enumerate(zip(got, want)):
        scale = max(1e-6, b.abs().max().item())
        err = (a - b).abs()
        assert err.max().item() <= tol * scale, (what, i, err.max().item() / scale)
        assert err.mean().item() <= mean_tol * scale, (what, i, err.mean().item() / scale)


@pytest.mark.parametrize("mode,down", [("stream", False), ("stream", True), ("pair", True),
                                       ("segment", True)])
def test_bf16_chain_kernels_match_plain(emulated, mode, down):
    case = _case(down, seed=5 + down)
    base = L if down else 0
    got_o, got_g = _run(mode, False, case, torch.bfloat16, base)
    want_o, want_g = _run(mode, True, case, torch.bfloat16, base)
    _held(got_o, want_o, TOL_BF, MEAN_BF, f"{mode} outputs")
    _held(got_g, want_g, TOL_BF, MEAN_BF, f"{mode} gradients")
    if mode == "stream" and down:
        again_o, again_g = _run(mode, False, case, torch.bfloat16, base)
        assert all(torch.equal(a, b) for a, b in zip(got_o + got_g, again_o + again_g)), \
            f"{mode}: a relaunch differs"

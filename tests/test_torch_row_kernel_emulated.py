"""The row sampler's CUDA kernel (``csrc/sampler_row.cu``), emulated on the CPU,
against its plain version.

The kernel's source is compiled with ``g++`` against a stand-in for the CUDA
runtime (``tests/cuda_emulation``): each block runs as one thread per CUDA
thread, the PTX helpers of ``sampler_common.cuh`` (mbarriers, bulk copies,
shared-memory loads, the consumers' named barrier) become calls into the
stand-in. That runs the kernel's own
indexing, split-K reduction, ragged blocks and weight ring (the producer
warp, the slots' parities across GEMM, level and pixel boundaries) without a
GPU; the card's timing, memory model and PTX are left to the GPU tests.
Both built widths (128 filters and digits16's 64, whose gathers and
epilogues use half the consumer threads) and both logits chunks (256
columns, or 128 where K is an odd multiple of 128) run. The tolerance is
the card's: samples equal, the rest 1e-4 of the tensor's scale. The bf16
build's cases are ``test_torch_row_kernel_bf16_emulated.py``'s (a file of
their own, so that the suite's workers run the two builds side by side).
The build compiles once for the module. Skips where no C++20 compiler is
found.
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from posterior_matching_torch.models.pixelcnn import PixelCNN
from posterior_matching_torch.ops import _build, sampler_chain as sc
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

EMULATION = Path(__file__).resolve().parent / "cuda_emulation"
TOL = 1e-4

# The PTX helpers of csrc/sampler_common.cuh, csrc/gated_common.cuh and the
# kernels, by name, and the emulated body of each.
_HELPERS = {
    "mbar_init": "emu_mbar_init(bar, count);",
    "mbar_fence_init": "",
    "mbar_arrive": "emu_arrive(bar);",
    "mbar_expect_tx": "emu_expect_tx(bar, bytes);",
    "mbar_try_wait": "return emu_try_wait(bar, parity);",
    "bulk_g2s": "emu_bulk(dst, src, bytes, bar);",
    "consumers_sync": "emu_consumer_sync();",
    "lds4": "return *reinterpret_cast<const float4*>(g_smem_base + addr);",
    "fence_proxy_async": "",
    "mma_tf32": "emu_mma_tf32(d, a, b);",
    "mma_bf16": "emu_mma_bf16(d, a, b);",
    "pack_bf16": "return emu_pack_bf16(lo, hi);",
    "cp_async16": "emu_cp_async16(dst, src, bytes);",
    "cp_async4": "emu_cp_async4(dst, src, bytes);",
    "cp_async_commit": "",
    "cp_async_wait_ring": "",
}


def _replace_helpers(src: str, what: str) -> str:
    """``src`` with the body of each helper it defines replaced; raises if
    inline PTX is left."""
    for name, body in _HELPERS.items():
        pattern = r"(__device__ __forceinline__ \w+ " + name + r"\([^)]*\) \{).*?\n\}\n"
        src, count = re.subn(pattern, lambda m: m.group(1) + " " + body + " }\n", src,
                             flags=re.S)
        if count > 1:
            raise ValueError(f"{what} has {count} definitions of {name}")
    if "asm" in src:
        raise ValueError(f"{what} has inline PTX the emulation does not replace")
    return src


def write_ptx_header(out: Path):
    """Writes ``ptx_mma.cuh``, which every kernel includes, into ``out``
    with its PTX helpers replaced."""
    (out / "ptx_mma.cuh").write_text(
        _replace_helpers((_build.CSRC / "ptx_mma.cuh").read_text(), "ptx_mma.cuh"))


def emulated_header(src: str) -> str:
    """``sampler_common.cuh`` with its PTX helpers replaced."""
    return _replace_helpers(src, "sampler_common.cuh")


def emulated_source(src: str, entry: str = "pm_sampler_row") -> str:
    """A kernel source without its C entry point, its PTX helpers replaced
    and its dynamic shared memory a static array."""
    head, body = src[: src.index(f'extern "C" int {entry}')].split(
        '#include "sampler_common.cuh"', 1)
    src = head + '#include "sampler_common.cuh"' + _replace_helpers(body, entry)
    src = src.replace("extern __shared__ __align__(16) float smem[];", "")
    return src.replace("using namespace pmk;",
                       "using namespace pmk;\nalignas(64) float smem[232448 / 4];", 1)


def build_emulation(out: Path, kernel: str, entry: str, harness: str,
                    defines=()) -> Path:
    """Compiles ``harness`` (in tests/cuda_emulation) against the emulated
    ``kernel`` source and header in ``out``, with the preprocessor
    ``defines`` (e.g. ``-DPM_CORE_BF16=1``); skips without a C++20
    compiler. Returns the shared library."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the emulated kernel")
    write_ptx_header(out)
    (out / "sampler_common.cuh").write_text(
        emulated_header((_build.CSRC / "sampler_common.cuh").read_text()))
    stem = kernel.removesuffix(".cu")
    (out / f"{stem}_emulated.cpp").write_text(
        emulated_source((_build.CSRC / kernel).read_text(), entry))
    lib = out / f"lib{stem}_emulated.so"
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-w", *defines,
         "-I", str(out), "-I", str(EMULATION),
         "-o", str(lib), str(EMULATION / harness)],
        capture_output=True, text=True,
    )
    if proc.returncode and "<barrier>" in proc.stderr:
        pytest.skip("needs a C++20 standard library (<barrier>)")
    assert proc.returncode == 0, proc.stderr[-4000:]
    return lib


def _load_row(tmp_path_factory, defines=()):
    lib = build_emulation(tmp_path_factory.mktemp("row_emulation"), "sampler_row.cu",
                          "pm_sampler_row", "row_harness.cpp", defines)
    cdll = ctypes.CDLL(str(lib))
    cdll.emu_sampler_row.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 6
    cdll.emu_sampler_row.restype = ctypes.c_int
    return cdll


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return _load_row(tmp_path_factory)



def _rand(gen, *shape, scale=1.0):
    return (scale * torch.randn(shape, generator=gen)).contiguous()


def _close(got, want):
    err = (got - want).abs().max().item()
    return err / max(1.0, want.abs().max().item()) <= TOL


# One column; a ragged block of 5; two blocks (the second ragged) at full
# depth, where the ring wraps at every GEMM, level and pixel boundary; a
# full block with two logits chunks; 128-column chunks (K = 128, 384). At 64
# filters: digits16's row (W = 4, K = 128) at its depth (L = 12) with a
# ragged second block, one column, three 128-column chunks, two of 256.
@pytest.mark.parametrize("F,n_lvl,wid,n,k", [
    *(pytest.param(128, *c, id="-".join(map(str, c)))
      for c in ((2, 1, 3, 256), (4, 3, 5, 256), (24, 2, 13, 512), (4, 2, 16, 512))),
    *(pytest.param(128, *c, id="-".join(map(str, c))) for c in ((4, 2, 5, 128),)),
    *(pytest.param(64, *c, id="f64-" + "-".join(map(str, c)))
      for c in ((12, 4, 13, 128), (2, 1, 3, 128), (4, 2, 5, 384), (4, 3, 8, 512))),
])
def test_emulated_row_kernel_matches_plain(emu, F, n_lvl, wid, n, k):
    args = _inputs(F, n_lvl, wid, n, k)
    outh = torch.full_like(args[5], float("nan"))
    outm = torch.full_like(args[6], float("nan"))
    outs = torch.full((wid, n), -1, dtype=torch.int32)
    outl = torch.full((wid, n, k), float("nan"))
    assert emu.emu_sampler_row(
        *[a.data_ptr() for a in args], outh.data_ptr(), outm.data_ptr(),
        outs.data_ptr(), outl.data_ptr(), n_lvl, wid, n, k, F, 1) == 0
    want = sc.row_plain(*args, with_logits=True)
    torch.testing.assert_close(outs, want[2], rtol=0, atol=0)
    for got, ref in zip((outh, outm, outl), (want[0], want[1], want[3])):
        assert _close(got, ref)


def model_inputs(F, n_lvl, wid, n, k, lpg, seed=0):
    """Row 1's kernel arguments at bf16 for a seeded PixelCNN of these shapes
    (the port's initialisation, a 16-wide condition), row 0 through the
    plain version (``sampler_chain.row1_inputs``): the state a request's
    kernels see, and the inputs of the card's gate (random tensors at unit
    scale make one-ulp flips cascade through the plain version against
    itself summed in float64 too)."""
    torch.manual_seed(seed)
    pcnn = PixelCNN(num_indices=k, image_shape=(2, wid), dropout=0.0,
                    num_resnet=n_lvl // 2, num_filters=F, conditional_dim=16)
    gen = torch.Generator().manual_seed(seed)
    cond = torch.randn(n, 16, generator=gen)
    return sc.row1_inputs(pcnn, cond, n, gen, "bfloat16", lpg)


def _inputs(F, n_lvl, wid, n, k, s=0.05):
    gen = torch.Generator().manual_seed(1000 * n_lvl + 100 * wid + n)
    return (
        _rand(gen, n_lvl, 12 * F, F, scale=s), _rand(gen, n_lvl, F, scale=s),
        _rand(gen, n_lvl, 8 * F, 2 * F, scale=s), _rand(gen, n_lvl, 2 * F, scale=s),
        _rand(gen, n_lvl, n, 2 * F),
        _rand(gen, n_lvl, wid, n, F), _rand(gen, n_lvl, wid, n, 2 * F),
        _rand(gen, n_lvl, wid, n, F), _rand(gen, wid, n, F), _rand(gen, wid, n, F),
        sc.gumbel_noise((wid, n, k), gen, "cpu"),
        _rand(gen, k, F, scale=s), _rand(gen, F, k, scale=s), _rand(gen, k, scale=s),
        _rand(gen, 2 * F, F, scale=s), _rand(gen, F, scale=s),
    )


def test_emulation_replaces_every_ptx_helper():
    header = (_build.CSRC / "sampler_common.cuh").read_text()
    assert "asm volatile" in header and "asm" not in emulated_header(header)
    for kernel, entry in (("sampler_row.cu", "pm_sampler_row"),
                          ("sampler_vrow.cu", "pm_sampler_vrow")):
        src = (_build.CSRC / kernel).read_text()
        assert "asm" not in emulated_source(src, entry).split("sampler_common.cuh")[1]
    # the one header of the PTX helpers: every helper with inline PTX has an
    # emulated body, and none is defined again where the kernels include it
    ptx = (_build.CSRC / "ptx_mma.cuh").read_text()
    assert "asm(" in ptx and "asm volatile" in ptx
    emulated = _replace_helpers(ptx, "ptx_mma.cuh")
    helpers = ("mma_tf32", "mma_bf16", "pack_bf16", "cp_async16", "cp_async4",
               "cp_async_commit", "cp_async_wait_ring")
    for helper in helpers:
        assert f"emu_{helper}(" in emulated or _HELPERS[helper] == "", helper
        assert re.search(r"\b" + helper + r"\(", ptx), helper
    for name in ("gated_common.cuh", "gated_levels.cuh", "vdvae_gemm.cuh", "vq_search.cu",
                 "sampler_common.cuh"):
        src = (_build.CSRC / name).read_text()
        assert '#include "ptx_mma.cuh"' in src or '#include "gated_common.cuh"' in src, name
        assert "asm(" not in src, name
        for helper in (*helpers, "to_tf32", "split_tf32", "smem_u32"):
            assert not re.search(r"__device__ __forceinline__ \w+ " + helper + r"\(", src), (
                name, helper)

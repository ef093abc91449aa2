"""The row sampler's CUDA kernel (``csrc/sampler_row.cu``), emulated on the CPU,
against its plain version.

The kernel's source is compiled with ``g++`` against a stand-in for the CUDA
runtime (``tests/cuda_emulation``): each block runs as one thread per CUDA
thread, the kernel's PTX helpers (mbarriers, bulk copies, the consumers'
named barrier) become calls into the stand-in. That runs the kernel's own
indexing, split-K reduction, ragged blocks and weight ring (the producer
warp, the slots' parities across GEMM, level and pixel boundaries) without a
GPU; the card's timing, memory model and PTX are left to the GPU tests.
Tolerance as there: samples equal, the rest 1e-4 of the tensor's scale.
Skips where no C++20 compiler is found.
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from posterior_matching_torch.ops import _build, sampler_chain as sc

EMULATION = Path(__file__).resolve().parent / "cuda_emulation"
F = sc.KERNEL_FILTERS
TOL = 1e-4

# The kernel's PTX helpers, by name, and the emulated body of each.
_HELPERS = {
    "mbar_init": "emu_mbar_init(bar, count);",
    "mbar_fence_init": "",
    "mbar_arrive": "emu_arrive(bar);",
    "mbar_expect_tx": "emu_expect_tx(bar, bytes);",
    "mbar_try_wait": "return emu_try_wait(bar, parity);",
    "bulk_g2s": "emu_bulk(dst, src, bytes, bar);",
    "consumers_sync": "emu_consumer_sync();",
}


def emulated_source(src: str) -> str:
    """The kernel without its C entry point, its PTX helpers replaced and its
    dynamic shared memory a static array."""
    src = src[: src.index('extern "C" int pm_sampler_row')]
    for name, body in _HELPERS.items():
        pattern = r"(__device__ __forceinline__ \w+ " + name + r"\([^)]*\) \{).*?\n\}\n"
        src, count = re.subn(pattern, lambda m: m.group(1) + " " + body + " }\n", src,
                             flags=re.S)
        if count != 1:
            raise ValueError(f"sampler_row.cu has {count} definitions of {name}")
    if "asm" in src.split('#include "sampler_common.cuh"')[1]:
        raise ValueError("sampler_row.cu has inline PTX the emulation does not replace")
    src = src.replace("extern __shared__ __align__(16) float smem[];", "")
    return src.replace("using namespace pmk;",
                       "using namespace pmk;\nalignas(64) float smem[232448 / 4];", 1)


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the emulated kernel")
    out = tmp_path_factory.mktemp("row_emulation")
    (out / "sampler_row_emulated.cpp").write_text(
        emulated_source((_build.CSRC / "sampler_row.cu").read_text()))
    lib = out / "librow_emulated.so"
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-w",
         "-I", str(EMULATION), "-I", str(out), "-I", str(_build.CSRC),
         "-o", str(lib), str(EMULATION / "row_harness.cpp")],
        capture_output=True, text=True,
    )
    if proc.returncode and "<barrier>" in proc.stderr:
        pytest.skip("needs a C++20 standard library (<barrier>)")
    assert proc.returncode == 0, proc.stderr[-4000:]
    cdll = ctypes.CDLL(str(lib))
    cdll.emu_sampler_row.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 4
    cdll.emu_sampler_row.restype = ctypes.c_int
    return cdll


def _rand(gen, *shape, scale=1.0):
    return (scale * torch.randn(shape, generator=gen)).contiguous()


def _close(got, want):
    err = (got - want).abs().max().item()
    return err / max(1.0, want.abs().max().item()) <= TOL


# One column; a ragged block of 5; two blocks (the second ragged) at full
# depth, where the ring wraps at every GEMM, level and pixel boundary; a
# full block with two logits chunks.
@pytest.mark.parametrize("n_lvl,wid,n,k", [
    (2, 1, 3, 256), (4, 3, 5, 256), (24, 2, 13, 512), (4, 2, 16, 512),
])
def test_emulated_row_kernel_matches_plain(emu, n_lvl, wid, n, k):
    gen = torch.Generator().manual_seed(1000 * n_lvl + 100 * wid + n)
    s = 0.05
    args = (
        _rand(gen, n_lvl, 12 * F, F, scale=s), _rand(gen, n_lvl, F, scale=s),
        _rand(gen, n_lvl, 8 * F, 2 * F, scale=s), _rand(gen, n_lvl, 2 * F, scale=s),
        _rand(gen, n_lvl, n, 2 * F),
        _rand(gen, n_lvl, wid, n, F), _rand(gen, n_lvl, wid, n, 2 * F),
        _rand(gen, n_lvl, wid, n, F), _rand(gen, wid, n, F), _rand(gen, wid, n, F),
        sc.gumbel_noise((wid, n, k), gen, "cpu"),
        _rand(gen, k, F, scale=s), _rand(gen, F, k, scale=s), _rand(gen, k, scale=s),
        _rand(gen, 2 * F, F, scale=s), _rand(gen, F, scale=s),
    )
    outh = torch.full_like(args[5], float("nan"))
    outm = torch.full_like(args[6], float("nan"))
    outs = torch.full((wid, n), -1, dtype=torch.int32)
    outl = torch.full((wid, n, k), float("nan"))
    assert emu.emu_sampler_row(
        *[a.data_ptr() for a in args], outh.data_ptr(), outm.data_ptr(),
        outs.data_ptr(), outl.data_ptr(), n_lvl, wid, n, k) == 0
    want = sc.row_plain(*args, with_logits=True)
    torch.testing.assert_close(outs, want[2], rtol=0, atol=0)
    for got, ref in zip((outh, outm, outl), (want[0], want[1], want[3])):
        assert _close(got, ref)


def test_emulation_replaces_every_ptx_helper():
    src = (_build.CSRC / "sampler_row.cu").read_text()
    out = emulated_source(src)
    assert "asm volatile" in src and "asm" not in out.split("sampler_common.cuh")[1]

"""The vertical-stack sampler's CUDA kernel (``csrc/sampler_vrow.cu``),
emulated on the CPU, against its plain version.

As ``test_torch_row_kernel_emulated.py`` does for the row kernel: the source
is compiled with ``g++`` against ``tests/cuda_emulation`` (each block as one
thread per CUDA thread, the PTX helpers of ``sampler_common.cuh`` replaced),
which runs the kernel's own operand builds (the zero halo rows, the
concat_elu sources), split-K reduction, ragged blocks and weight ring (three
slots, each refilled by the last warp done with its stage, whose parities
wrap across GEMM and level boundaries) without a GPU, at both built
widths (128 filters and digits16's 64, whose warps split their lanes
between two row groups). The tolerance is the card's: 1e-4 of the
tensor's scale. The bf16 build's cases are
``test_torch_vrow_kernel_bf16_emulated.py``'s. The build compiles once for
the module. Skips where no C++20 compiler is found.
"""
import ctypes

import pytest
import torch

from posterior_matching_torch.ops import sampler_chain as sc
from test_torch_row_kernel_emulated import build_emulation
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-4


def _load_vrow(tmp_path_factory, defines=()):
    lib = build_emulation(tmp_path_factory.mktemp("vrow_emulation"), "sampler_vrow.cu",
                          "pm_sampler_vrow", "vrow_harness.cpp", defines)
    cdll = ctypes.CDLL(str(lib))
    cdll.emu_sampler_vrow.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 4
    cdll.emu_sampler_vrow.restype = ctypes.c_int
    return cdll


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return _load_vrow(tmp_path_factory)



def _rand(gen, *shape, scale=1.0):
    return (scale * torch.randn(shape, generator=gen)).contiguous()


# Blocks of 6 samples at W = 7 (the last of three ragged, one sample); of 3
# at the flagship's W = 16 (the second ragged); 18 at W = 1; 7 at W = 5 over
# six levels; at 64 filters, 9 at digits16's W = 4 (the second block
# ragged) and the W = 7 and 16 blocks. L >= 4 runs up and down levels (the
# skip product); the ring's three slots wrap at every GEMM and level
# boundary.
@pytest.mark.parametrize("F,n_lvl,wid,n", [
    *(pytest.param(128, *c, id="-".join(map(str, c)))
      for c in ((4, 7, 13), (4, 16, 4), (2, 1, 3), (6, 5, 9))),
    *(pytest.param(64, *c, id="f64-" + "-".join(map(str, c)))
      for c in ((4, 4, 13), (2, 7, 9), (6, 16, 4))),
])
def test_emulated_vrow_kernel_matches_plain(emu, F, n_lvl, wid, n):
    gen = torch.Generator().manual_seed(1000 * n_lvl + 100 * wid + n)
    s = 0.05
    args = (
        _rand(gen, wid, n, F), _rand(gen, wid, n, F), _rand(gen, wid, n, F),
        _rand(gen, n_lvl, wid, n, F), _rand(gen, n_lvl, wid, n, 2 * F),
        _rand(gen, n_lvl, n, 2 * F),
        _rand(gen, 6 * F, F, scale=s), _rand(gen, F, scale=s),
        _rand(gen, 3 * F, F, scale=s), _rand(gen, F, scale=s),
        _rand(gen, n_lvl, 12 * F, F, scale=s), _rand(gen, n_lvl, F, scale=s),
        _rand(gen, n_lvl, 12 * F, 2 * F, scale=s), _rand(gen, n_lvl, 2 * F, scale=s),
        _rand(gen, n_lvl, 2 * F, F, scale=s),
    )
    outs = [torch.full_like(args[3], float("nan")), torch.full_like(args[4], float("nan")),
            torch.full_like(args[1], float("nan")), torch.full_like(args[1], float("nan"))]
    assert emu.emu_sampler_vrow(*[a.data_ptr() for a in args], *[o.data_ptr() for o in outs],
                                n_lvl, wid, n, F) == 0
    want = sc.vrow_plain(*args)
    for name, got, ref in zip(("outv", "outm", "v0", "hup"), outs, want):
        err = (got - ref).abs().max().item()
        assert err / max(1.0, ref.abs().max().item()) <= TOL, (name, err)

"""The codebook search kernel (``csrc/vq_search.cu``), emulated on the CPU,
against ``nearest_codebook_indices_plain``.

The source is compiled with ``g++`` against ``tests/cuda_emulation`` and its
C entry point ``pm_vq_search`` is called on CPU tensors, as the wrapper
calls it on the card: its one launch runs block by block, each block as one
thread per CUDA thread, ``mma.sync`` m16n8k8 TF32 emulated warp by warp (its
operands read as TF32), a ``cp.async`` copy landing at once. That runs the
row tiles, the code ring (a last chunk of 2 codes), the 3xTF32 split, the
norms taken from the B fragments and the argmax merges without a GPU; the
card's timing, memory model and PTX are left to the GPU tests. The build
takes a wave to be 4 blocks, so that toy sizes reach every row tile the
N-based choice picks: 128 rows (N > 384), 64 (193..384), 32 (97..192), 16
(below), and 32 or 16 at the 256-deep, 2-stage build for D > 64. Indices are compared exactly: the cases'
best scores lead the second by far more than float32 rounding, but in the
near-margin case, where the lead is 5e-5 of the score's scale (beyond the
error of 3xTF32, within that of one TF32 pass). Skips where no C++20
compiler is found.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from posterior_matching_torch.ops import _build
from posterior_matching_torch.ops.vq import nearest_codebook_indices_plain
from test_torch_row_kernel_emulated import _replace_helpers, write_ptx_header
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

EMULATION = Path(__file__).resolve().parent / "cuda_emulation"
_SMEM = "extern __shared__ __align__(16) float smem[];"
_KERNEL = "vq_search_kernel<MT, WR, WN, NS, DG>"
_LAUNCH = f"{_KERNEL}<<<grid, threads, smem_bytes, stream>>>(z, cb, out, N, K, D, vec);"
_EMU_LAUNCH = ("emu_launch_grid(grid.x, 1, 1, threads, threads, smem_bytes, "
               f"[&] {{ {_KERNEL}(z, cb, out, N, K, D, vec); }});")


def emulated_source(src: str) -> str:
    """``vq_search.cu`` with its PTX helpers replaced, its launch emulated and
    its dynamic shared memory the harness's array."""
    assert src.count(_LAUNCH) == 1 and src.count(_SMEM) == 1
    return _replace_helpers(src.replace(_LAUNCH, _EMU_LAUNCH), "vq_search.cu").replace(_SMEM, "")


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the emulated kernel")
    out = tmp_path_factory.mktemp("vq_emulation")
    (out / "vq_search.cu").write_text(emulated_source((_build.CSRC / "vq_search.cu").read_text()))
    write_ptx_header(out)
    lib = out / "libvq_emulated.so"
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-w",
         "-DPM_VQ_WAVE_BLOCKS=4", "-I", str(out), "-I", str(EMULATION), "-o", str(lib),
         str(EMULATION / "vq_harness.cpp")],
        capture_output=True, text=True)
    if proc.returncode and "<barrier>" in proc.stderr:
        pytest.skip("needs a C++20 standard library (<barrier>)")
    assert proc.returncode == 0, proc.stderr[-4000:]
    cdll = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    cdll.pm_vq_search.argtypes = [P, P, P, I, I, I, P]
    cdll.pm_vq_search.restype = I
    return cdll


def _search(emu, z, cb):
    out = torch.full((z.shape[0],), -1, dtype=torch.int32)
    assert emu.pm_vq_search(z.data_ptr(), cb.data_ptr(), out.data_ptr(), z.shape[0],
                            cb.shape[0], z.shape[1], None) == 0
    return out


def _scores64(z, cb):
    z, cb = z.double(), cb.double()
    return 2.0 * z @ cb.T - (cb * cb).sum(-1)


# (n, k, d): the row tile, N ragged in it, and the path each case reaches.
# K = 130 ends on a chunk of 2 codes (chunks of 64 or 128); rows near codes
# 128 and 129 make the last chunk win.
@pytest.mark.parametrize("n,k,d", [
    (400, 130, 64),   # 128-row tiles (warps of two m16 tiles), the last of 16 rows
    (300, 130, 16),   # 64-row tiles, the last of 44; D padded to 64
    (100, 130, 8),    # 32-row tiles, the last of 4
    (37, 130, 64),    # 16-row tiles (warps of one m16 tile), the last of 5
    (40, 70, 10),     # D % 4 != 0: 4-byte copies, scalar z loads
    (100, 70, 256),   # the widest D: 256 deep, a ring of 2 stages, 32-row tiles
    (20, 70, 200),    # 256 deep with 56 dims of padding, 16-row tiles
])
def test_emulated_search_matches_plain(emu, n, k, d):
    rng = np.random.RandomState(n * 1000 + k + d)
    cb = torch.from_numpy(rng.randn(k, d).astype(np.float32))
    z = torch.from_numpy(rng.randn(n, d).astype(np.float32))
    z[:4] = cb[[k - 1, k - 2, k - 1, 0]] + 0.1 * torch.from_numpy(
        rng.randn(4, d).astype(np.float32))
    want = nearest_codebook_indices_plain(z, cb)
    assert {k - 1, k - 2} <= set(want.tolist())
    got = _search(emu, z, cb)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# Codes k and k + shift equal, at 400 latents (128-row blocks: 4 code groups,
# chunks of 64 codes) and at 200 (64-row blocks: 8 code groups, chunks of
# 128): K / 2 apart (the plain version's case: other chunks, other lanes),
# one chunk apart (64, 128: the same lane and column, the lane's own walk),
# 16 (the next code group of warps: the merge through shared memory) and 2
# (the next lane of the quad: the shuffles).
@pytest.mark.parametrize("shift,n", [(65, 400), (64, 400), (16, 400), (2, 400), (65, 200),
                                     (128, 200)])
def test_emulated_search_breaks_exact_ties_low(emu, shift, n):
    rng = np.random.RandomState(7 + shift + n)
    k = 130
    cb = torch.from_numpy(rng.randn(k, 64).astype(np.float32))
    low = [c for c in range(k - shift) if (c // shift) % 2 == 0]
    cb[[c + shift for c in low]] = cb[low]
    z = cb[torch.from_numpy(rng.choice(low, n))] + 0.05 * torch.from_numpy(
        rng.randn(n, 64).astype(np.float32))
    got = _search(emu, z, cb)
    want = nearest_codebook_indices_plain(z, cb)
    assert set(want.tolist()) <= set(low)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_emulated_search_resolves_a_near_margin(emu):
    """Each row sits near the midpoint of two codes a and b, the winner
    ahead by 5e-5 of the scores' scale (float64): 3xTF32 keeps every
    winner; one TF32 pass (about 11 significand bits) would not."""
    rng = np.random.RandomState(11)
    k, d, n = 130, 64, 192
    cb64 = rng.randn(k, d)
    a = rng.randint(0, k, n)
    b = (a + rng.randint(1, k, n)) % k
    diff = cb64[a] - cb64[b]
    z64 = 0.5 * (cb64[a] + cb64[b])
    scale = np.abs(2.0 * z64 @ cb64.T - (cb64 ** 2).sum(-1)).max()
    # s_a - s_b = 2 gamma |e_a - e_b|^2 for z = midpoint + gamma (e_a - e_b)
    gamma = 5e-5 * scale / (2.0 * (diff ** 2).sum(-1))
    z = torch.from_numpy((z64 + gamma[:, None] * diff).astype(np.float32))
    cb = torch.from_numpy(cb64.astype(np.float32))
    s = _scores64(z, cb)
    top = torch.topk(s, 2, dim=-1)
    assert torch.equal(top.indices[:, 0], torch.from_numpy(a))   # a leads, b follows
    assert torch.equal(top.indices[:, 1], torch.from_numpy(b))
    lead = (top.values[:, 0] - top.values[:, 1]) / s.abs().max()
    assert (lead > 2e-5).all() and (lead < 1e-4).all()
    got = _search(emu, z, cb)
    torch.testing.assert_close(got, torch.from_numpy(a).to(torch.int32), rtol=0, atol=0)
    torch.testing.assert_close(got, nearest_codebook_indices_plain(z, cb), rtol=0, atol=0)

"""The row sampler's bf16 build (``csrc/sampler_row.cu`` with
``-DPM_CORE_BF16=1``), emulated on the CPU, against the plain bf16 version.

The emulation and the float32 build's cases are
``test_torch_row_kernel_emulated.py``'s; the two builds are tested from two
files so that the suite's workers (``--dist loadfile``) run them side by
side. The bf16 build (twice the rows a stage, part stages where a matrix is
not whole stages, the chain rounded every ``lpg`` levels) is held to the
bf16 plain version with the card's gate (``sampler_chain.row_bf16_report``).
It compiles once for the module. Skips where no C++20 compiler is found.
"""
import pytest
import torch

from posterior_matching_torch.ops import sampler_chain as sc
from test_torch_row_kernel_emulated import _load_row, model_inputs
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def emu_bf16(tmp_path_factory):
    return _load_row(tmp_path_factory, ("-DPM_CORE_BF16=1",))


# bf16, one block each (the float32 cases above run the blocks' indexing):
# at 128 filters a 256-column chunk (one stage of lw) at lpg 2, and three
# 128-column chunks (each half a stage) at lpg 3; at 64 filters (h_init_left
# half a stage) digits16's W = 4 and K = 128 (half-stage chunks) over two
# groups of lpg 4, and two 256-column chunks at lpg 2.
@pytest.mark.parametrize("F,n_lvl,wid,n,k,lpg", [
    pytest.param(*c, id="-".join(map(str, c)))
    for c in ((128, 4, 3, 5, 256, 2), (128, 6, 2, 7, 384, 3), (64, 8, 4, 8, 128, 4),
              (64, 4, 2, 5, 512, 2))
])
def test_emulated_row_kernel_bf16_matches_plain(emu_bf16, F, n_lvl, wid, n, k, lpg):
    args = model_inputs(F, n_lvl, wid, n, k, lpg)[1]
    outh = torch.zeros_like(args[5])
    outm = torch.zeros_like(args[6])
    outs = torch.full((wid, n), -1, dtype=torch.int32)
    outl = torch.full((wid, n, k), float("nan"))
    assert emu_bf16.emu_sampler_row(
        *[a.data_ptr() for a in args], outh.data_ptr(), outm.data_ptr(),
        outs.data_ptr(), outl.data_ptr(), n_lvl, wid, n, k, F, lpg) == 0
    want = sc.row_plain(*args, with_logits=True, compute_dtype="bfloat16", lpg=lpg)
    report = sc.row_bf16_report((outh, outm, outs, outl), want, args[10], lpg)
    assert sc.bf16_gate_ok(report), report

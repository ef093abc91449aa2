"""The vertical-stack sampler's bf16 build (``csrc/sampler_vrow.cu`` with
``-DPM_CORE_BF16=1``), emulated on the CPU, against the plain bf16 version.

The emulation and the float32 build's cases are
``test_torch_vrow_kernel_emulated.py``'s; the two builds are tested from
two files so that the suite's workers (``--dist loadfile``) run them side
by side. The bf16 build (twice the rows a stage, h_init_up half a stage at
64 filters, the carry in float32 registers) is held to the bf16 plain
version on a seeded model's row-1 state with the card's gate
(``sampler_chain.vrow_bf16_report``). It compiles once for the module.
Skips where no C++20 compiler is found.
"""
import pytest
import torch

from posterior_matching_torch.ops import sampler_chain as sc
from test_torch_row_kernel_emulated import model_inputs
from test_torch_vrow_kernel_emulated import _load_vrow
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def emu_bf16(tmp_path_factory):
    return _load_vrow(tmp_path_factory, ("-DPM_CORE_BF16=1",))


# bf16: at 128 filters W = 7 over four levels (up and down: the skip
# product) and the flagship's W = 16 over two, one block each; at 64 filters
# (h_init_up a stage and a half) digits16's W = 4 over six levels and W = 7
# with a ragged second block.
@pytest.mark.parametrize("F,n_lvl,wid,n", [
    pytest.param(*c, id="-".join(map(str, c)))
    for c in ((128, 4, 7, 6), (128, 2, 16, 3), (64, 6, 4, 9), (64, 2, 7, 9))
])
def test_emulated_vrow_kernel_bf16_matches_plain(emu_bf16, F, n_lvl, wid, n):
    args = model_inputs(F, n_lvl, wid, n, 128, 1)[0]
    outs = [torch.zeros_like(args[3]), torch.zeros_like(args[4]),
            torch.zeros_like(args[1]), torch.zeros_like(args[1])]
    assert emu_bf16.emu_sampler_vrow(*[a.data_ptr() for a in args],
                                     *[o.data_ptr() for o in outs], n_lvl, wid, n, F) == 0
    report = sc.vrow_bf16_report(outs, sc.vrow_plain(*args, compute_dtype="bfloat16"))
    assert sc.bf16_gate_ok(report), report

"""The gated chain kernels' breakdown tool (``ops/gated_breakdown.py``) on
the CPU: each variant's substitution still finds its place in
``csrc/gated_common.cuh``, ``gated_levels.cuh`` and ``ptx_mma.cuh``, the ``mma.sync`` rate
probe issues both shapes, and the tool refuses to run without a CUDA
device."""
import pytest
import torch

from posterior_matching_torch.ops import _build, gated_breakdown
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

HEADER = (_build.CSRC / "gated_common.cuh").read_text()
LEVELS = (_build.CSRC / "gated_levels.cuh").read_text()
PTX = (_build.CSRC / "ptx_mma.cuh").read_text()
SMALL_BIG, BIG_SMALL, BIG_BIG = gated_breakdown._MMAS


def _text(name):
    return "".join(gated_breakdown.variants(HEADER, LEVELS, PTX)[name].values())


def test_kernel_variant_is_the_source():
    assert gated_breakdown.variants(HEADER, LEVELS, PTX)["kernel"] == {
        "gated_common.cuh": HEADER, "gated_levels.cuh": LEVELS, "ptx_mma.cuh": PTX}


@pytest.mark.parametrize("name,gone,kept", [
    ("one_pass", [SMALL_BIG, BIG_SMALL], [BIG_BIG, "split_tf32("]),
    ("skeleton", [SMALL_BIG, BIG_SMALL, BIG_BIG], ["stage_b<N>(", "store_a(ca, 0);"]),
    ("no_a_loads", ["if (ok[h]) {\n        const int r = r0",
                    "if (ok[h]) {\n        const size_t at = (size_t)(r + dy"],
     [BIG_BIG, "cp.async.cg"]),
    ("no_b_copies", ['  asm volatile("cp.async.cg'], [BIG_BIG, "if (ok[h]) {"]),
    ("no_sync", ["__syncthreads();   // everyone's",
                 "cp_async_wait_ring<kStages>();\n    __syncthreads();"],
     [BIG_BIG, "cp_async_wait_ring<kStages>();"]),
])
def test_variant_takes_its_part_away(name, gone, kept):
    text = _text(name)
    for g in gone:
        assert g not in text
    for k in kept:
        assert k in text


def test_variants_refuse_a_source_without_the_core():
    with pytest.raises(ValueError):
        gated_breakdown.variants(HEADER.replace(BIG_BIG, ""), LEVELS, PTX)


def test_mma_rate_probe_times_both_shapes():
    src = gated_breakdown.MMA_RATE
    assert "m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert 'extern "C" double pm_mma_rate(int kind)' in src


def test_refuses_without_a_cuda_device(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["gated_breakdown"])
    assert gated_breakdown.main() == 2
    assert "no CUDA device" in capsys.readouterr().err

"""The sampler kernels' breakdown tool (``ops/row_breakdown.py``) on the CPU:
each variant's substitution still finds its place in ``csrc/sampler_row.cu``
or ``csrc/sampler_vrow.cu`` and the ``sampler_common.cuh`` they share, and
the tool refuses to run without a CUDA device."""
import pytest
import torch

from posterior_matching_torch.ops import _build, row_breakdown
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SOURCE = (_build.CSRC / "sampler_row.cu").read_text()
VSOURCE = (_build.CSRC / "sampler_vrow.cu").read_text()
HEADER = (_build.CSRC / "sampler_common.cuh").read_text()


def test_kernel_variant_is_the_source():
    assert row_breakdown.variants(SOURCE, HEADER)["kernel"] == (SOURCE, HEADER)
    assert row_breakdown.variants(VSOURCE, HEADER, "vrow")["kernel"] == (VSOURCE, HEADER)


@pytest.mark.parametrize("name,gone,kept", [
    ("no_copy", ["mbar_expect_tx(bar"], ["for (int r = 0; r < kGroupRows; ++r)"]),
    ("no_fma", ["for (int r = 0; r < kGroupRows; ++r)"], ["mbar_expect_tx(bar"]),
    ("skeleton", ["for (int r = 0; r < kGroupRows; ++r)", "mbar_expect_tx(bar"],
     ["produce(p, ring"]),
    ("no_ring", ["produce(p, ring, per_pixel", "mbar_arrive(ring.empty_bar",
                 "mbar_wait(ring.full_bar"], ["consumers_sync();"]),
    ("ring_5x32k", ["kStage = 128 * F;", "kStages = 2;"], ["kStage = 64 * F;", "kStages = 5;"]),
])
def test_variant_takes_its_part_away(name, gone, kept):
    text = "".join(row_breakdown.variants(SOURCE, HEADER)[name])
    for g in gone:
        assert g not in text
    for k in kept:
        assert k in text


@pytest.mark.parametrize("name,gone,kept", [
    ("no_copy", ["mbar_expect_tx(bar", "complete_tx::bytes"], ["k4 < kWarpK"]),
    ("no_fma", ["k4 < kWarpK"], ["mbar_expect_tx(bar", "complete_tx::bytes"]),
    ("skeleton", ["k4 < kWarpK", "mbar_expect_tx(bar"], ["stream.issue(g);"]),
    ("no_ring", ["stream.issue(g);", "== kWarps - 1", "mbar_wait(smem_u32(full"],
     ["__syncthreads();"]),
    ("ring_6x16k", ["kStage = 64 * F;", "kStages = 3;", "kWarpK = 16 *"],
     ["kStage = 32 * F;", "kStages = 6;", "kWarpK = 8 *"]),
])
def test_vrow_variant_takes_its_part_away(name, gone, kept):
    text = "".join(row_breakdown.variants(VSOURCE, HEADER, "vrow")[name])
    for g in gone:
        assert g not in text
    for k in kept:
        assert k in text


def test_variants_refuse_a_changed_source():
    with pytest.raises(ValueError, match="no longer has"):
        row_breakdown.variants(SOURCE.replace("mbar_expect_tx(bar,", "expect(bar,"), HEADER)


def test_refuses_without_a_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["row_breakdown"])
    assert row_breakdown.main() == 2

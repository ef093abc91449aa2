"""The row kernel's breakdown tool (``ops/row_breakdown.py``) on the CPU: each
variant's substitution still finds its place in ``csrc/sampler_row.cu``, and
the tool refuses to run without a CUDA device."""
import pytest
import torch

from posterior_matching_torch.ops import _build, row_breakdown

SOURCE = (_build.CSRC / "sampler_row.cu").read_text()


def test_kernel_variant_is_the_source():
    assert row_breakdown.variants(SOURCE)["kernel"] == SOURCE


@pytest.mark.parametrize("name,gone,kept", [
    ("no_copy", ["mbar_expect_tx(bar"], ["for (int r = 0; r < kWarpRows; ++r)"]),
    ("no_fma", ["for (int r = 0; r < kWarpRows; ++r)"], ["mbar_expect_tx(bar"]),
    ("skeleton", ["for (int r = 0; r < kWarpRows; ++r)", "mbar_expect_tx(bar"],
     ["produce(p, ring"]),
    ("no_ring", ["produce(p, ring, per_pixel", "mbar_arrive(ring.empty_bar",
                 "mbar_wait(ring.full_bar"], ["consumers_sync();"]),
    ("ring_5x32k", ["kStage = 16384;", "kStages = 2;"], ["kStage = 8192;", "kStages = 5;"]),
])
def test_variant_takes_its_part_away(name, gone, kept):
    text = row_breakdown.variants(SOURCE)[name]
    for g in gone:
        assert g not in text
    for k in kept:
        assert k in text


def test_variants_refuse_a_changed_source():
    with pytest.raises(ValueError, match="no longer has"):
        row_breakdown.variants(SOURCE.replace("mbar_expect_tx(bar,", "expect(bar,"))


def test_refuses_without_a_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["row_breakdown"])
    assert row_breakdown.main() == 2

"""The codebook search's breakdown tool (``ops/vq_breakdown.py``) on the
CPU: each variant's substitution still finds its place in
``csrc/vq_search.cu``, the library yardstick computes the search's function,
and the tool refuses to run without a CUDA device."""
import sys

import numpy as np
import pytest
import torch

from posterior_matching_torch.ops import _build, vq_breakdown as vb
from posterior_matching_torch.ops.vq import nearest_codebook_indices_plain
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TEXT = (_build.CSRC / vb.SOURCE).read_text()
SMALL_BIG, BIG_SMALL, BIG_BIG = vb._MMAS


def test_kernel_variant_is_the_source():
    assert vb.variants(TEXT, ["kernel"]) == {"kernel": TEXT}


@pytest.mark.parametrize("name,gone,kept", [
    ("one_pass", [SMALL_BIG, BIG_SMALL], [BIG_BIG, "split_tf32(x)"]),
    ("skeleton", [SMALL_BIG, BIG_SMALL, BIG_BIG], ["stage_codes<", "nrm[u] = fmaf("]),
    ("no_copies", [], ["if (false) cp_async16(", BIG_BIG]),
    ("tm16", ["const int wave = PM_VQ_WAVE_BLOCKS;"], ["const int wave = 1 << 30;", BIG_BIG]),
])
def test_variant_takes_its_part_away(name, gone, kept):
    text = vb.variants(TEXT, [name])[name]
    for g in gone:
        assert g not in text, g
    for k in kept:
        assert k in text, k


def test_variants_refuse_a_source_without_the_mmas():
    with pytest.raises(ValueError):
        vb.variants(TEXT.replace(BIG_BIG, ""), ["skeleton"])


@pytest.mark.parametrize("ties", [False, True], ids=["random", "exact_ties"])
def test_library_yardstick_is_the_search(ties):
    """``addmm(-norms, z, cb.T, alpha=2)`` then ``argmax``: the plain
    version's indices, the lower index on exact ties."""
    rng = np.random.RandomState(3)
    cb = torch.from_numpy(rng.randn(96, 16).astype(np.float32))
    if ties:
        cb[48:] = cb[:48]
    z = torch.from_numpy(rng.randn(200, 16).astype(np.float32))
    got = vb.library_fn(z, cb)()
    want = nearest_codebook_indices_plain(z, cb)
    torch.testing.assert_close(got.to(torch.int32), want, rtol=0, atol=0)
    if ties:
        assert (got < 48).all()


def test_tool_refuses_without_a_cuda_device(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["vq_breakdown"])
    assert vb.main() == 2
    assert "no CUDA device" in capsys.readouterr().err

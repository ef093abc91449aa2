"""The decoder chain kernels' breakdown tool (``ops/decoder_breakdown.py``)
on the CPU: each variant's substitution still finds its place in
``csrc/decoder_gemm.cuh`` and ``decoder_chain_bwd.cu``, the operation
counts match the kernels' notes, and the tool refuses to run without a
CUDA device."""
import pytest
import torch

from posterior_matching_torch.ops import _build, decoder_breakdown as db

TEXTS = {f: (_build.CSRC / f).read_text() for f in db.FILES}
SMALL_BIG, BIG_SMALL, BIG_BIG = db._MMAS


def _text(name):
    return "".join(db.variants(TEXTS, [name])[name].values())


def test_kernel_variant_is_the_source():
    assert db.variants(TEXTS, ["kernel"])["kernel"] == TEXTS


@pytest.mark.parametrize("name,gone,kept", [
    ("one_pass", [SMALL_BIG, BIG_SMALL], [BIG_BIG, "split_tf32("]),
    ("skeleton", [SMALL_BIG, BIG_SMALL, BIG_BIG], ["stage_b(", "gather(ca, sA);"]),
    ("no_a_loads", ["x = ldg4(", "a = __ldg(", "va[v] = ok ? __ldg("], [BIG_BIG, "cp.async.cg"]),
    ("no_b_copies", ['  asm volatile("cp.async.cg'], [BIG_BIG, "if (ok && v < lim) x = ldg4("]),
    ("no_sync", ["__syncthreads();  // chunk c"], [BIG_BIG, "cp_async_wait_ring<"]),
    ("bwd_data", ["  // ---- weight gradients"], ["launch_wgrad<M>(", "z_bwd<C, LD>"]),
    ("bwd_wgrad", ["for (int l = L - 1; l >= 0; --l)"], ["launch_wgrad<M>(", "bias_sums"]),
])
def test_variant_takes_its_part_away(name, gone, kept):
    text = _text(name)
    for g in gone:
        assert g not in text or (name == "no_a_loads" and f"(false) {g}" in text), g
    for k in kept:
        assert k in text


def test_variants_refuse_a_source_without_the_core():
    with pytest.raises(ValueError):
        db.variants({**TEXTS, db.CORE: TEXTS[db.CORE].replace(BIG_BIG, "")}, ["skeleton"])


def test_operation_counts_match_the_kernels_notes():
    """The res-28 run of a PM-VDVAE MNIST step: ~43 GFLOP forward, 84.5
    backward (decoder_chain_fwd.cu and decoder_chain_bwd.cu)."""
    fwd = db.dec_chain_flops(16, 28, 28, 192, 48, 16, 3, 7)
    assert abs(fwd / 1e9 - 43.07) < 0.01
    assert abs(db.bwd_flops(fwd, 16 * 28 * 28, 192, 48, 7) / 1e9 - 84.52) < 0.01


def test_refuses_without_a_cuda_device(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["decoder_breakdown"])
    assert db.main() == 2
    assert "no CUDA device" in capsys.readouterr().err

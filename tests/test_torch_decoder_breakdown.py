"""The decoder chain kernels' breakdown tool (``ops/decoder_breakdown.py``)
on the CPU: each variant's substitution still finds its place in
``csrc/vdvae_gemm.cuh`` and ``decoder_chain_bwd.cu``, the operation
counts match the kernels' notes, and the tool refuses to run without a
CUDA device."""
import pytest
import torch

from posterior_matching_torch.ops import _build, block_chain as bc, decoder_breakdown as db
from posterior_matching_torch.ops import decoder_chain as dc
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TEXTS = {f: (_build.CSRC / f).read_text() for f in db.FILES}
SMALL_BIG, BIG_SMALL, BIG_BIG = db._MMAS


def _text(name):
    return "".join(db.variants(TEXTS, [name])[name].values())


def test_kernel_variant_is_the_source():
    assert db.variants(TEXTS, ["kernel"])["kernel"] == TEXTS


@pytest.mark.parametrize("name,gone,kept", [
    ("one_pass", [SMALL_BIG, BIG_SMALL], [BIG_BIG, "split_tf32("]),
    ("skeleton", [SMALL_BIG, BIG_SMALL, BIG_BIG], ["stage_b(", "gather(ca, sA);"]),
    ("no_a_loads", ["x = ldg4(", "a = src_at(", "va[v] = ok ? src_at("], [BIG_BIG, "cp.async.cg"]),
    ("no_b_copies", ['  asm volatile("cp.async.cg'], [BIG_BIG, "if (ok && v < lim) x = ldg4("]),
    ("no_sync", ["__syncthreads();  // chunk c"], [BIG_BIG, "cp_async_wait_ring<"]),
    ("bwd_data", ["  // ---- weight gradients"], ["launch_wgrad_dt<M>(", "z_bwd<C, LD>"]),
    ("bwd_wgrad", ["for (int l = L - 1; l >= 0; --l)"], ["launch_wgrad_dt<M>(", "bias_sums"]),
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
    fwd = dc.chain_flops(16, 28, 28, 192, 48, 16, 3, 7)
    assert abs(fwd / 1e9 - 43.07) < 0.01
    assert abs(dc.bwd_flops(fwd, 16 * 28 * 28, 192, 48, 7) / 1e9 - 84.52) < 0.01


def test_refuses_without_a_cuda_device(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["decoder_breakdown"])
    assert db.main() == 2
    assert "no CUDA device" in capsys.readouterr().err


BLOCK_TEXTS = {f: (_build.CSRC / f).read_text() for f in db.BLOCK_FILES}


@pytest.mark.parametrize("name", db.VARIANTS)
def test_block_variant_changes_the_core_or_the_backward(name):
    """``--chain block``: each variant's substitutions find their places in
    the shared core or in ``block_chain_bwd.cu``, and nowhere else."""
    new = db.variants(BLOCK_TEXTS, [name], "block")[name]
    changed = {f for f in new if new[f] != BLOCK_TEXTS[f]}
    want = set() if name == "kernel" else (
        {"block_chain_bwd.cu"} if name.startswith("bwd_") else
        {db.PTX} if name == "no_b_copies" else {db.CORE})
    assert changed == want
    bwd = new["block_chain_bwd.cu"]
    if name == "bwd_data":
        assert "  // ---- weight gradients" not in bwd and "launch_wgrad_dt<M>(" in bwd
    if name == "bwd_wgrad":
        assert "for (int l = L - 1; l >= 0; --l)" not in bwd and "bias_sums" in bwd


def test_block_operation_counts_match_the_kernels_notes():
    """The encoder's res-28 run of a PM-VDVAE MNIST step (16 x 28 x 28 rows,
    6 levels): 8.7 GFLOP forward (block_chain_fwd.cu), 17.4 backward."""
    fwd = bc.chain_flops(16, 28, 28, 192, 48, 3, 6)
    assert abs(fwd / 1e9 - 8.72) < 0.01
    assert [r for r, _, _ in db.BLOCK_RUNS] == [28, 14, 7, 3, 1]


def test_block_chain_refuses_without_a_cuda_device(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["decoder_breakdown", "--chain", "block"])
    assert db.main() == 2
    assert "no CUDA device" in capsys.readouterr().err

"""The hand-written kernels against their plain PyTorch versions.

These need an NVIDIA GPU (sm_90a) and ``nvcc``; elsewhere they skip. On the
card: ``python -m pytest tests/test_torch_kernels_gpu.py -q -m cuda``. Shapes
are small but cover what the full-width smoke run does not: widths that do
not divide the vrow kernel's 32 row slots, sample counts that leave a
block's tile ragged, two logits chunks, the row kernel at full depth
(L = 24) and launched twice for bit-identical outputs; row counts that
leave the gated chain's 64-row tiles ragged, grids other than square; the
pair and segment kernels at the flagship's 16x16 and PM-VQVAE MNIST's 7x7
code grids, up and down, with and without dropout, a segment whose outputs
reach the loss only in part, and a small PM-VQVAE step per chain mode
(stream, pairs, segments with a remainder) against the CPU; the three
chain backwards at the flagship's 32 x 16 x 16 rows (weight gradients in row
splits) and at 2 x 7 x 7 (in one pass), each relaunched bit for bit; the vrow
kernel at the flagship's row (W 16, n 320, L 24), relaunched bit for bit; the
codebook search at the four shapes the port runs it at (relaunched bit for
bit), latent counts that leave its row tiles ragged, its near-margin
winners against float64 and one device kernel a call; block-chain and decoder-chain runs
whose rows leave the 16- to 64-row tiles ragged, 1x1 and 3x3 taps at the
image's edges, and runs long enough that their weight gradients sum
several row splits, each at both compiled geometries; the decoder chain's
backward with every output's cotangent and with the state's alone; and a
digits16 PM-VDVAE step, with the block chain and with the decoder chain
too, against the CPU; the block chain's and the decoder chain's kernels
relaunched bit for bit at their res-28 run shapes; and the gated chain's
GEMM core and the VDVAE chains' (the block chain's 1x1 products, its
halo-staged 3x3 taps and their weight gradients, and the decoder chain's
products) on operands that TF32 alone would round, against float64. At 64
filters (``pm_vqvae_digits16``'s width, the other build of the gated chain
and sampler kernels): the vrow and row kernels at digits16's row (W 4, n
320, L 12, K 128) and at ragged shapes, relaunched bit for bit, the row
kernel also at three 128-column logits chunks; the six gated entry points
at 32 x 4 x 4 and at ragged rows, their backwards relaunched bit for bit;
a digits16 PM-VQVAE step per chain mode against the CPU; a width that was
not built (96) refused by name. Tolerance: 1e-4 relative to the tensor's scale (float32 sums in another
order), for the chains' gradients too (their sums run over at most a few
thousand rows here). The VDVAE chains' bf16 builds (``compute_dtype``
bfloat16) at both geometries and three run shapes each, forward, saves
and backward against their plain versions (the bars below
``BF16_TOL``), relaunched bit for bit and through autograd with their own
counters; a build refusing the other dtype; and a digits16 bf16 step,
unfused and fused, against the CPU. The gated chain's bf16 builds (the
PM-VQVAE's ``compute_dtype`` bfloat16): the stream, the pair and the
segment up and down at both widths against the plain bf16 version through
autograd (``GATED_BF16_TOL``), relaunched bit for bit and counted by their
own wrappers, refusing a float32 geometry, and a small bf16 PM-VQVAE step
per chain mode against the CPU. The sampler kernels' bf16 builds (JAX's
``PM_TPU_SAMPLER=rowkernel`` sampler): vrow and row at both widths, both
logits chunks and each rounding cadence, on a seeded model's row-1 state,
against the plain bf16 versions with ``sampler_chain.bf16_gate_ok``,
relaunched bit for bit and counted by their own wrappers; a build refusing
the other dtype; a bf16 request launching only the bf16 builds.
"""
import pytest
import torch

from posterior_matching_torch.models.pixelcnn import PixelCNN
from posterior_matching_torch.ops import block_chain as bc
from posterior_matching_torch.ops import decoder_chain as dc
from posterior_matching_torch.ops import gated_chain as gc
from posterior_matching_torch.ops import sampler_chain as sc
from posterior_matching_torch.ops import vq

pytestmark = pytest.mark.cuda
F = 128
TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(gen, *shape, scale=1.0):
    return (scale * torch.randn(shape, generator=gen, device=gen.device)).contiguous()


def _close(got, want):
    err = (got - want).abs().max().item()
    return err / max(1.0, want.abs().max().item()) <= TOL


def _vrow_inputs(gen, n_lvl, wid, n, fan_in=False, F=F):
    """Weights at 0.05, or with ``fan_in`` at 1 / sqrt(fan-in) (biases
    0.05): over 24 levels 0.05 makes the chain amplify float32 rounding
    (the plain version itself lands ~5e-2 of scale off float64 at the last
    level), the fan-in scale keeps both within ~1e-6."""
    s = lambda k: k ** -0.5 if fan_in else 0.05
    return (
        _rand(gen, wid, n, F), _rand(gen, wid, n, F), _rand(gen, wid, n, F),
        _rand(gen, n_lvl, wid, n, F), _rand(gen, n_lvl, wid, n, 2 * F),
        _rand(gen, n_lvl, n, 2 * F),
        _rand(gen, 6 * F, F, scale=s(6 * F)), _rand(gen, F, scale=0.05),
        _rand(gen, 3 * F, F, scale=s(3 * F)), _rand(gen, F, scale=0.05),
        _rand(gen, n_lvl, 12 * F, F, scale=s(12 * F)), _rand(gen, n_lvl, F, scale=0.05),
        _rand(gen, n_lvl, 12 * F, 2 * F, scale=s(12 * F)), _rand(gen, n_lvl, 2 * F, scale=0.05),
        _rand(gen, n_lvl, 2 * F, F, scale=s(2 * F)),
    )


@pytest.mark.parametrize("wid,n,f", [
    *(pytest.param(w_, n_, F, id=f"{w_}-{n_}") for w_, n_ in ((16, 5), (7, 33), (1, 3))),
    *(pytest.param(w_, n_, 64, id=f"f64-{w_}-{n_}") for w_, n_ in ((4, 13), (7, 33), (16, 5))),
])
def test_vrow_kernel_matches_plain(dev, wid, n, f):
    gen = torch.Generator(device=dev).manual_seed(wid * 100 + n)
    args = _vrow_inputs(gen, 4, wid, n, F=f)
    before = sc.vrow.launches
    got = sc.vrow(*args)
    torch.cuda.synchronize()
    assert sc.vrow.launches == before + 1
    want = sc.vrow_plain(*args)
    for g, w in zip(got, want):
        assert _close(g, w)


def test_vrow_kernel_flagship_matches_plain_and_relaunches_bit_for_bit(dev):
    # the flagship's row: W 16, n = 32 images x 10 samples, L 24 (107 blocks
    # of 3 samples, the last ragged)
    gen = torch.Generator(device=dev).manual_seed(16320)
    args = _vrow_inputs(gen, 24, 16, 320, fan_in=True)
    first = sc.vrow(*args)
    second = sc.vrow(*args)
    torch.cuda.synchronize()
    want = sc.vrow_plain(*args)
    for g, g2, w in zip(first, second, want):
        assert _close(g, w)
        assert torch.equal(g, g2)


def _row_inputs(gen, n_lvl, wid, n, k, F=F):
    s = 0.05
    return (
        _rand(gen, n_lvl, 12 * F, F, scale=s), _rand(gen, n_lvl, F, scale=s),
        _rand(gen, n_lvl, 8 * F, 2 * F, scale=s), _rand(gen, n_lvl, 2 * F, scale=s),
        _rand(gen, n_lvl, n, 2 * F),
        _rand(gen, n_lvl, wid, n, F), _rand(gen, n_lvl, wid, n, 2 * F),
        _rand(gen, n_lvl, wid, n, F), _rand(gen, wid, n, F), _rand(gen, wid, n, F),
        sc.gumbel_noise((wid, n, k), gen, gen.device),
        _rand(gen, k, F, scale=s), _rand(gen, F, k, scale=s), _rand(gen, k, scale=s),
        _rand(gen, 2 * F, F, scale=s), _rand(gen, F, scale=s),
    )


# The weight ring wraps at GEMM, level and pixel boundaries: full depth
# (L = 24) with a ragged last block (n = 13) and with full blocks (n = 16),
# one column, one and two logits chunks of 256 and 128-column chunks (K 128
# and 384); at 64 filters digits16's depth (L 12) and codebook (K 128),
# one column, two chunks of 256 and three of 128.
@pytest.mark.parametrize("wid,n,k,n_lvl,f", [
    pytest.param(16, 5, 512, 4, F, id="16-5-512"),
    pytest.param(7, 13, 256, 4, F, id="7-13-256"),
    pytest.param(16, 13, 512, 24, F, id="16-13-512-L24"),
    pytest.param(16, 16, 256, 24, F, id="16-16-256-L24"),
    pytest.param(1, 5, 512, 4, F, id="1-5-512"),
    pytest.param(7, 13, 128, 4, F, id="7-13-128"),
    pytest.param(3, 9, 384, 4, F, id="3-9-384"),
    pytest.param(4, 13, 128, 12, 64, id="f64-4-13-128-L12"),
    pytest.param(1, 5, 512, 4, 64, id="f64-1-5-512"),
    pytest.param(7, 16, 384, 4, 64, id="f64-7-16-384"),
])
def test_row_kernel_matches_plain(dev, wid, n, k, n_lvl, f):
    gen = torch.Generator(device=dev).manual_seed(wid * 100 + n)
    args = _row_inputs(gen, n_lvl, wid, n, k, F=f)
    before = sc.row.launches
    got = sc.row(*args, with_logits=True)
    torch.cuda.synchronize()
    assert sc.row.launches == before + 1
    want = sc.row_plain(*args, with_logits=True)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
    for g, w in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        assert _close(g, w)


def test_row_kernel_is_deterministic(dev):
    # the split-K partial sums are reduced in a fixed order
    gen = torch.Generator(device=dev).manual_seed(7)
    args = _row_inputs(gen, 24, 16, 13, 512)
    first = sc.row(*args, with_logits=True)
    second = sc.row(*args, with_logits=True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_sampler_kernels_at_the_digits16_row_relaunch_bit_for_bit(dev):
    """digits16's row (W 4, n = 32 images x 10 samples, 64 filters, L 12,
    K 128: 36 vrow blocks of 9 samples, 40 row blocks of 8): both kernels
    against their plain versions, each relaunched bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(4320)
    vargs = _vrow_inputs(gen, 12, 4, 320, fan_in=True, F=64)
    rargs = _row_inputs(gen, 12, 4, 320, 128, F=64)
    before = (sc.vrow.launches, sc.row.launches)
    v1, v2 = sc.vrow(*vargs), sc.vrow(*vargs)
    r1, r2 = sc.row(*rargs, with_logits=True), sc.row(*rargs, with_logits=True)
    torch.cuda.synchronize()
    assert (sc.vrow.launches, sc.row.launches) == (before[0] + 2, before[1] + 2)
    for g, g2, w in zip(v1, v2, sc.vrow_plain(*vargs)):
        assert _close(g, w) and torch.equal(g, g2)
    want = sc.row_plain(*rargs, with_logits=True)
    assert (r1[2] == want[2]).float().mean().item() >= 0.999
    for a, b in zip(r1, r2):
        assert torch.equal(a, b)
    same = (r1[2] == want[2]).all(0)   # chains whose every sample agreed
    for g, w in zip((r1[0], r1[1], r1[3]), (want[0], want[1], want[3])):
        assert _close(g[..., same, :], w[..., same, :])


def test_kernel_wrappers_refuse_unsupported_shapes(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    args = list(_vrow_inputs(gen, 4, 16, 5))
    args[0] = args[0][:, :, :64].contiguous()  # e2 narrower than F
    with pytest.raises(ValueError, match="e2"):
        sc.vrow(*args)
    with pytest.raises(ValueError, match="mixed devices"):
        sc.vrow(*[a.cpu() if i == 1 else a for i, a in enumerate(_vrow_inputs(gen, 4, 16, 5))])


@pytest.mark.parametrize("n,k,d", [(1000, 512, 64), (37, 130, 8)])
def test_vq_search_kernel_matches_plain(dev, n, k, d):
    gen = torch.Generator(device=dev).manual_seed(n + k)
    z = _rand(gen, n, d)
    cb = _rand(gen, k, d)
    before = vq.nearest_codebook_indices.launches
    got = vq.nearest_codebook_indices(z, cb)
    torch.cuda.synchronize()
    assert vq.nearest_codebook_indices.launches == before + 1
    want = vq.nearest_codebook_indices_plain(z, cb)
    assert got.dtype == torch.int32 and got.shape == (n,)
    diff = got != want
    assert diff.float().mean().item() <= 1e-3
    # every disagreement is a near-tie of the two scores
    scores = 2.0 * (z @ cb.T) - (cb * cb).sum(-1)
    gap = (scores.gather(1, want[:, None].long()) - scores.gather(1, got[:, None].long())).abs()
    assert (gap[diff] <= 1e-5 * scores.abs().max()).all()


def test_vq_search_kernel_breaks_exact_ties_low(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    base = _rand(gen, 100, 16)
    cb = torch.cat([base, base, base]).contiguous()   # every code three times
    z = base[torch.randperm(100, generator=gen, device=dev)].contiguous()
    got = vq.nearest_codebook_indices(z, cb)
    want = vq.nearest_codebook_indices_plain(z, cb)
    assert (got < 100).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# The four shapes the port runs the search at (latents, codes, width): a
# PM-VQVAE step (32 x 16 x 16), a CelebA stage-1 step (64 x 16 x 16), MNIST
# (32 x 7 x 7) and digits16 (32 x 4 x 4); each picks its own row tile.
VQ_SHAPES = [(8192, 512, 64), (16384, 512, 64), (1568, 256, 64), (512, 128, 64)]


@pytest.mark.parametrize("n,k,d", VQ_SHAPES)
def test_vq_search_kernel_at_the_port_shapes(dev, n, k, d):
    """Indices as the plain version's on >= 0.999 of the latents, every
    disagreement a near-tie (1e-5 of the scores' scale), and a relaunch
    bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(n + k)
    cb = _rand(gen, k, d, scale=0.5)
    z = (cb[torch.randint(0, k, (n,), generator=gen, device=dev)]
         + _rand(gen, n, d, scale=0.3)).contiguous()
    got = vq.nearest_codebook_indices(z, cb)
    again = vq.nearest_codebook_indices(z, cb)
    want = vq.nearest_codebook_indices_plain(z, cb)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    diff = got != want
    assert diff.float().mean().item() <= 1e-3
    scores = 2.0 * (z @ cb.T) - (cb * cb).sum(-1)
    gap = (scores.gather(1, want[:, None].long()) - scores.gather(1, got[:, None].long())).abs()
    assert (gap[diff] <= 1e-5 * scores.abs().max()).all()


def test_vq_search_kernel_resolves_a_near_margin_against_float64(dev):
    """Rows near the midpoint of two codes, the winner ahead by 5e-5 of the
    scores' scale in float64: 3xTF32 keeps every winner (one TF32 pass,
    about 11 significand bits, would not)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    n, k, d = 8192, 512, 64
    cb64 = torch.randn(k, d, generator=gen, device=dev, dtype=torch.float64)
    a = torch.randint(0, k, (n,), generator=gen, device=dev)
    b = (a + torch.randint(1, k, (n,), generator=gen, device=dev)) % k
    diff = cb64[a] - cb64[b]
    mid = 0.5 * (cb64[a] + cb64[b])
    scale = (2.0 * mid @ cb64.T - (cb64 * cb64).sum(-1)).abs().max()
    gamma = 5e-5 * scale / (2.0 * (diff * diff).sum(-1))
    z = (mid + gamma[:, None] * diff).float().contiguous()
    cb = cb64.float().contiguous()
    s = 2.0 * z.double() @ cb.double().T - (cb.double() ** 2).sum(-1)
    top = torch.topk(s, 2, dim=-1)
    keep = (top.indices[:, 0] == a) & (top.indices[:, 1] == b)   # a leads, b follows
    assert keep.float().mean().item() > 0.99
    got = vq.nearest_codebook_indices(z, cb)
    assert torch.equal(got[keep].long(), a[keep])


def test_vq_search_is_one_kernel_a_call(dev):
    """One wrapper call is one device kernel (no norm or other launches) and
    adds one to the counter."""
    from posterior_matching_torch.ops.profiling import profile_calls

    gen = torch.Generator(device=dev).manual_seed(3)
    z, cb = _rand(gen, 8192, 64), _rand(gen, 512, 64)
    before = vq.nearest_codebook_indices.launches
    vq.nearest_codebook_indices(z, cb)
    assert vq.nearest_codebook_indices.launches == before + 1
    prof = profile_calls(lambda: vq.nearest_codebook_indices(z, cb), 5)
    assert prof is not None, "the profiler lost part of three windows"
    _, per_call, names = prof
    assert per_call == 1 and all("vq_search" in name for name in names), names


def _stream_case(gen, b, h, w, L, cd, down):
    f = F
    taps = gc.chain_taps()
    shapes = gc.weight_shapes(f, cd, *taps, down)
    weights = {n: _rand(gen, L, *s, scale=0.05) for n, s in shapes}
    for n in weights:
        if n.startswith("wc"):
            weights[n] = _rand(gen, L, *dict(shapes)[n], scale=0.02)
    xv0, xh0 = _rand(gen, b, h, w, f), _rand(gen, b, h, w, f)
    skips = (_rand(gen, L, b, h, w, f), _rand(gen, L, b, h, w, f)) if down else None
    return xv0, xh0, skips, _rand(gen, b, cd), weights


@pytest.mark.parametrize("down", [False, True], ids=["up", "down"])
@pytest.mark.parametrize("b,h,w,keep", [(2, 8, 8, 0.5), (3, 5, 7, 1.0)])
def test_gated_stream_kernels_match_plain(dev, down, b, h, w, keep):
    gen = torch.Generator(device=dev).manual_seed(b * 100 + h + down)
    L, cd = 3, 16
    xv0, xh0, skips, cond, weights = _stream_case(gen, b, h, w, L, cd, down)
    leaves = [xv0, xh0, cond, *weights.values()] + (list(skips) if down else [])
    for t in leaves:
        t.requires_grad_(True)
    kw = dict(seed=7, base_pair=12 if down else 0, keep=keep)
    f0, b0 = gc.stream_fwd.launches, gc.stream_bwd.launches
    got = gc.gated_stream(xv0, xh0, skips, cond, weights, **kw)
    want = gc.gated_stream_plain(xv0, xh0, skips, cond, weights, **kw)
    for g_, w_ in zip(got, want):
        assert _close(g_, w_)
    cot = [_rand(gen, *t.shape) for t in want]
    grads_k = torch.autograd.grad(got, leaves, cot)
    torch.cuda.synchronize()
    assert gc.stream_fwd.launches == f0 + 1 and gc.stream_bwd.launches == b0 + 1
    grads_p = torch.autograd.grad(want, leaves, cot)
    for gk, gp in zip(grads_k, grads_p):
        assert _close(gk, gp)


def _level_case(gen, b, h, w, L, cd, down, f=F):
    """Per-level weights at 1 / sqrt(fan-in) (biases 0.05), so that
    activations and gradients stay of order 1 over the levels."""
    shapes = gc.weight_shapes(f, cd, *gc.chain_taps(), down)
    ws = [{n: _rand(gen, *s, scale=s[0] ** -0.5 if len(s) == 2 else 0.05) for n, s in shapes}
          for _ in range(L)]
    xv0, xh0, cond = _rand(gen, b, h, w, f), _rand(gen, b, h, w, f), _rand(gen, b, cd)
    sk = [(_rand(gen, b, h, w, f), _rand(gen, b, h, w, f)) for _ in range(L)] if down else None
    return xv0, xh0, sk, cond, ws


def _leaf_names(ws, sk):
    return ["xv0", "xh0", "cond", *(f"{n}[{l}]" for l, wl in enumerate(ws) for n in wl),
            *(f"{n}[{l}]" for l in range(len(sk or ())) for n in ("skv", "skh"))]


@pytest.mark.parametrize("down", [False, True], ids=["up", "down"])
@pytest.mark.parametrize("mode", ["pair", "segment"])
@pytest.mark.parametrize("b,h,w,cd,keep,seg", [(2, 16, 16, 512, 0.5, 4), (3, 7, 7, 512, 1.0, 8),
                                               (2, 7, 7, 16, 0.5, 3)])
def test_gated_pair_and_segment_kernels_match_plain(dev, down, mode, b, h, w, cd, keep, seg):
    gen = torch.Generator(device=dev).manual_seed(b * 100 + h + cd + down)
    n_lvl = 1 if mode == "pair" else seg
    xv0, xh0, sk, cond, ws = _level_case(gen, b, h, w, n_lvl, cd, down)
    leaves = [xv0, xh0, cond, *(t for wl in ws for t in wl.values()),
              *(t for pair in (sk or ()) for t in pair)]
    for t in leaves:
        t.requires_grad_(True)
    fwd, bwd = (gc.pair_fwd, gc.pair_bwd) if mode == "pair" else (gc.seg_fwd, gc.seg_bwd)
    f0, b0 = fwd.launches, bwd.launches
    if mode == "pair":
        kw = dict(seed=5, pair_index=13 if down else 2, keep=keep)
        got = [gc.gated_pair(xv0, xh0, sk and sk[0], cond, ws[0], **kw)]
        want = [gc.gated_pair_plain(xv0, xh0, sk and sk[0], cond, ws[0], **kw)]
    else:
        kw = dict(seed=5, base_pair=12 if down else 3, keep=keep)
        got = gc.gated_segment(xv0, xh0, sk, cond, ws, **kw)
        want = gc.gated_segment_plain(xv0, xh0, sk, cond, ws, **kw)
    got = [t for pair in got for t in pair]
    want = [t for pair in want for t in pair]
    for g_, w_ in zip(got, want):
        assert g_.shape == w_.shape and _close(g_, w_)
    cot = [_rand(gen, *t.shape) for t in want]
    grads_k = torch.autograd.grad(got, leaves, cot)
    torch.cuda.synchronize()
    assert fwd.launches == f0 + 1 and bwd.launches == b0 + 1
    grads_p = torch.autograd.grad(want, leaves, cot)
    for name, gk, gp in zip(_leaf_names(ws, sk), grads_k, grads_p):
        assert _close(gk, gp), name


# The backward kernels' weight gradients sum their rows in row splits where a
# launch's grid is small (the flagship's 32 x 16 x 16 rows: the pair's and
# segment's kinds, the stream's horizontal and aux ones) and in one pass
# where it is large or the rows are few (2 x 7 x 7); each against autograd
# through the plain version, and relaunched bit for bit.
@pytest.mark.parametrize("down", [False, True], ids=["up", "down"])
@pytest.mark.parametrize("b,h,w", [(32, 16, 16), (2, 7, 7)])
@pytest.mark.parametrize("mode", ["pair", "segment", "stream"])
def test_gated_backward_row_splits_match_autograd_bit_for_bit(dev, mode, b, h, w, down):
    gen = torch.Generator(device=dev).manual_seed(b * 100 + h + down)
    cd, keep = 64, 0.5
    n_lvl = {"pair": 1, "segment": 4, "stream": 12}[mode]
    xv0, xh0, sk, cond, ws = _level_case(gen, b, h, w, n_lvl, cd, down)
    if mode == "stream":
        ws = [{k: torch.stack([wl[k] for wl in ws]) for k in ws[0]}]
        sk = (torch.stack([p[0] for p in sk]), torch.stack([p[1] for p in sk])) if down else None
        skl = list(sk) if down else []
    else:
        skl = [t for pair in (sk or ()) for t in pair]
    leaves = [xv0, xh0, cond, *(t for wl in ws for t in wl.values()), *skl]
    for t in leaves:
        t.requires_grad_(True)
    if mode == "stream":
        kw = dict(seed=5, base_pair=12 if down else 0, keep=keep)
        got = list(gc.gated_stream(xv0, xh0, sk, cond, ws[0], **kw))
        want = list(gc.gated_stream_plain(xv0, xh0, sk, cond, ws[0], **kw))
    elif mode == "pair":
        kw = dict(seed=5, pair_index=13 if down else 2, keep=keep)
        got = list(gc.gated_pair(xv0, xh0, sk and sk[0], cond, ws[0], **kw))
        want = list(gc.gated_pair_plain(xv0, xh0, sk and sk[0], cond, ws[0], **kw))
    else:
        kw = dict(seed=5, base_pair=12 if down else 3, keep=keep)
        got = [t for pair in gc.gated_segment(xv0, xh0, sk, cond, ws, **kw) for t in pair]
        want = [t for pair in gc.gated_segment_plain(xv0, xh0, sk, cond, ws, **kw)
                for t in pair]
    cot = [_rand(gen, *t.shape) for t in want]
    first = torch.autograd.grad(got, leaves, cot, retain_graph=True)
    second = torch.autograd.grad(got, leaves, cot)
    torch.cuda.synchronize()
    grads_p = torch.autograd.grad(want, leaves, cot)
    for i, (g1, g2, gp) in enumerate(zip(first, second, grads_p)):
        assert _close(g1, gp), i
        assert torch.equal(g1, g2), i


# The six entry points at 64 filters (digits16's width: conv_a's products
# are one n8 tile a warp): digits16's 32 x 4 x 4 rows (cond 256, pm_vqvae_
# digits16's 6 levels a pass for the stream, a segment of 4; the pair's and
# segment's weight gradients in row splits) and 5 x 3 x 5 (75 rows, a
# ragged 64-row tile), up and down, dropout 0.5: outputs and every gradient
# against autograd through the plain version, the backward relaunched bit
# for bit, one launch a call.
@pytest.mark.parametrize("down", [False, True], ids=["up", "down"])
@pytest.mark.parametrize("b,h,w", [(32, 4, 4), (5, 3, 5)])
@pytest.mark.parametrize("mode", ["pair", "segment", "stream"])
def test_gated_kernels_at_64_filters_match_autograd(dev, mode, b, h, w, down):
    gen = torch.Generator(device=dev).manual_seed(6400 + b * 10 + h + down)
    n_lvl = {"pair": 1, "segment": 4, "stream": 6}[mode]
    xv0, xh0, sk, cond, ws = _level_case(gen, b, h, w, n_lvl, 256, down, f=64)
    if mode == "stream":
        ws = [{k: torch.stack([wl[k] for wl in ws]) for k in ws[0]}]
        sk = (torch.stack([p[0] for p in sk]), torch.stack([p[1] for p in sk])) if down else None
        skl = list(sk) if down else []
    else:
        skl = [t for pair in (sk or ()) for t in pair]
    leaves = [xv0, xh0, cond, *(t for wl in ws for t in wl.values()), *skl]
    for t in leaves:
        t.requires_grad_(True)
    kernels = {"pair": (gc.pair_fwd, gc.pair_bwd), "segment": (gc.seg_fwd, gc.seg_bwd),
               "stream": (gc.stream_fwd, gc.stream_bwd)}[mode]
    before = [k.launches for k in kernels]
    if mode == "stream":
        kw = dict(seed=5, base_pair=6 if down else 0, keep=0.5)
        got = list(gc.gated_stream(xv0, xh0, sk, cond, ws[0], **kw))
        want = list(gc.gated_stream_plain(xv0, xh0, sk, cond, ws[0], **kw))
    elif mode == "pair":
        kw = dict(seed=5, pair_index=7 if down else 2, keep=0.5)
        got = list(gc.gated_pair(xv0, xh0, sk and sk[0], cond, ws[0], **kw))
        want = list(gc.gated_pair_plain(xv0, xh0, sk and sk[0], cond, ws[0], **kw))
    else:
        kw = dict(seed=5, base_pair=6 if down else 1, keep=0.5)
        got = [t for pair in gc.gated_segment(xv0, xh0, sk, cond, ws, **kw) for t in pair]
        want = [t for pair in gc.gated_segment_plain(xv0, xh0, sk, cond, ws, **kw)
                for t in pair]
    for i, (g_, w_) in enumerate(zip(got, want)):
        assert _close(g_, w_), i
    cot = [_rand(gen, *t.shape) for t in want]
    first = torch.autograd.grad(got, leaves, cot, retain_graph=True)
    second = torch.autograd.grad(got, leaves, cot)
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(kernels, before)] == [1, 2]
    grads_p = torch.autograd.grad(want, leaves, cot)
    for i, (g1, g2, gp) in enumerate(zip(first, second, grads_p)):
        assert _close(g1, gp), i
        assert torch.equal(g1, g2), i


def test_gated_segment_backward_with_unused_outputs(dev):
    """Only the last level's horizontal output and the first level's
    vertical one reach the loss: the others' cotangents arrive as None."""
    gen = torch.Generator(device=dev).manual_seed(17)
    xv0, xh0, sk, cond, ws = _level_case(gen, 2, 8, 8, 3, 32, True)
    leaves = [xv0, xh0, cond, *(t for wl in ws for t in wl.values()),
              *(t for pair in sk for t in pair)]
    for t in leaves:
        t.requires_grad_(True)
    kw = dict(seed=9, base_pair=4, keep=0.5)
    got = gc.gated_segment(xv0, xh0, sk, cond, ws, **kw)
    want = gc.gated_segment_plain(xv0, xh0, sk, cond, ws, **kw)
    loss = lambda outs: (outs[-1][1] ** 2).sum() + outs[0][0].sum()
    grads_k = torch.autograd.grad(loss(got), leaves)
    grads_p = torch.autograd.grad(loss(want), leaves)
    for name, gk, gp in zip(_leaf_names(ws, sk), grads_k, grads_p):
        assert _close(gk, gp), name


def test_gated_gemm_core_keeps_float32_operands_that_tf32_rounds(dev):
    """Operands exact in float32 but not in TF32 (1 + 2^-12 rounds to 1 in
    TF32's 10 fraction bits), on the A side (the input's first 8 channels)
    and the B side (conv_a's weight rows 8-15): the pair forward's conv_a
    product a1v against float64. No product has two such operands and every
    sum stays below 2^8 at a resolution of 2^-13, so the float32 result is
    exact and the 3xTF32 split reaches it; one TF32 pass would be off by
    ~1e-4 of scale."""
    gen = torch.Generator(device=dev).manual_seed(41)
    b, h, w, cd = 2, 7, 7, 16
    xv0, xh0, _, cond, ws = _level_case(gen, b, h, w, 1, cd, False)
    odd = 1.0 + 2.0 ** -12
    pos = (torch.arange(b * h * w, device=dev) % 3).reshape(b, h, w, 1)
    c = torch.arange(8, device=dev)
    x = torch.zeros(b, h, w, F, device=dev)
    x[..., :8] = torch.where((c + pos) % 2 == 0, odd, 1.0)
    x[..., 8:16] = torch.where((c + pos) % 2 == 0, 2.0, 1.0)
    k, n = torch.arange(8, device=dev)[:, None], torch.arange(F, device=dev)[None, :]
    taps = gc.chain_taps()
    wav = torch.zeros(taps[0].skh * taps[0].skw, 2 * F, F, device=dev)
    wav[:, :8] = torch.tensor([1.0, -1.0, 2.0, 0.5], device=dev)[(k + n) % 4]
    wav[:, 8:16] = torch.where((k + n) % 2 == 0, odd, -odd)
    wav *= torch.tensor([(-1.0) ** t for t in range(wav.shape[0])], device=dev)[:, None, None]
    ws[0]["wav"] = wav.reshape(-1, F).contiguous()
    ws[0]["bav"] = torch.zeros(F, device=dev)
    cfg = gc.StreamConfig(x, cond, 1, False, 1.0, 5, 0, taps)
    got = gc.pair_fwd(cfg, x, xh0, None, cond, ws)[0]["a1v"].reshape(-1, F).double()
    torch.cuda.synchronize()
    want = gc._conv_taps(gc._concat_elu(x.double()), ws[0]["wav"].double(), taps[0])
    assert want.abs().max().item() < 2.0 ** 8
    assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()


# Row counts that leave the GEMM core's 64-row tiles ragged (75 rows: one
# full tile and 11 rows), the stream and a segment, up and down, with
# dropout: outputs and every gradient against autograd through the plain
# version.
@pytest.mark.parametrize("down", [False, True], ids=["up", "down"])
@pytest.mark.parametrize("mode", ["segment", "stream"])
def test_gated_chain_kernels_with_ragged_row_tiles(dev, mode, down):
    gen = torch.Generator(device=dev).manual_seed(75 + down)
    b, h, w, n_lvl = 5, 3, 5, 3
    xv0, xh0, sk, cond, ws = _level_case(gen, b, h, w, n_lvl, 32, down)
    if mode == "stream":
        ws = [{k: torch.stack([wl[k] for wl in ws]) for k in ws[0]}]
        sk = (torch.stack([p[0] for p in sk]), torch.stack([p[1] for p in sk])) if down else None
        skl = list(sk) if down else []
    else:
        skl = [t for pair in (sk or ()) for t in pair]
    leaves = [xv0, xh0, cond, *(t for wl in ws for t in wl.values()), *skl]
    for t in leaves:
        t.requires_grad_(True)
    kw = dict(seed=11, base_pair=12 if down else 0, keep=0.5)
    if mode == "stream":
        got = list(gc.gated_stream(xv0, xh0, sk, cond, ws[0], **kw))
        want = list(gc.gated_stream_plain(xv0, xh0, sk, cond, ws[0], **kw))
    else:
        got = [t for pair in gc.gated_segment(xv0, xh0, sk, cond, ws, **kw) for t in pair]
        want = [t for pair in gc.gated_segment_plain(xv0, xh0, sk, cond, ws, **kw)
                for t in pair]
    for i, (g_, w_) in enumerate(zip(got, want)):
        assert _close(g_, w_), i
    cot = [_rand(gen, *t.shape) for t in want]
    grads_k = torch.autograd.grad(got, leaves, cot)
    torch.cuda.synchronize()
    grads_p = torch.autograd.grad(want, leaves, cot)
    for i, (gk, gp) in enumerate(zip(grads_k, grads_p)):
        assert _close(gk, gp), i


def test_gated_level_wrappers_refuse_masks_and_widths(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    xv0, xh0, _, cond, ws = _level_case(gen, 2, 4, 4, 1, 16, False)
    masks = (torch.ones(2, 4, 4, 256, device=dev),) * 2
    with pytest.raises(ValueError, match="injected masks"):
        gc.gated_pair(xv0, xh0, None, cond, ws[0], seed=0, pair_index=0, keep=0.5, masks=masks)
    # 96 filters: a width the kernels are not built for
    narrow = {n: t[..., :96] for n, t in ws[0].items()}
    with pytest.raises(ValueError, match=r"num_filters in \(64, 128\), got 96"):
        gc.gated_segment(xv0[..., :96], xh0[..., :96], None, cond, [narrow], seed=0,
                         base_pair=0, keep=1.0)
    with pytest.raises(ValueError, match=r"vrow kernel is built for num_filters in \(64, 128\)"):
        sc.vrow(*_vrow_inputs(gen, 4, 4, 5, F=96))
    with pytest.raises(ValueError, match=r"row kernel is built for num_filters in \(64, 128\)"):
        sc.row(*_row_inputs(gen, 4, 4, 5, 128, F=96))
    with pytest.raises(ValueError, match="num_indices % 128 == 0, got 192"):
        sc.row(*_row_inputs(gen, 4, 4, 5, 192, F=64))


# A small PM-VQVAE at PM-VQVAE MNIST's geometry (28x28x1 images, 7x7 codes,
# 128 filters), 3 resnet levels: segments of 2 leave a remainder of 1.
SMALL_VQ = {"output_channels": 1, "embedding_dim": 16, "num_embeddings": 32,
            "hidden_units": 16, "residual_blocks": 1, "residual_hidden_units": 8,
            "decay": 0.99, "use_ema": True, "commitment_cost": 0.25}
SMALL_PC = {"image_shape": (7, 7), "num_resnet": 3, "num_hierarchies": 1,
            "num_filters": 128, "dropout": 0.5, "num_indices": 32}


@pytest.mark.parametrize("chain_segment,launches", [("stream", (2, 0, 0)), (1, (0, 6, 0)),
                                                    (2, (0, 0, 4))])
def test_pm_vqvae_step_per_chain_mode_matches_cpu(dev, chain_segment, launches):
    """The loss and gradients of a training step through each mode's
    kernels against the plain path on the CPU (the same hash masks)."""
    _step_matches_cpu(dev, SMALL_VQ, SMALL_PC, 24, (28, 28, 1), chain_segment, launches)


# pm_vqvae_digits16's PixelCNN whole (4x4 codes, 6 resnet levels of 64
# filters, 128 codes, a 256-wide condition) over a narrow VQ-VAE of 16x16x1
# images: the pair and segment modes' launches (12 and, in segments of 4
# and 2, 4 a direction).
DIGITS16_VQ = {**SMALL_VQ, "num_embeddings": 128}
DIGITS16_PC = {"image_shape": (4, 4), "num_resnet": 6, "num_hierarchies": 1,
               "num_filters": 64, "dropout": 0.5, "num_indices": 128}


@pytest.mark.parametrize("chain_segment,launches", [("stream", (2, 0, 0)), (1, (0, 12, 0)),
                                                    (4, (0, 0, 4))])
def test_pm_vqvae_digits16_step_per_chain_mode_matches_cpu(dev, chain_segment, launches):
    _step_matches_cpu(dev, DIGITS16_VQ, DIGITS16_PC, 256, (16, 16, 1), chain_segment,
                      launches)


def _step_matches_cpu(dev, vq_cfg, pc_cfg, cd, image, chain_segment, launches):
    from posterior_matching_torch import convert
    from posterior_matching_torch.train.trainer import pm_vqvae_loss

    params, state = convert.random_pm_vqvae_tree(cd, vq_cfg, pc_cfg, seed=4)
    g = torch.Generator().manual_seed(5)
    x = torch.rand(3, *image, generator=g)
    b = (torch.rand(3, *image, generator=g) > 0.5).float()
    counters = (gc.stream_bwd, gc.pair_bwd, gc.seg_bwd)
    out = {}
    for d in (dev, torch.device("cpu")):
        m = convert.pm_vqvae_from_jax(params, state, cd, vq_cfg, pc_cfg, device=d,
                                      chain_segment=chain_segment)
        names, ps = zip(*[(n, p) for n, p in m.named_parameters()
                          if not n.startswith("vqvae.")])
        before = [c.launches for c in counters]
        loss = pm_vqvae_loss(m, {"image": x.to(d), "mask": b.to(d)}, 77, True)
        grads = torch.autograd.grad(loss, ps)
        out[d.type] = (loss.item(), [gr.cpu() for gr in grads],
                       tuple(c.launches - n for c, n in zip(counters, before)))
    (lg, gg, launched), (lc, gcpu, _) = out["cuda"], out["cpu"]
    assert launched == launches
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for a, w_ in zip(gg, gcpu):
        assert _close(a, w_)


def _block_chain_case(gen, b, h, w, L, k, c=192, m=48):
    weights = {n: _rand(gen, L, *s, scale=s[0] ** -0.5) for n, s in bc.weight_shapes(c, m, k)}
    return _rand(gen, b, h, w, c), weights


@pytest.mark.parametrize("c,m", bc.KERNEL_WIDTHS)
@pytest.mark.parametrize("b,h,w,L,k", [(2, 7, 5, 3, 3), (3, 1, 1, 2, 1), (20, 9, 9, 2, 3)])
def test_block_chain_kernels_match_plain(dev, b, h, w, L, k, c, m):
    gen = torch.Generator(device=dev).manual_seed(b * 100 + h + L + c)
    x, weights = _block_chain_case(gen, b, h, w, L, k, c, m)
    leaves = [x, *(weights[n] for n in bc.NAMES)]
    for t in leaves:
        t.requires_grad_(True)
    f0, b0 = bc.chain_fwd.launches, bc.chain_bwd.launches
    got = bc.block_chain(x, weights, mid=m, k=k)
    want = bc.block_chain_plain(x, weights, mid=m, k=k)
    assert got.shape == x.shape and _close(got, want)
    cot = _rand(gen, *x.shape)
    grads_k = torch.autograd.grad(got, leaves, cot)
    torch.cuda.synchronize()
    assert bc.chain_fwd.launches == f0 + 1 and bc.chain_bwd.launches == b0 + 1
    grads_p = torch.autograd.grad(want, leaves, cot)
    for name, gk, gp in zip(("x", *bc.NAMES), grads_k, grads_p):
        assert _close(gk, gp), name


def test_block_chain_kernels_relaunch_bit_for_bit_at_res28(dev):
    """The encoder's res-28 run of a PM-VDVAE MNIST training batch (16 x 28
    x 28 rows, 6 levels, 3x3): both kernels launched twice on the same
    inputs give the same bits (the weight gradients' row splits are added
    in a fixed order)."""
    gen = torch.Generator(device=dev).manual_seed(28)
    x, weights = _block_chain_case(gen, 16, 28, 28, 6, 3)
    cfg = bc.ChainConfig(x, 6, 48, 3)
    x0 = x.reshape(cfg.rows, 192)
    g = _rand(gen, cfg.rows, 192)
    wk = {n: weights[n] for n in ("w1", "w2", "w3", "w4")}
    with torch.no_grad():
        outs = [bc.chain_fwd(cfg, x0, weights) for _ in range(2)]
        grads = [bc.chain_bwd(cfg, g, {"x0": x0, **outs[0]}, wk) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in (outs, grads):
        for name in a:
            assert torch.isfinite(a[name]).all() and torch.equal(a[name], b[name]), name


def test_block_chain_core_keeps_float32_operands_that_tf32_rounds(dev):
    """Operands exact in float32 but not in TF32 (1 + 2^-12 rounds to 1 in
    TF32's 10 fraction bits) through both of the block chain's products, in
    the backward of a one-level run (2 x 5 x 5 rows, 3x3), with the saved h3
    at 16 or 16 (1 + 2^-12), where gelu is the identity and gelu' is 1 in
    float32: dh3 = gelu'(h3) (g @ w4^T), summed into db3 (dgemm, g on the A
    side, w4 on the B side), and dw4 = gelu(h3)^T g (wgrad, h3 on the A
    side, g on the B side). No product has two such operands (h3's odd
    values lie on even rows, g's on odd rows), and every sum stays below
    2^11 at a resolution of 2^-13 (db3's below 2^8), so the float32 results
    are exact and the 3xTF32 split reaches them; one TF32 pass would be off
    by ~5e-5 of scale. Against float64 at 1e-6."""
    gen = torch.Generator(device=dev).manual_seed(41)
    b, h, w, c, m = 2, 5, 5, 192, 48
    x, weights = _block_chain_case(gen, b, h, w, 1, 3, c, m)
    cfg = bc.ChainConfig(x, 1, m, 3)
    R, odd = cfg.rows, 1.0 + 2.0 ** -12
    rows = torch.arange(R, device=dev)[:, None]
    k8 = torch.arange(8, device=dev)[None, :]
    # g: odd values in columns 0-7 of the odd rows, 2 or 1 in columns 8-15
    g = torch.zeros(R, c, device=dev)
    g[:, :8] = torch.where((rows % 2 == 1) & ((rows + k8) % 3 == 0), odd, 1.0)
    g[:, 8:16] = torch.where((rows + k8) % 2 == 0, 2.0, 1.0)
    # w4 [m, c]: B(k = channel of g, n) = w4[n, k]; exact values against g's
    # odd columns, odd values against its columns 8-15
    n = torch.arange(m, device=dev)[:, None]
    w4 = torch.zeros(m, c, device=dev)
    w4[:, :8] = torch.tensor([1.0, -1.0, 2.0, 0.5], device=dev)[(n + k8) % 4]
    w4[:, 8:16] = torch.where((n + k8) % 2 == 0, odd, -odd)
    # h3: 16 (1 + 2^-12) on some channels of the even rows, else 16
    ch = torch.arange(m, device=dev)[None, :]
    h3 = torch.where((rows % 2 == 0) & ((rows + ch) % 3 == 0), 16.0 * odd, 16.0)
    x0 = x.reshape(R, c)
    wk = {"w1": weights["w1"], "w2": weights["w2"], "w3": weights["w3"], "w4": w4[None]}
    with torch.no_grad():
        saved = {"x0": x0, **bc.chain_fwd(cfg, x0, dict(weights, w4=w4[None]))}
        saved["h3"] = h3[None].contiguous()
        grads = bc.chain_bwd(cfg, g, saved, wk)
    torch.cuda.synchronize()
    want_b3 = (g.double() @ w4.double().T).sum(0)
    want_w4 = h3.double().T @ g.double()
    for got, want in ((grads["db3"][0, 0].double(), want_b3),
                      (grads["dw4"][0].double(), want_w4)):
        assert want.abs().max().item() < 2.0 ** 11
        assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()


def test_block_chain_conv_taps_keep_float32_operands_that_tf32_rounds(dev):
    """The block chain's 3x3 stacks on operands exact in float32 but not in
    TF32 (1 + 2^-12), in a one-level run of two 5 x 5 images: the forward's
    c2 (dgemm's halo-staged taps) with w1 zero, so that h1 = b1, 16 or
    16 (1 + 2^-12) by channel (gelu is the identity there), and w2 odd only
    on the rows of the channels where h1 is 16; and the backward's dw3
    (wgrad_taps) from a saved h2 of 16 or 16 (1 + 2^-12) on the first
    image only and dh3 = g @ w4^T (h3 = 16, gelu' = 1) odd on the second
    image only (g and w4 as in the test above: taps never cross images).
    No product has two such operands and every sum stays below 2^14 at a
    resolution of 2^-9, so the float32 results are exact and the 3xTF32
    split reaches them; one TF32 pass would be off by ~1e-4 of scale.
    Against float64 at 1e-6."""
    gen = torch.Generator(device=dev).manual_seed(43)
    b, h, w, c, m = 2, 5, 5, 192, 48
    x, weights = _block_chain_case(gen, b, h, w, 1, 3, c, m)
    cfg = bc.ChainConfig(x, 1, m, 3)
    R, odd = cfg.rows, 1.0 + 2.0 ** -12
    ch = torch.arange(m, device=dev)
    # forward: h1 = b1, odd on the even channels; w2 [9 m, m] exact on their
    # rows, odd on the others', every entry positive
    tap_row = torch.arange(9 * m, device=dev)[:, None]
    col = ch[None, :]
    chan = tap_row % m
    w2 = torch.where(chan % 2 == 0,
                     torch.tensor([1.0, 2.0, 0.5], device=dev)[(tap_row + col) % 3],
                     odd * torch.tensor([1.0, 2.0], device=dev)[(tap_row + col) % 2])
    b1 = torch.where(ch % 2 == 0, 16.0 * odd, 16.0)
    fw = dict(weights, w1=torch.zeros_like(weights["w1"]), b1=b1[None, None].contiguous(),
              w2=w2[None].contiguous(), b2=torch.zeros_like(weights["b2"]))
    x0 = x.reshape(R, c)
    with torch.no_grad():
        saved = {"x0": x0, **bc.chain_fwd(cfg, x0, fw)}
    h1 = b1.double().cpu().expand(b, h, w, m)
    want_h2 = bc.conv_taps(h1, w2.double().cpu(), 3).reshape(R, m)
    # backward: g and w4 put dh3 = s on the first image's rows and
    # +-s (1 + 2^-12) on the second's (s = 1 or 2); h2 odd on the first's
    rows = torch.arange(R, device=dev)[:, None]
    first = rows < R // 2
    s = 1.0 + (rows % 2).float()
    g = torch.zeros(R, c, device=dev)
    g[:, :1] = torch.where(first, s, 0.0)
    g[:, 1:2] = torch.where(first, 0.0, s)
    w4 = torch.zeros(m, c, device=dev)
    w4[:, 0] = 1.0
    w4[:, 1] = torch.where(ch % 2 == 0, odd, -odd)
    got_h2 = saved["h2"][0].double().cpu()
    saved["h2"] = torch.where(first & ((rows + ch) % 3 == 0), 16.0 * odd, 16.0)[None].contiguous()
    saved["h3"] = torch.full_like(saved["h3"], 16.0)
    wk = {"w1": fw["w1"], "w2": fw["w2"], "w3": weights["w3"], "w4": w4[None]}
    with torch.no_grad():
        grads = bc.chain_bwd(cfg, g, saved, wk)
    torch.cuda.synchronize()
    w3 = torch.zeros(9 * m, m, dtype=torch.float64, requires_grad=True)
    out = bc.conv_taps(saved["h2"][0].double().cpu().reshape(b, h, w, m), w3, 3)
    dh3 = (g.double() @ w4.double().T).cpu().reshape(b, h, w, m)
    want_w3, = torch.autograd.grad(out, w3, dh3)
    for got, want in ((got_h2, want_h2),
                      (grads["dw3"][0].double().cpu(), want_w3)):
        assert want.abs().max().item() < 2.0 ** 14
        assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()


def test_block_chain_wrappers_refuse_unsupported_inputs(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    x, weights = _block_chain_case(gen, 2, 4, 4, 2, 3)
    cfg = bc.ChainConfig(x, 2, 48, 3)
    flat = x.reshape(-1, 192)
    with pytest.raises(ValueError, match="contiguous"):
        bc.chain_fwd(cfg, flat.t().contiguous().t(), weights)
    with pytest.raises(ValueError, match="w2"):
        bc.chain_fwd(cfg, flat, dict(weights, w2=weights["w2"][:, :9 * 40].contiguous()))
    with pytest.raises(ValueError, match="width"):
        bc.block_chain(x[..., :64].contiguous(),
                       {n: t[..., :64] if n in ("w4", "b4") else t for n, t in weights.items()},
                       mid=48, k=3)


# configs/pm_vdvae_digits16.py's model block: the width-64 pair of the
# block-chain kernels, at every run shape of its encoder.
DIGITS16 = {"image_shape": (16, 16, 1), "encoder_blocks": "16x3,16d2,8x3,8d2,4x2,4d4,1x2",
            "decoder_blocks": "1x2,4m1,4x2,8m4,8x3,16m8,16x3", "latent_dim": 8, "width": 64,
            "bottleneck_multiple": 0.25, "no_bias_above": 32, "num_mixtures": 5}


def _decoder_chain_case(gen, b, h, w, L, k, c, m, ld):
    weights = {n: _rand(gen, L, *s, scale=s[0] ** -0.5)
               for n, s in dc.weight_shapes(c, c, m, ld, k)}
    ins = [_rand(gen, b, h, w, c) for _ in range(3)]
    return ins, _rand(gen, L, b, h, w, ld), weights


@pytest.mark.parametrize("c,m,ld", dc.KERNEL_GEOMETRIES)
@pytest.mark.parametrize("b,h,w,L,k,all_cots", [
    (2, 7, 5, 3, 3, True), (8, 1, 1, 2, 1, True), (20, 9, 9, 2, 3, True),
    (2, 7, 5, 2, 3, False)])
def test_decoder_chain_kernels_match_plain(dev, b, h, w, L, k, all_cots, c, m, ld):
    gen = torch.Generator(device=dev).manual_seed(b * 100 + h + L + c)
    (x0, acts, macts), eps, weights = _decoder_chain_case(gen, b, h, w, L, k, c, m, ld)
    leaves = [x0, acts, macts, *(weights[n] for n in dc.NAMES)]
    for t in leaves:
        t.requires_grad_(True)
    f0, b0 = dc.dec_fwd.launches, dc.dec_bwd.launches
    got = dc.dec_chain(x0, acts, macts, eps, weights, mid=m, ld=ld, k=k)
    want = dc.dec_chain_plain(x0, acts, macts, eps, weights, ld=ld, k=k)
    for name, g_, w_ in zip(("x_final", "post", "prior", "masked"), got, want):
        assert g_.shape == w_.shape and _close(g_, w_), name
    # with all_cots every output carries a cotangent; else x_final's alone,
    # and the backward sees zeros for the heads
    outs = (got, want) if all_cots else ((got[0],), (want[0],))
    cots = [_rand(gen, *t.shape) for t in outs[1]]
    grads_k = torch.autograd.grad(outs[0], leaves, cots)
    torch.cuda.synchronize()
    assert dc.dec_fwd.launches == f0 + 1 and dc.dec_bwd.launches == b0 + 1
    # the masked Block's weights and macts reach only `masked`: without its
    # cotangent their gradients are zero
    grads_p = torch.autograd.grad(outs[1], leaves, cots, allow_unused=True)
    for name, gk, gp, t in zip(("x0", "acts", "macts", *dc.NAMES), grads_k, grads_p, leaves):
        assert _close(gk, torch.zeros_like(t) if gp is None else gp), name


def _dec_flat(cfg, x0, acts, macts, eps, weights):
    """The wrappers' flat inputs of a run."""
    R, L = cfg.rows, cfg.n_levels
    return {"x0": x0.reshape(R, -1), "acts": acts.reshape(R, -1),
            "macts": macts.reshape(R, -1), "eps": eps.reshape(L, R, -1),
            **{n: weights[n].contiguous() for n in dc.NAMES}}


def test_decoder_chain_kernels_relaunch_bit_for_bit_at_res28(dev):
    """The res-28 run of a PM-VDVAE MNIST training batch (16 x 28 x 28
    rows, 7 levels, 3x3): both kernels launched twice on the same inputs
    give the same bits (the weight gradients' row splits are added in a
    fixed order)."""
    gen = torch.Generator(device=dev).manual_seed(28)
    (x0, acts, macts), eps, weights = _decoder_chain_case(gen, 16, 28, 28, 7, 3, 192, 48, 16)
    cfg = dc.DecConfig(x0, acts, 7, 48, 16, 3)
    inputs = _dec_flat(cfg, x0, acts, macts, eps, weights)
    shapes = cfg.shapes()
    cots = {"g": _rand(gen, *shapes["x0"]), "gpost": _rand(gen, *shapes["post"]),
            "gprior": _rand(gen, *shapes["prior"]), "gmask": _rand(gen, *shapes["masked"])}
    w = {n: inputs[n] for n in dc.NAMES}
    with torch.no_grad():
        outs = [dc.dec_fwd(cfg, inputs) for _ in range(2)]
        saved = {n: {**inputs, **outs[0]}[n] for n in dc._SAVED}
        grads = [dc.dec_bwd(cfg, cots, saved, w) for _ in range(2)]
    torch.cuda.synchronize()
    for name in outs[0]:
        assert torch.isfinite(outs[0][name]).all() and torch.equal(outs[0][name], outs[1][name]), name
    for name in grads[0]:
        assert torch.isfinite(grads[0][name]).all() and torch.equal(grads[0][name], grads[1][name]), name


def test_decoder_gemm_core_keeps_float32_operands_that_tf32_rounds(dev):
    """Operands exact in float32 but not in TF32 (1 + 2^-12 rounds to 1 in
    TF32's 10 fraction bits) through both of the decoder's products, in the
    backward of a one-level run (2 x 5 x 5 rows, 3x3): the resnet Block's
    dh3 = gelu'(h3) (g @ r_w4^T) with the saved h3 zero (gelu'(0) = 1/2),
    summed into r_b3's gradient (dgemm, g on the A side, r_w4 on the B
    side), and dwz = z^T du with eps zero (z = loc) and r_w1 zero (du = g)
    (wgrad, loc on the A side, g on the B side). No product has two such
    operands, and every sum stays below 2^10 at a resolution of 2^-14, so
    the float32 results are exact and the 3xTF32 split reaches them; one
    TF32 pass would be off by ~1e-4 of scale. Against float64 at 1e-6."""
    gen = torch.Generator(device=dev).manual_seed(42)
    b, h, w, c, m, ld = 2, 5, 5, 192, 48, 16
    (x0, acts, macts), eps, weights = _decoder_chain_case(gen, b, h, w, 1, 3, c, m, ld)
    cfg = dc.DecConfig(x0, acts, 1, m, ld, 3)
    R, odd = cfg.rows, 1.0 + 2.0 ** -12
    rows = torch.arange(R, device=dev)[:, None]
    k8 = torch.arange(8, device=dev)[None, :]
    # g: odd values in columns 0-7 of the odd rows, 2 or 1 in columns 8-15
    g = torch.zeros(R, c, device=dev)
    g[:, :8] = torch.where((rows % 2 == 1) & ((rows + k8) % 3 == 0), odd, 1.0)
    g[:, 8:16] = torch.where((rows + k8) % 2 == 0, 2.0, 1.0)
    # r_w4 [m, c]: B(k = channel of g, n) = r_w4[n, k]; exact values against
    # g's odd columns, odd values against its columns 8-15
    n = torch.arange(m, device=dev)[:, None]
    w4 = torch.zeros(m, c, device=dev)
    w4[:, :8] = torch.tensor([1.0, -1.0, 2.0, 0.5], device=dev)[(n + k8) % 4]
    w4[:, 8:16] = torch.where((n + k8) % 2 == 0, odd, -odd)
    # loc: odd values on the even rows only
    loc = torch.where((rows % 2 == 0) & ((rows + torch.arange(ld, device=dev)) % 3 == 0), odd,
                      torch.where((rows + torch.arange(ld, device=dev)) % 2 == 0, 1.0, -0.5))
    inputs = _dec_flat(cfg, x0, acts, macts, torch.zeros_like(eps), weights)
    inputs["r_w4"] = w4[None].contiguous()
    inputs["r_w1"] = torch.zeros_like(inputs["r_w1"])
    with torch.no_grad():
        saved = {**inputs, **dc.dec_fwd(cfg, inputs)}
    saved["rh3"] = torch.zeros_like(saved["rh3"])
    saved["u"] = torch.zeros_like(saved["u"])
    saved["post"] = torch.cat([loc, torch.randn(R, ld, generator=gen, device=dev)], -1)[None]
    shapes = cfg.shapes()
    cots = {"g": g, "gpost": torch.zeros(shapes["post"], device=dev),
            "gprior": torch.zeros(shapes["prior"], device=dev),
            "gmask": torch.zeros(shapes["masked"], device=dev)}
    with torch.no_grad():
        grads = dc.dec_bwd(cfg, cots, {n: saved[n].contiguous() for n in dc._SAVED},
                           {n: inputs[n] for n in dc.NAMES})
    torch.cuda.synchronize()
    want_b3 = (0.5 * g.double() @ w4.double().T).sum(0)
    want_wz = loc.double().T @ g.double()
    for got, want in ((grads["dr_b3"][0].double(), want_b3), (grads["dwz"][0].double(), want_wz)):
        assert want.abs().max().item() < 2.0 ** 10
        assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()


def test_decoder_chain_wrappers_refuse_unsupported_inputs(dev):
    gen = torch.Generator(device=dev).manual_seed(4)
    (x0, acts, macts), eps, weights = _decoder_chain_case(gen, 2, 4, 4, 2, 3, 192, 48, 16)
    with pytest.raises(ValueError, match="width"):
        dc.dec_chain(x0, acts, macts, eps, weights, mid=40, ld=16, k=3)
    with pytest.raises(ValueError, match="as wide as the state"):
        dc.dec_chain(x0, acts[..., :64].contiguous(), macts, eps, weights, mid=48, ld=16, k=3)
    with pytest.raises(ValueError, match="q_w4"):
        dc.dec_chain(x0, acts, macts, eps, dict(weights, q_w4=weights["q_w4"][..., :100]),
                     mid=48, ld=16, k=3)


# configs/pm_vdvae_digits16.py's model block: the width-64 geometry of the
# chain kernels, at every run shape of its encoder and decoder.
DIGITS16 = {"image_shape": (16, 16, 1), "encoder_blocks": "16x3,16d2,8x3,8d2,4x2,4d4,1x2",
            "decoder_blocks": "1x2,4m1,4x2,8m4,8x3,16m8,16x3", "latent_dim": 8, "width": 64,
            "bottleneck_multiple": 0.25, "no_bias_above": 32, "num_mixtures": 5}


@pytest.mark.parametrize("fused_chain", [None, True])
def test_pm_vdvae_digits16_step_matches_cpu(dev, fused_chain):
    """The loss and gradients of a digits16 step through the kernels against
    the plain path on the CPU, the same normals: 4 block-chain runs in each
    encoder and, fused, 3 decoder runs (the 1x2 run's 4 rows stay unfused)."""
    from posterior_matching_torch import convert
    from posterior_matching_torch.models.vdvae import parse_layer_string
    from posterior_matching_torch.train.trainer import pm_vdvae_loss

    config = dict(DIGITS16, fused_chain=fused_chain)
    tree = convert.random_pm_vdvae_tree(config, seed=5)
    g = torch.Generator().manual_seed(6)
    x = torch.randint(0, 256, (4, 16, 16, 1), generator=g).float()
    b = (torch.rand(4, 16, 16, 1, generator=g) > 0.5).float()
    eps = [torch.randn(4, r, r, 8, generator=g)
           for r, _ in parse_layer_string(DIGITS16["decoder_blocks"])]
    counters = (bc.chain_fwd, bc.chain_bwd, dc.dec_fwd, dc.dec_bwd)
    out = {}
    for d in (dev, torch.device("cpu")):
        m = convert.pm_vdvae_from_jax(tree, config, device=d)
        before = [c.launches for c in counters]
        loss = pm_vdvae_loss(m, {"image": x.to(d), "mask": b.to(d)}, iter(eps))
        grads = torch.autograd.grad(loss, list(m.parameters()))
        out[d.type] = (loss.item(), [gr.cpu() for gr in grads],
                       [c.launches - n for c, n in zip(counters, before)])
    (lg, gg, launches), (lc, gc_, _) = out["cuda"], out["cpu"]
    dec = 3 if fused_chain else 0
    assert launches == [8, 8, dec, dec]   # 4 runs of 2+ blocks, both encoders
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for a, w in zip(gg, gc_):
        assert _close(a, w)


# ---------------------------------------------------------------------------
# The VDVAE chains' bf16 builds (compute_dtype bfloat16)
# ---------------------------------------------------------------------------

# Both versions round the same float32 values to bf16. A value that lies
# within their float32 sums' difference (~1e-6) of a bf16 boundary rounds
# the other way (one ulp, 2^-8 of it), which moves the outputs of the
# products it enters by up to ~1e-3 of their scale, and each level carries
# that on. So each tensor within BF16_TOL of its scale (a wrong tap, mask
# or layout shows as O(1)). What shows that the products ran in bf16 is the
# saves: against the plain forward of the same level on the kernel's level
# input they are equal but for at most SAVE_FLIPS of them, where a level
# run in float32 would change a third of them (tests/test_torch_vdvae_
# bf16.py::test_saves_tell_bf16_from_float32). The backward kernel is held
# against the plain backward on the kernel's own saves; the whole through
# autograd within BF16_END_TOL.
BF16_TOL, SAVE_FLIPS, BF16_END_TOL = 5e-3, 0.05, 1e-2


def _bf16_close(got, want, tol=BF16_TOL):
    err = (got.float() - want.float().reshape(got.shape)).abs()
    return err.max().item() <= tol * max(1.0, want.abs().max().item())


def _saves_close(got, want):
    """bf16 saves equal to the plain level's values rounded but for at most
    SAVE_FLIPS of them, each within 2^-6 of the tensor's scale (a value
    rounded the other way, or a later product moved by an operand that
    was)."""
    got, want = got.float(), bc.round_bf16(want.reshape(got.shape))
    share = (got != want).float().mean().item()
    worst = (got - want).abs().max().item() / max(1e-30, want.abs().max().item())
    assert share <= SAVE_FLIPS and worst <= 2.0 ** -6, (share, worst)
    return True


@pytest.mark.parametrize("c,m", bc.KERNEL_WIDTHS)
@pytest.mark.parametrize("b,h,w,L,k", [(2, 7, 5, 3, 3), (16, 1, 1, 2, 1), (20, 9, 9, 2, 3)])
def test_bf16_block_chain_kernels_match_plain(dev, b, h, w, L, k, c, m):
    gen = torch.Generator(device=dev).manual_seed(b * 100 + h + L + c + 16)
    x, weights = _block_chain_case(gen, b, h, w, L, k, c, m)
    cfg = bc.ChainConfig(x, L, m, k, torch.bfloat16)
    R = cfg.rows
    x0, cot = x.reshape(R, c), _rand(gen, b, h, w, c)
    wk = {n: weights[n].to(cfg.dtype_of(n)).contiguous() for n in bc.NAMES}
    with torch.no_grad():
        outs = [bc.chain_fwd_bf16(cfg, x0, wk) for _ in range(2)]
        saved = {"x0": x0, **outs[0]}
        grads = [bc.chain_bwd_bf16(cfg, cot.reshape(R, c), saved, wk) for _ in range(2)]
        want = bc.block_chain_plain(x, weights, mid=m, k=k, compute_dtype=torch.bfloat16)
        shape = lambda t: t.reshape(L, b, h, w, -1).float()
        # each level's plain forward on the kernel's level input
        plain_saves = [bc.bf16_sub_fwd(shape(outs[0]["xout"])[lvl - 1] if lvl else x,
                                       {n: weights[n][lvl] for n in bc.NAMES}, k)[:3]
                       for lvl in range(L)]
        d_x0, d_w = bc.bf16_chain_bwd(x, shape(outs[0]["xout"]),
                                      [shape(outs[0][n]) for n in ("h1", "h2", "h3")],
                                      weights, cot, k)
    torch.cuda.synchronize()
    assert all(outs[0][n].dtype == torch.bfloat16 for n in ("h1", "h2", "h3"))
    assert _bf16_close(outs[0]["xout"][-1], want)
    for i, n in enumerate(("h1", "h2", "h3")):
        assert _saves_close(outs[0][n], torch.stack([s[i] for s in plain_saves]).reshape(L, R, m)), n
    assert _bf16_close(grads[0]["dx0"], d_x0.reshape(R, c))
    for n in bc.NAMES:
        assert grads[0]["d" + n].dtype == torch.float32 and _bf16_close(grads[0]["d" + n],
                                                                        d_w[n]), n
    for a, b_ in (outs, grads):
        for n in a:
            assert torch.equal(a[n], b_[n]), f"{n}: a relaunch changed the bits"
    # end to end through autograd, the bf16 build's counters
    leaves = [x, *(weights[n] for n in bc.NAMES)]
    for t in leaves:
        t.requires_grad_(True)
    f0, b0 = bc.chain_fwd_bf16.launches, bc.chain_bwd_bf16.launches
    got = bc.block_chain(x, weights, mid=m, k=k, compute_dtype=torch.bfloat16)
    grads_k = torch.autograd.grad(got, leaves, cot)
    assert bc.chain_fwd_bf16.launches == f0 + 1 and bc.chain_bwd_bf16.launches == b0 + 1
    plain = bc.block_chain_plain(x, weights, mid=m, k=k, compute_dtype=torch.bfloat16)
    for name, gk, gp in zip(("x", *bc.NAMES), grads_k, torch.autograd.grad(plain, leaves, cot)):
        assert _bf16_close(gk, gp, BF16_END_TOL), name


@pytest.mark.parametrize("c,m,ld", dc.KERNEL_GEOMETRIES)
@pytest.mark.parametrize("b,h,w,L,k", [(2, 7, 5, 3, 3), (16, 1, 1, 2, 1), (20, 9, 9, 2, 3)])
def test_bf16_decoder_chain_kernels_match_plain(dev, b, h, w, L, k, c, m, ld):
    gen = torch.Generator(device=dev).manual_seed(b * 100 + h + L + c + 17)
    (x0, acts, macts), eps, weights = _decoder_chain_case(gen, b, h, w, L, k, c, m, ld)
    cfg = dc.DecConfig(x0, acts, L, m, ld, k, torch.bfloat16)
    inputs = _dec_flat(cfg, x0, acts, macts, eps, weights)
    inputs.update({n: inputs[n].to(cfg.dtype_of(n)).contiguous() for n in dc.NAMES})
    shapes = cfg.shapes()
    cot5 = [_rand(gen, b, h, w, c), *(_rand(gen, L, b, h, w, shapes[n][-1])
                                      for n in ("post", "prior", "masked"))]
    cots = {"g": cot5[0].reshape(shapes["x0"]),
            **{g: t.reshape(shapes[n]) for g, n, t in zip(
                ("gpost", "gprior", "gmask"), ("post", "prior", "masked"), cot5[1:])}}
    wk = {n: inputs[n] for n in dc.NAMES}
    with torch.no_grad():
        outs = [dc.dec_fwd_bf16(cfg, inputs) for _ in range(2)]
        saved = {n: {**inputs, **outs[0]}[n] for n in cfg.saved}
        grads = [dc.dec_bwd_bf16(cfg, cots, saved, wk) for _ in range(2)]
        want = dc.dec_chain_plain(x0, acts, macts, eps, weights, ld=ld, k=k,
                                  compute_dtype=torch.bfloat16)
        shape = lambda t: t.reshape(L, b, h, w, -1).float()
        d_x0, d_acts, d_macts, d_w = dc.bf16_dec_chain_bwd(
            x0, acts, macts, eps, shape(outs[0]["xout"]),
            [shape(outs[0][s]) for s in dc.SAVES], weights, cot5, ld=ld, k=k)
    torch.cuda.synchronize()
    assert all(outs[0][s].dtype == torch.bfloat16 for s in dc.SAVES)
    for name, ref in zip(("xout", "post", "prior", "masked"), want):
        got = outs[0][name][-1] if name == "xout" else outs[0][name]
        assert _bf16_close(got, ref), name
    # each level's saves against its plain Blocks on the kernel's level
    # input and u
    with torch.no_grad():
        for lvl in range(L):
            x_in = shape(outs[0]["xout"])[lvl - 1] if lvl else x0
            wl = {n: weights[n][lvl] for n in dc.NAMES}
            blk = lambda tag: {n: wl[f"{tag}_{n}"] for n in bc.NAMES}
            for tag, inp in (("p", torch.cat([x_in, acts], -1)), ("m", torch.cat([x_in, macts], -1)),
                             ("q", x_in), ("r", shape(outs[0]["u"])[lvl])):
                for i, hs in enumerate(bc.bf16_sub_fwd(inp, blk(tag), k)[:3]):
                    assert _saves_close(outs[0][f"{tag}h{i + 1}"][lvl], hs.reshape(-1, m)), tag
    plain = {"dx0": d_x0, "dacts": d_acts, "dmacts": d_macts,
             **{"d" + n: d_w[n] for n in dc.NAMES}}
    for name, ref in plain.items():
        got = grads[0][name]
        assert got.dtype == torch.float32 and _bf16_close(got, ref.reshape(got.shape)), name
    for a, b_ in (outs, grads):
        for n in a:
            assert torch.equal(a[n], b_[n]), f"{n}: a relaunch changed the bits"
    # end to end through autograd, the bf16 build's counters
    leaves = [x0, acts, macts, *(weights[n] for n in dc.NAMES)]
    for t in leaves:
        t.requires_grad_(True)
    f0, b0 = dc.dec_fwd_bf16.launches, dc.dec_bwd_bf16.launches
    got = dc.dec_chain(x0, acts, macts, eps, weights, mid=m, ld=ld, k=k,
                       compute_dtype=torch.bfloat16)
    grads_k = torch.autograd.grad(got, leaves, cot5)
    assert dc.dec_fwd_bf16.launches == f0 + 1 and dc.dec_bwd_bf16.launches == b0 + 1
    ref = dc.dec_chain_plain(x0, acts, macts, eps, weights, ld=ld, k=k,
                             compute_dtype=torch.bfloat16)
    for name, gk, gp in zip(("x0", "acts", "macts", *dc.NAMES), grads_k,
                            torch.autograd.grad(ref, leaves, cot5)):
        assert _bf16_close(gk, gp, BF16_END_TOL), name


def test_bf16_chain_builds_refuse_float32_runs(dev):
    """A bf16 build refuses a float32 geometry, and a float32 build a bf16
    one (the geometry's BF flag), so no call reads one dtype as the other."""
    gen = torch.Generator(device=dev).manual_seed(9)
    x, weights = _block_chain_case(gen, 2, 4, 4, 2, 3)
    cfg = bc.ChainConfig(x, 2, 48, 3)
    cfg.fwd_lib = "block_chain_fwd_bf16"
    with pytest.raises(RuntimeError, match="block_chain_fwd_bf16"):
        bc.chain_fwd(cfg, x.reshape(cfg.rows, 192), weights)
    cfg16 = bc.ChainConfig(x, 2, 48, 3, torch.bfloat16)
    cfg16.fwd_lib = "block_chain_fwd"
    with pytest.raises(RuntimeError, match="block_chain_fwd"):
        bc.chain_fwd_bf16(cfg16, x.reshape(cfg.rows, 192),
                          {n: t.to(cfg16.dtype_of(n)) for n, t in weights.items()})


@pytest.mark.parametrize("fused_chain", [None, True])
def test_pm_vdvae_digits16_bf16_step_matches_cpu(dev, fused_chain):
    """A digits16 step at compute_dtype bfloat16 through the bf16 builds
    (unfused Blocks as bf16 cuBLAS / cuDNN products) against the plain path
    on the CPU, the same normals: the loss within 1e-3 relative, every
    gradient within 5e-2 of its scale (bf16 roundings at other places in the
    two libraries' unfused convolutions, and the chains' flipped saves)."""
    from posterior_matching_torch import convert
    from posterior_matching_torch.models.vdvae import parse_layer_string
    from posterior_matching_torch.train.trainer import pm_vdvae_loss

    config = dict(DIGITS16, fused_chain=fused_chain, compute_dtype="bfloat16")
    tree = convert.random_pm_vdvae_tree(config, seed=5)
    g = torch.Generator().manual_seed(6)
    x = torch.randint(0, 256, (4, 16, 16, 1), generator=g).float()
    b = (torch.rand(4, 16, 16, 1, generator=g) > 0.5).float()
    eps = [torch.randn(4, r, r, 8, generator=g)
           for r, _ in parse_layer_string(DIGITS16["decoder_blocks"])]
    counters = (bc.chain_fwd_bf16, bc.chain_bwd_bf16, dc.dec_fwd_bf16, dc.dec_bwd_bf16)
    out = {}
    for d in (dev, torch.device("cpu")):
        m = convert.pm_vdvae_from_jax(tree, config, device=d)
        before = [c.launches for c in counters]
        loss = pm_vdvae_loss(m, {"image": x.to(d), "mask": b.to(d)}, iter(eps))
        grads = torch.autograd.grad(loss, list(m.parameters()))
        out[d.type] = (loss.item(), [gr.cpu() for gr in grads],
                       [c.launches - n for c, n in zip(counters, before)])
    (lg, gg, launches), (lc, gc_, _) = out["cuda"], out["cpu"]
    # bf16 fuses runs of 16 rows or more: 16x3, 8x3 and 4x2 (64 rows) in
    # each encoder, not 1x2 (4 rows); fused, the decoder's 4-, 8- and 16-runs
    dec = 3 if fused_chain else 0
    assert launches == [6, 6, dec, dec]
    assert abs(lg - lc) <= 1e-3 * abs(lc)
    for a, w in zip(gg, gc_):
        assert _bf16_close(a, w, 5e-2)


# ---------------------------------------------------------------------------
# The gated chain's bf16 builds (the PM-VQVAE's compute_dtype bfloat16)
# ---------------------------------------------------------------------------

# As the VDVAE chains' bf16 builds, one bf16 ulp of a value rounded the other
# way moves the products it enters; here the residual stream itself is bf16
# and each level carries a flip on: each output and gradient within
# GATED_BF16_TOL of its scale at the worst (the JAX package's bf16 gradient
# tolerance) and GATED_BF16_MEAN on average.
GATED_BF16_TOL, GATED_BF16_MEAN = 2e-2, 2e-3


def _bf16_gated_run(mode, fn_plain, xv, xh, sk, cond, ws, keep, seed, base):
    kw = dict(keep=keep, seed=seed, compute_dtype=torch.bfloat16)
    if mode == "stream":
        skips = None if sk is None else tuple(torch.stack([p[i] for p in sk]) for i in (0, 1))
        fn = gc.gated_stream_plain if fn_plain else gc.gated_stream
        ov, oh = fn(xv, xh, skips, cond, gc.stack_levels(ws), base_pair=base, **kw)
        return [t for l in range(len(ws)) for t in (ov[l], oh[l])]
    if mode == "pair":
        fn = gc.gated_pair_plain if fn_plain else gc.gated_pair
        return list(fn(xv, xh, sk and sk[0], cond, ws[0], pair_index=base, **kw))
    fn = gc.gated_segment_plain if fn_plain else gc.gated_segment
    return [t for p in fn(xv, xh, sk, cond, ws, base_pair=base, **kw) for t in p]


@pytest.mark.parametrize("down", [False, True], ids=["up", "down"])
@pytest.mark.parametrize("mode", ["stream", "pair", "segment"])
@pytest.mark.parametrize("f,b,h,w", [(128, 8, 16, 16), (64, 32, 4, 4)])
def test_bf16_gated_kernels_match_plain(dev, f, b, h, w, mode, down):
    """Outputs and every gradient (inputs, skips, cond, weights) of the bf16
    builds through autograd against the plain bf16 version on the same
    device, 3 levels (a segment of 3 at 64 filters: the tail of digits16's
    segments of 4 and 2 has 2), keep 0.5; only the bf16 wrappers count."""
    gen = torch.Generator(device=dev).manual_seed(f + b + down)
    n_lvl = 1 if mode == "pair" else (2 if f == 64 else 3)
    xv, xh, sk, cond, ws = _level_case(gen, b, h, w, n_lvl, 64, down, f=f)
    for t in (cond, *(t for wl in ws for t in wl.values())):
        t.requires_grad_(True)
    xv, xh = (t.detach().to(torch.bfloat16).requires_grad_(True) for t in (xv, xh))
    if sk is not None:
        sk = [tuple(t.detach().to(torch.bfloat16).requires_grad_(True) for t in p) for p in sk]
    leaves = [xv, xh, cond, *(t for p in (sk or ()) for t in p),
              *(t for wl in ws for t in wl.values())]
    counters = [gc.stream_fwd, gc.stream_bwd, gc.pair_fwd, gc.pair_bwd, gc.seg_fwd, gc.seg_bwd]
    before = [c.launches for c in counters]
    b16 = {"stream": gc.stream_bwd_bf16, "pair": gc.pair_bwd_bf16, "segment": gc.seg_bwd_bf16}
    n16 = b16[mode].launches
    got = _bf16_gated_run(mode, False, xv, xh, sk, cond, ws, 0.5, 7, 3 * down)
    want = _bf16_gated_run(mode, True, xv, xh, sk, cond, ws, 0.5, 7, 3 * down)
    cots = [torch.randn(t.shape, generator=gen, device=dev).to(torch.bfloat16) for t in want]
    gk = torch.autograd.grad(got, leaves, cots)
    gp = torch.autograd.grad(want, leaves, cots)
    assert [c.launches for c in counters] == before
    assert b16[mode].launches == n16 + 1
    for a, c in zip([*got, *gk], [*want, *gp]):
        err = (a.float() - c.float()).abs()
        scale = max(1.0, c.float().abs().max().item())
        assert err.max().item() <= GATED_BF16_TOL * scale
        assert err.mean().item() <= GATED_BF16_MEAN * scale
    got2 = _bf16_gated_run(mode, False, xv, xh, sk, cond, ws, 0.5, 7, 3 * down)
    gk2 = torch.autograd.grad(got2, leaves, cots)
    assert all(torch.equal(a, c) for a, c in zip([*got, *gk], [*got2, *gk2]))


def test_bf16_gated_builds_refuse_float32_runs(dev):
    """A gated bf16 build refuses a float32 geometry (and its activations),
    the float32 build a bf16 one."""
    gen = torch.Generator(device=dev).manual_seed(3)
    xv, xh, sk, cond, ws = _level_case(gen, 2, 4, 4, 1, 16, False)
    cfg = gc.StreamConfig(xv, cond, 1, False, 1.0, 0, 0, gc.chain_taps())
    bad = gc._LevelsFwd("gated_pair_fwd", "gated_levels_fwd_bf16")
    with pytest.raises(RuntimeError, match="gated_pair_fwd"):
        bad(cfg, xv, xh, None, cond, ws)
    cfg16 = gc.StreamConfig(xv, cond, 1, False, 1.0, 0, 0, gc.chain_taps(), torch.bfloat16)
    bf = [gc._kernel_weights(cfg16, w) for w in ws]
    x16 = [t.to(torch.bfloat16) for t in (xv, xh)]
    with pytest.raises(RuntimeError, match="gated_pair_fwd"):
        gc._LevelsFwd("gated_pair_fwd")(cfg16, *x16, None, cond, bf)
    with pytest.raises(ValueError, match="xv0"):
        gc.pair_fwd_bf16(cfg16, xv, xh, None, cond, bf)


@pytest.mark.parametrize("chain_segment,launches", [("stream", (2, 0, 0)), (1, (0, 6, 0)),
                                                    (2, (0, 0, 4))])
def test_pm_vqvae_bf16_step_per_chain_mode_matches_cpu(dev, chain_segment, launches):
    """A bf16 training step through each mode's bf16 builds against the
    plain bf16 path on the CPU (the same hash masks): the loss within 1e-2,
    every gradient within GATED_BF16_TOL of its scale."""
    from posterior_matching_torch import convert
    from posterior_matching_torch.train.trainer import pm_vqvae_loss

    params, state = convert.random_pm_vqvae_tree(24, SMALL_VQ, SMALL_PC, seed=4)
    g = torch.Generator().manual_seed(5)
    x = torch.rand(3, 28, 28, 1, generator=g)
    b = (torch.rand(3, 28, 28, 1, generator=g) > 0.5).float()
    counters = (gc.stream_bwd_bf16, gc.pair_bwd_bf16, gc.seg_bwd_bf16)
    out = {}
    for d in (dev, torch.device("cpu")):
        m = convert.pm_vqvae_from_jax(params, state, 24, SMALL_VQ, SMALL_PC, device=d,
                                      chain_segment=chain_segment, compute_dtype="bfloat16")
        ps = [p for n, p in m.named_parameters() if not n.startswith("vqvae.")]
        before = [c.launches for c in counters]
        loss = pm_vqvae_loss(m, {"image": x.to(d), "mask": b.to(d)}, 77, True)
        grads = torch.autograd.grad(loss, ps)
        out[d.type] = (loss.item(), [gr.cpu() for gr in grads],
                       tuple(c.launches - n for c, n in zip(counters, before)))
    (lg, gg, launched), (lc, gcpu, _) = out["cuda"], out["cpu"]
    assert launched == launches
    assert abs(lg - lc) <= 1e-2 * abs(lc)
    for a, w_ in zip(gg, gcpu):
        assert (a - w_).abs().max().item() <= GATED_BF16_TOL * max(1.0, w_.abs().max().item())


def _bf16_sampler_inputs(dev, f, n_lvl, wid, n, k, lpg, seed=0):
    """Row 1's bf16 kernel arguments for a seeded PixelCNN on ``dev``."""
    torch.manual_seed(seed)
    pcnn = PixelCNN(num_indices=k, image_shape=(2, wid), dropout=0.0, num_resnet=n_lvl // 2,
                    num_filters=f, conditional_dim=32).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cond = torch.randn(n, 32, generator=gen, device=dev)
    return sc.row1_inputs(pcnn, cond, n, gen, "bfloat16", lpg)


# The flagship's depth (L 24, W 16) with a ragged last block of each kernel,
# a 256-column chunk at L 4, three 128-column chunks at lpg 3; at 64 filters
# digits16's row (L 12, W 4, K 128: half-stage chunks and h_init_left) and
# 128-column chunks at lpg 2.
@pytest.mark.parametrize("f,n_lvl,wid,n,k,lpg", [
    pytest.param(*c, id="-".join(map(str, c)))
    for c in ((128, 24, 16, 13, 512, 4), (128, 4, 7, 13, 256, 4), (128, 6, 3, 9, 384, 3),
              (64, 12, 4, 13, 128, 4), (64, 4, 7, 16, 384, 2))
])
def test_bf16_sampler_kernels_match_plain(dev, f, n_lvl, wid, n, k, lpg):
    vargs, rargs = _bf16_sampler_inputs(dev, f, n_lvl, wid, n, k, lpg)
    before = (sc.vrow.launches, sc.row.launches, sc.vrow_bf16.launches, sc.row_bf16.launches)
    v1, v2 = sc.vrow_bf16(*vargs), sc.vrow_bf16(*vargs)
    r1 = sc.row_bf16(*rargs, with_logits=True, lpg=lpg)
    r2 = sc.row_bf16(*rargs, with_logits=True, lpg=lpg)
    torch.cuda.synchronize()
    assert (sc.vrow.launches, sc.row.launches, sc.vrow_bf16.launches,
            sc.row_bf16.launches) == (*before[:2], before[2] + 2, before[3] + 2)
    assert all(t.dtype == torch.bfloat16 for t in (*v1, *r1[:2]))
    for a, b in zip((*v1, *r1), (*v2, *r2)):
        assert torch.equal(a, b)
    report = sc.vrow_bf16_report(v1, sc.vrow_plain(*vargs, compute_dtype="bfloat16"))
    assert sc.bf16_gate_ok(report), report
    want = sc.row_plain(*rargs, with_logits=True, compute_dtype="bfloat16", lpg=lpg)
    report = sc.row_bf16_report(r1, want, rargs[10], lpg)
    assert sc.bf16_gate_ok(report), report


def test_bf16_sampler_builds_refuse_the_other_dtype(dev):
    # the dtype int is checked before any pointer: a float32 call into a
    # bf16 build (and the reverse) is cudaErrorInvalidValue
    for name, bf16 in (("sampler_vrow_bf16", 0), ("sampler_vrow", 1)):
        lib = sc._load(name, "pm_sampler_vrow", 19, 5)
        assert lib.pm_sampler_vrow(*[None] * 19, 4, 16, 8, 128, bf16, None) == 1
    for name, bf16 in (("sampler_row_bf16", 0), ("sampler_row", 1)):
        lib = sc._load(name, "pm_sampler_row", 20, 7)
        assert lib.pm_sampler_row(*[None] * 20, 4, 16, 8, 512, 128, bf16, 4, None) == 1
    vargs, _ = _bf16_sampler_inputs(dev, 64, 2, 4, 3, 128, 2)
    with pytest.raises(ValueError, match="must be torch.float32"):
        sc.vrow(*vargs)


def test_bf16_request_launches_only_the_bf16_builds(dev):
    torch.manual_seed(0)
    pcnn = PixelCNN(num_indices=128, image_shape=(4, 4), dropout=0.0, num_resnet=2,
                    num_filters=64, conditional_dim=32).to(dev)
    cond = torch.randn(3, 32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    before = (sc.vrow.launches, sc.row.launches, sc.vrow_bf16.launches, sc.row_bf16.launches)
    out = sc.pixelcnn_sample(pcnn, 2, cond, generator=gen, compute_dtype="bfloat16")
    torch.cuda.synchronize()
    assert (sc.vrow.launches, sc.row.launches, sc.vrow_bf16.launches,
            sc.row_bf16.launches) == (*before[:2], before[2] + 4, before[3] + 4)
    assert out.shape == (2, 3, 4, 4) and 0 <= int(out.min()) and int(out.max()) < 128

"""The hand-written kernels against their plain PyTorch versions.

These need an NVIDIA GPU (sm_90a) and ``nvcc``; elsewhere they skip. On the
card: ``python -m pytest tests/test_torch_kernels_gpu.py -q -m cuda``. Shapes
are small but cover what the full-width smoke run does not: widths that do
not divide the vrow kernel's 32 row slots, sample counts that leave a
block's tile ragged, two logits chunks, the row kernel at full depth
(L = 24) and launched twice for bit-identical outputs; row counts that
leave the gated chain's 32-row tiles ragged, grids other than square; the
pair and segment kernels at the flagship's 16x16 and PM-VQVAE MNIST's 7x7
code grids, up and down, with and without dropout, a segment whose outputs
reach the loss only in part, and a small PM-VQVAE step per chain mode
(stream, pairs, segments with a remainder) against the CPU; latent counts that
leave the search's 32-row tiles ragged; block-chain and decoder-chain runs
whose rows leave the 32- to 256-row tiles ragged, 1x1 and 3x3 taps at the
image's edges, and runs long enough that their weight gradients sum two
1024-row splits, each at both compiled geometries; the decoder chain's
backward with every output's cotangent and with the state's alone; and a
digits16 PM-VDVAE step, with the block chain and with the decoder chain
too, against the CPU.
Tolerance: 1e-4 relative to the tensor's scale (float32 sums in another
order), for the chains' gradients too (their sums run over at most a few
thousand rows here).
"""
import pytest
import torch

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


def _vrow_inputs(gen, n_lvl, wid, n):
    s = 0.05
    return (
        _rand(gen, wid, n, F), _rand(gen, wid, n, F), _rand(gen, wid, n, F),
        _rand(gen, n_lvl, wid, n, F), _rand(gen, n_lvl, wid, n, 2 * F),
        _rand(gen, n_lvl, n, 2 * F),
        _rand(gen, 6 * F, F, scale=s), _rand(gen, F, scale=s),
        _rand(gen, 3 * F, F, scale=s), _rand(gen, F, scale=s),
        _rand(gen, n_lvl, 12 * F, F, scale=s), _rand(gen, n_lvl, F, scale=s),
        _rand(gen, n_lvl, 12 * F, 2 * F, scale=s), _rand(gen, n_lvl, 2 * F, scale=s),
        _rand(gen, n_lvl, 2 * F, F, scale=s),
    )


@pytest.mark.parametrize("wid,n", [(16, 5), (7, 33), (1, 3)])
def test_vrow_kernel_matches_plain(dev, wid, n):
    gen = torch.Generator(device=dev).manual_seed(wid * 100 + n)
    args = _vrow_inputs(gen, 4, wid, n)
    before = sc.vrow.launches
    got = sc.vrow(*args)
    torch.cuda.synchronize()
    assert sc.vrow.launches == before + 1
    want = sc.vrow_plain(*args)
    for g, w in zip(got, want):
        assert _close(g, w)


def _row_inputs(gen, n_lvl, wid, n, k):
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
# one column, one and two logits chunks.
@pytest.mark.parametrize("wid,n,k,n_lvl", [
    pytest.param(16, 5, 512, 4, id="16-5-512"),
    pytest.param(7, 13, 256, 4, id="7-13-256"),
    pytest.param(16, 13, 512, 24, id="16-13-512-L24"),
    pytest.param(16, 16, 256, 24, id="16-16-256-L24"),
    pytest.param(1, 5, 512, 4, id="1-5-512"),
])
def test_row_kernel_matches_plain(dev, wid, n, k, n_lvl):
    gen = torch.Generator(device=dev).manual_seed(wid * 100 + n)
    args = _row_inputs(gen, n_lvl, wid, n, k)
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


def _stream_case(gen, b, h, w, L, cd, down):
    f = gc.KERNEL_FILTERS
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


def _level_case(gen, b, h, w, L, cd, down):
    """Per-level weights at 1 / sqrt(fan-in) (biases 0.05), so that
    activations and gradients stay of order 1 over the levels."""
    f = gc.KERNEL_FILTERS
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


def test_gated_level_wrappers_refuse_masks_and_widths(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    xv0, xh0, _, cond, ws = _level_case(gen, 2, 4, 4, 1, 16, False)
    masks = (torch.ones(2, 4, 4, 256, device=dev),) * 2
    with pytest.raises(ValueError, match="injected masks"):
        gc.gated_pair(xv0, xh0, None, cond, ws[0], seed=0, pair_index=0, keep=0.5, masks=masks)
    narrow = {n: t[..., :64] for n, t in ws[0].items()}
    with pytest.raises(ValueError, match="num_filters"):
        gc.gated_segment(xv0[..., :64], xh0[..., :64], None, cond, [narrow], seed=0,
                         base_pair=0, keep=1.0)


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
    from posterior_matching_torch import convert
    from posterior_matching_torch.train.trainer import pm_vqvae_loss

    params, state = convert.random_pm_vqvae_tree(24, SMALL_VQ, SMALL_PC, seed=4)
    g = torch.Generator().manual_seed(5)
    x = torch.rand(3, 28, 28, 1, generator=g)
    b = (torch.rand(3, 28, 28, 1, generator=g) > 0.5).float()
    counters = (gc.stream_bwd, gc.pair_bwd, gc.seg_bwd)
    out = {}
    for d in (dev, torch.device("cpu")):
        m = convert.pm_vqvae_from_jax(params, state, 24, SMALL_VQ, SMALL_PC, device=d,
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

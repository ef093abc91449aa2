"""The PM-VDVAE's ``compute_dtype="bfloat16"`` and ``remat`` against the JAX
package, on the CPU at toy sizes.

- ``block_chain_plain`` and ``dec_chain_plain`` at bf16 against the JAX
  chains at bf16 in interpret mode, forward and gradients. Both sides round
  the same float32 values to bf16 and multiply the rounded values exactly;
  they differ in the order of their float32 sums, so a save that lies
  within that difference of a bf16 boundary rounds the other way (one ulp,
  2^-8 of it), and the backward, which takes gelu's derivative at the saves
  and rebuilds u and z from them, carries that on. So: the saves equal but
  for at most SAVE_FLIPS of them; the outputs and the
  gradients end to end within CHAIN_TOL of each tensor's scale (where a
  save rounds the other way the decoder's gradients have moved by up to
  5.2e-3 of scale, at 2 x 8 x 8 over 3 levels); and each backward fed the
  JAX forward's own saves (the custom VJPs' ``fwd`` and ``bwd``) against
  the JAX backward on them within TIGHT_TOL, float32 rounding. ``python
  tests/test_torch_vdvae_bf16.py`` prints each comparison's worst error
  and the share of elements beyond 1e-5 of scale.
- The whole model's ``reconstruction_ll``, ``kl`` and ``pm_kl`` at bf16
  against JAX at bf16 with the same normals, fused (the chains) and
  unfused, within MODEL_TOL relative. The unfused Blocks round every c1..c3
  output to bf16 and add the bias in bf16 (flax's ``nn.Conv(dtype=
  bfloat16)``), and gelu runs on bf16 values, which XLA and PyTorch round
  at other places (3e-4 relative at most seen, ``kl``; fused 3e-5).
- bf16 against float32 in the port within the JAX test's own bounds
  (``tests/test_vdvae.py:202-231``: ``rtol=0.15, atol=3.0``; parameters
  stay float32).
- ``remat=True``'s gradients equal those without it, bit for bit.

The whole model against JAX's is ``tests/test_torch_vdvae_bf16_model.py``'s.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posterior_matching_tpu.ops import block_chain as jbc
from posterior_matching_tpu.ops import decoder_chain as jdc
from posterior_matching_torch import convert
from posterior_matching_torch.distributions import tril_size
from posterior_matching_torch.ops import block_chain as bc
from posterior_matching_torch.ops import decoder_chain as dc
from posterior_matching_torch.train.trainer import pm_vdvae_loss
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BF16 = torch.bfloat16
CHAIN_TOL, TIGHT_TOL, SAVE_FLIPS = 1e-2, 1e-4, 0.05
MODEL_TOL = 1e-3
WIDTH, MID, LD = 16, 8, 4
# tests/test_torch_decoder_chain.py's KW: at batch 2 the encoder's 8x2 and
# 4x2 runs (128 and 32 rows) and the decoder's 4m1,4x2 and 8m4,8x3 fuse at
# bf16 too, the 1x2 runs (2 rows) do not
KW = dict(image_shape=(8, 8, 1), encoder_blocks="8x2,8d2,4x2,4d4,1x2",
          decoder_blocks="1x2,4m1,4x2,8m4,8x3", latent_dim=4, width=16,
          bottleneck_multiple=0.5)
SHARES = {}


def _bf16_close(got, want, what, tol=CHAIN_TOL):
    """Within ``tol`` of ``want``'s scale; records the error relative to
    the scale and the share of elements beyond 1e-5 of it in SHARES."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    got = got.reshape(want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = np.abs(got - want)
    SHARES[what] = max(SHARES.get(what, (0.0, 0.0)),
                       (float(err.max()) / scale, float((err > 1e-5 * scale).mean())))
    assert err.max() <= tol * scale, (what, err.max() / scale)


def _saves_close(got, want, what):
    """bf16 saves (float32 ``got``, the JAX ones ``want``) equal but for at
    most SAVE_FLIPS of them, each within 2^-6 of the tensor's scale."""
    got = np.asarray(got, np.float32).reshape(-1)
    want = np.asarray(jnp.asarray(want, jnp.float32)).reshape(-1)
    assert (got != want).mean() <= SAVE_FLIPS, what
    assert np.abs(got - want).max() <= 2.0 ** -6 * np.abs(want).max(), what


def _f32(t):
    return torch.from_numpy(np.array(jnp.asarray(t, jnp.float32)))


def _block_case(seed, b, h, L, k):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, h, WIDTH).astype(np.float32)
    w = {n: (rng.randn(L, *s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in bc.weight_shapes(WIDTH, MID, k)}
    return x, w, rng.randn(b, h, h, WIDTH).astype(np.float32)


BLOCK_CASES = [(2, 4, 2, 3), (8, 2, 2, 1)]


@pytest.mark.parametrize("b,h,L,k", BLOCK_CASES)
def test_plain_block_chain_matches_jax_at_bf16(b, h, L, k):
    x, w, cot = _block_case(b * 10 + h, b, h, L, k)
    # the JAX chain's custom VJP: its forward with its saves, its backward
    cfg = jbc.BlockChainConfig(h=h, w=h, cin=WIDTH, mid=MID, k=k, cdtype="bfloat16",
                               bc_fwd=jbc._snap_chunk(1, b, h * h, 16),
                               bc_bwd=jbc._snap_chunk(1, b, h * h, 16), interpret=True)
    chain = jbc._build_chain(cfg, b, L)
    cast = lambda n: jnp.asarray(w[n], jnp.float32 if n[0] == "b" or n == "w4" else jnp.bfloat16)
    want, res = chain.fwd(jnp.asarray(x.reshape(-1, WIDTH)), *(cast(n) for n in bc.NAMES))
    jg = chain.bwd(res, jnp.asarray(cot.reshape(-1, WIDTH)))
    _, (xout, *saves), _ = res

    leaves = {"x": torch.from_numpy(x).requires_grad_(True),
              **{n: torch.from_numpy(v).requires_grad_(True) for n, v in w.items()}}
    out = bc.block_chain_plain(leaves["x"], {n: leaves[n] for n in w}, mid=MID, k=k,
                               compute_dtype=BF16)
    grads = torch.autograd.grad(out, list(leaves.values()), torch.from_numpy(cot))
    assert out.dtype == torch.float32
    _bf16_close(out.detach().numpy(), want, "block x_final")
    for name, g, theirs in zip(("x0", *bc.NAMES), grads, jg):
        assert g.dtype == torch.float32
        _bf16_close(g.numpy(), theirs, f"block d{name}")

    with torch.no_grad():
        w_ = {n: torch.from_numpy(v) for n, v in w.items()}
        x_, mine = torch.from_numpy(x), []
        for lvl in range(L):
            *hs, h4 = bc.bf16_sub_fwd(x_, {n: w_[n][lvl] for n in bc.NAMES}, k)
            mine.append(hs)
            x_ = x_ + h4
        for i, (name, sv) in enumerate(zip(("h1", "h2", "h3"), saves)):
            _saves_close(bc.round_bf16(torch.stack([hs[i] for hs in mine])), sv, name)
        lv = lambda t_: _f32(t_).reshape(L, b, h, h, -1)
        d_x0, d_w = bc.bf16_chain_bwd(torch.from_numpy(x), lv(xout), [lv(t_) for t_ in saves],
                                      w_, torch.from_numpy(cot), k)
    for name, mine_, theirs in zip(("x0", *bc.NAMES), (d_x0, *(d_w[n] for n in bc.NAMES)), jg):
        _bf16_close(mine_.numpy(), theirs, f"block d{name} from the JAX saves", TIGHT_TOL)


def _dec_case(seed, b, h, L, k):
    rng = np.random.RandomState(seed)
    ins = {n: rng.randn(b, h, h, WIDTH).astype(np.float32) for n in ("x0", "acts", "macts")}
    eps = rng.randn(L, b, h, h, LD).astype(np.float32)
    w = {n: (rng.randn(L, *s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in dc.weight_shapes(WIDTH, WIDTH, MID, LD, k)}
    shapes = [(b, h, h, WIDTH), (L, b, h, h, 2 * LD), (L, b, h, h, 2 * LD),
              (L, b, h, h, LD + tril_size(LD))]
    return ins, eps, w, [rng.randn(*s).astype(np.float32) for s in shapes]


DEC_CASES = [(2, 4, 2, 3), (8, 2, 2, 1)]


@pytest.mark.parametrize("b,h,L,k", DEC_CASES)
def test_plain_dec_chain_matches_jax_at_bf16(b, h, L, k):
    ins, eps, w, cots = _dec_case(b * 10 + h, b, h, L, k)
    # the JAX chain's custom VJP: its forward with its saves, its backward
    R = b * h * h
    cfg = jdc.DecChainConfig(h=h, w=h, width=WIDTH, awidth=WIDTH, mid=MID, ld=LD,
                             tril=tril_size(LD), k=k, cdtype="bfloat16",
                             bc_fwd=jbc._snap_chunk(1, b, h * h, 16),
                             bc_bwd=jbc._snap_chunk(1, b, h * h, 16), interpret=True)
    chain = jdc._build_dec_chain(cfg, b, L)
    keep = lambda n: n.endswith(("b1", "b2", "b3", "b4", "w4")) or n in ("wz", "bz")
    flat = [jnp.asarray(ins[n].reshape(R, -1)) for n in ("x0", "acts", "macts")]
    flat += [jnp.asarray(eps.reshape(L * R, LD))]
    flat += [jnp.asarray(w[n], jnp.float32 if keep(n) else jnp.bfloat16) for n in dc.NAMES]
    want, res = chain.fwd(*flat)
    jg = chain.bwd(res, (jnp.asarray(cots[0].reshape(R, -1)),
                         *(jnp.asarray(c.reshape(L * R, -1)) for c in cots[1:])))
    jg = (*jg[:3], *jg[4:])   # no cotangent for eps
    xout, *saves = res[4]
    lv = lambda t_: _f32(t_).reshape(L, b, h, h, -1)

    leaves = {n: torch.from_numpy(v).requires_grad_(True) for n, v in {**ins, **w}.items()}
    got = dc.dec_chain_plain(leaves["x0"], leaves["acts"], leaves["macts"],
                             torch.from_numpy(eps), {n: leaves[n] for n in w}, ld=LD, k=k,
                             compute_dtype=BF16)
    grads = torch.autograd.grad(got, list(leaves.values()), [torch.from_numpy(c) for c in cots])
    for name, g_, w_ in zip(("x_final", "post", "prior", "masked"), got, want):
        _bf16_close(g_.detach().numpy(), w_, f"decoder {name}")
    names = ("x0", "acts", "macts", *dc.NAMES)
    for name, g, theirs in zip(names, grads, jg):
        _bf16_close(g.numpy(), theirs, f"decoder d{name}")

    with torch.no_grad():
        d_x0, d_acts, d_macts, d_w = dc.bf16_dec_chain_bwd(
            *(torch.from_numpy(ins[n]) for n in ("x0", "acts", "macts")),
            torch.from_numpy(eps), lv(xout), [lv(t_) for t_ in saves],
            {n: torch.from_numpy(v) for n, v in w.items()},
            [torch.from_numpy(c) for c in cots], ld=LD, k=k)
        mine = (d_x0, d_acts, d_macts, *(d_w[n] for n in dc.NAMES))
        for name, g, theirs in zip(names, mine, jg):
            _bf16_close(g.numpy(), theirs, f"decoder d{name} from the JAX saves", TIGHT_TOL)
        # the port's forward saves against the JAX forward's, level by level
        x_in = torch.from_numpy(ins["x0"])
        wt = {n: torch.from_numpy(v) for n, v in w.items()}
        for lvl in range(L):
            wl = {n: wt[n][lvl] for n in dc.NAMES}
            blk = lambda tag: {n: wl[f"{tag}_{n}"] for n in bc.NAMES}
            for tag, inp in (("p", torch.cat([x_in, torch.from_numpy(ins["acts"])], -1)),
                             ("m", torch.cat([x_in, torch.from_numpy(ins["macts"])], -1)),
                             ("q", x_in)):
                *hs, _ = bc.bf16_sub_fwd(inp, blk(tag), k)
                for i in range(3):
                    j = dc.SAVES.index(f"{tag}h{i + 1}")
                    _saves_close(bc.round_bf16(hs[i]), lv(saves[j])[lvl], f"{tag}h{i + 1}")
            x_in = lv(xout)[lvl]


def test_chain_supported_follows_jax():
    for rows in [(2, 8, 8), (2, 2, 2), (1, 4, 4), (3, 1, 1), (16, 1, 1), (2, 4, 2)]:
        for cd, jcd in ((torch.float32, jnp.float32), (BF16, jnp.bfloat16)):
            want = jbc.chain_supported(*rows, jcd)
            assert bc.chain_supported(*rows, cd) == want == dc.dec_chain_supported(*rows, cd)
            assert jdc.dec_chain_supported(*rows, jcd) == want


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(3)
    x = rng.randint(0, 256, (2, 8, 8, 1)).astype(np.float32)
    b = (rng.rand(2, 8, 8, 1) > 0.5).astype(np.float32)
    return convert.random_pm_vdvae_tree(KW, seed=2), x, b


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_bf16_is_within_the_jax_bounds_of_float32(data, fused):
    tree, x, b = data
    outs = {}
    for cd in (None, "bfloat16"):
        model = convert.pm_vdvae_from_jax(tree, dict(KW, fused_chain=fused, compute_dtype=cd),
                                          device="cpu")
        assert all(p.dtype == torch.float32 for p in model.parameters())
        with torch.no_grad():
            outs[cd] = model(torch.from_numpy(x), torch.from_numpy(b),
                             torch.Generator().manual_seed(1))
    for key in ("reconstruction_ll", "kl", "pm_kl"):
        got = outs["bfloat16"][key]
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), outs[None][key].numpy(), rtol=0.15, atol=3.0)


@pytest.mark.parametrize("compute_dtype,fused", [(None, None), ("bfloat16", True)])
def test_remat_gradients_equal_bit_for_bit(data, compute_dtype, fused):
    tree, x, b = data
    grads = []
    for remat in (False, True):
        model = convert.pm_vdvae_from_jax(
            tree, dict(KW, fused_chain=fused, compute_dtype=compute_dtype, remat=remat),
            device="cpu")
        assert model.encoder.remat == remat
        loss = pm_vdvae_loss(model, {"image": torch.from_numpy(x), "mask": torch.from_numpy(b)},
                             torch.Generator().manual_seed(5))
        grads.append(dict(zip([n for n, _ in model.named_parameters()],
                              torch.autograd.grad(loss, list(model.parameters())))))
    assert grads[0].keys() == grads[1].keys()
    for name in grads[0]:
        assert torch.equal(grads[0][name], grads[1][name]), name


@pytest.mark.parametrize("noise", [1e-6, None], ids=["bf16_noise", "float32"])
def test_saves_tell_bf16_from_float32(noise):
    """What the kernel checks rely on: one level's bf16 saves, against the
    same level on an input perturbed by ``noise`` (the size of two float32
    sums' difference), differ in at most SAVE_FLIPS of their elements, and
    against the level run with float32 operands (its outputs rounded as a
    save) in far more (a third or more)."""
    torch.manual_seed(0)
    c, m, k = 192, 48, 3
    x = torch.randn(16, 14, 14, c)
    w = {n: torch.randn(*s) * s[0] ** -0.5 for n, s in bc.weight_shapes(c, m, k)}
    saves = [bc.round_bf16(h) for h in bc.bf16_sub_fwd(x, w, k)[:3]]
    if noise is None:
        h1 = bc.gelu(x) @ w["w1"] + w["b1"]
        h2 = bc.conv_taps(bc.gelu(h1), w["w2"], k) + w["b2"]
        other = (h1, h2, bc.conv_taps(bc.gelu(h2), w["w3"], k) + w["b3"])
    else:
        other = bc.bf16_sub_fwd(x * (1 + noise * torch.randn_like(x)), w, k)[:3]
    shares = [(a != bc.round_bf16(b)).float().mean().item() for a, b in zip(saves, other)]
    if noise is None:
        assert min(shares) > 0.3, shares
    else:
        assert max(shares) <= SAVE_FLIPS, shares


if __name__ == "__main__":
    for test, cases in ((test_plain_block_chain_matches_jax_at_bf16, BLOCK_CASES),
                        (test_plain_dec_chain_matches_jax_at_bf16, DEC_CASES)):
        for case in cases:
            SHARES.clear()
            test(*case)
            name, (err, _) = max(SHARES.items(), key=lambda kv: kv[1][0])
            print(f"{test.__name__} {case}: worst {name}, {err:.2e} of its scale; share "
                  f"beyond 1e-5 of scale up to {max(v[1] for v in SHARES.values()):.3f}")

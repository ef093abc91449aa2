"""The port's gated chain (``ops/gated_chain.py``) against the JAX package.

``gated_stream_plain`` against the JAX ``gated_stream`` run through the
Pallas interpreter with injected masks (``mask_mode="input"``), for the up
and the down pass at keep 0.6, at a toy width (8 filters) and at
``pm_vqvae_digits16``'s geometry (4x4 codes, 64 filters, a 256-wide
condition, two levels a pass; its weights at the model's own scale, 1 /
sqrt(fan in), as ``tests/test_torch_gated_pair.py`` draws them: at 0.3 its
activations reach ~1e3, where float32 rounding alone puts either package
~2e-2 off a float64 run): level outputs within 1e-5 (relative and
absolute, as ``tests/test_gated_chain.py`` holds the JAX paths), and every
gradient (inputs, skips, cond, every stacked weight and bias) within
2e-5 x scale, the bar of ``tests/test_gated_chain.py``'s pair test. The
dropout hash: its keep rate, its independence across levels, sub-blocks and
images, and its determinism.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posterior_matching_tpu.ops.gated_chain import gated_stream as jax_gated_stream
from posterior_matching_torch.ops import gated_chain as gc
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, H, W, F, CD, L = 2, 4, 4, 8, 16, 2
KEEP = 0.6
# (F, CD, weights at 1 / sqrt(fan in)) of the parity cases: the toy width,
# and digits16's 64 filters and 256-wide condition
# (configs/pm_vqvae_digits16.py)
WIDTHS = {"toy": (F, CD, False), "digits16": (64, 256, True)}


def _case(down: bool, seed: int = 3, widths=(F, CD, False)):
    F, CD, fan_in = widths
    rng = np.random.RandomState(seed)
    mk = lambda *s: (rng.randn(*s) * 0.3).astype(np.float32)
    taps = gc.chain_taps()
    w = {n: mk(L, *s) for n, s in gc.weight_shapes(F, CD, *taps, down)}
    if fan_in:  # [L, fan in, n] weights at std 1 / sqrt(fan in), [L, n] biases at 0.1
        std = lambda v: 0.1 if v.ndim == 2 else v.shape[1] ** -0.5
        w = {n: v * np.float32(std(v) / 0.3) for n, v in w.items()}
    xv, xh = mk(B, H, W, F), mk(B, H, W, F)
    skips = (mk(L, B, H, W, F), mk(L, B, H, W, F)) if down else None
    cond = mk(B, CD)
    masks = tuple((rng.rand(L, B, H, W, 2 * F) < KEEP).astype(np.float32)
                  for _ in range(2))
    return xv, xh, skips, cond, w, masks


def _jax_fn(down, masks):
    def fn(xv, xh, skips, cond, w):
        levels = [
            {k: (v[l].reshape(1, -1) if k.startswith("b") else v[l]) for k, v in w.items()}
            for l in range(L)
        ]
        sk = [(skips[0][l], skips[1][l]) for l in range(L)] if down else None
        outs = jax_gated_stream(
            xv, xh, sk, cond, levels, jnp.zeros((), jnp.int32), 0, keep=KEEP,
            bc_fwd=1, bc_bwd=1, mask_mode="input",
            masks=[(jnp.asarray(masks[0][l]), jnp.asarray(masks[1][l])) for l in range(L)],
            interpret=True,
        )
        return jnp.stack([o[0] for o in outs]), jnp.stack([o[1] for o in outs])
    return fn


def _scalar(xvo, xho, lib):
    """A loss that weighs every level output (the skips' consumers)."""
    return (lib.sin(xvo) * 0.7).sum() + lib.cos(xho).sum()


@pytest.mark.parametrize("down,widths", [
    pytest.param(d, geo, id=("" if geo == "toy" else geo + "-") + ("down" if d else "up"))
    for geo in WIDTHS for d in (False, True)])
def test_stream_plain_matches_jax(down, widths):
    xv, xh, skips, cond, w, masks = _case(down, widths=WIDTHS[widths])
    fn = _jax_fn(down, masks)
    jv, jh = fn(xv, xh, skips, cond, w)

    t = lambda a: torch.tensor(a, requires_grad=True)
    txv, txh, tcond = t(xv), t(xh), t(cond)
    tw = {k: t(v) for k, v in w.items()}
    tsk = (t(skips[0]), t(skips[1])) if down else None
    tv, th = gc.gated_stream_plain(
        txv, txh, tsk, tcond, tw, keep=KEEP,
        masks=(torch.from_numpy(masks[0]), torch.from_numpy(masks[1])),
    )
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)

    argnums = (0, 1, 2, 3, 4) if down else (0, 1, 3, 4)
    jgrads = jax.grad(lambda *a: _scalar(*fn(*a), jnp), argnums=argnums)(
        xv, xh, skips, cond, w)
    _scalar(tv, th, torch).backward()
    jg = dict(zip([a for a in ("xv", "xh", "skips", "cond", "w") if
                   a != "skips" or down], jgrads))
    pairs = [("xv", txv.grad, jg["xv"]), ("xh", txh.grad, jg["xh"]),
             ("cond", tcond.grad, jg["cond"])]
    if down:
        pairs += [("skv", tsk[0].grad, jg["skips"][0]), ("skh", tsk[1].grad, jg["skips"][1])]
    pairs += [(k, tw[k].grad, jg["w"][k]) for k in w]
    for name, got, want in pairs:
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1e-6)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5 * scale,
                                   err_msg=name)


def test_dropout_hash_masks():
    m = gc.dropout_keep_mask(11, 5, 4, 16, 16, 256, 0.5)
    assert m.shape == (4, 16, 16, 256)
    # 262144 Bernoulli(0.5) draws: 5 sigma is 0.005
    assert abs(m.mean().item() - 0.5) < 0.005
    assert torch.equal(m, gc.dropout_keep_mask(11, 5, 4, 16, 16, 256, 0.5))
    # another level, sub-block, seed: other bits; other images: other bits
    for other in (gc.dropout_keep_mask(11, 7, 4, 16, 16, 256, 0.5),
                  gc.dropout_keep_mask(11, 4, 4, 16, 16, 256, 0.5),
                  gc.dropout_keep_mask(12, 5, 4, 16, 16, 256, 0.5)):
        agree = (other == m).float().mean().item()
        assert abs(agree - 0.5) < 0.005
    assert abs((m[0] == m[1]).float().mean().item() - 0.5) < 0.01
    keep9 = gc.dropout_keep_mask(11, 5, 4, 16, 16, 256, 0.9).mean().item()
    assert abs(keep9 - 0.9) < 0.005
    # the 64-bit split multiply equals the 32-bit wrap-around product
    x = torch.tensor([0, 1, 0xFFFFFFFF, 0x12345678, 0x9E3779B9])
    for xi, yi in zip(x.tolist(), gc._mix32(x).tolist()):
        assert gc._mix32_int(xi) == yi


def test_stream_hash_masks_are_the_step_masks():
    """Without injected masks the plain path draws the hash masks of
    (seed, base_pair): equal to passing step_masks explicitly."""
    xv, xh, skips, cond, w, _ = _case(True, seed=5)
    args = [torch.from_numpy(a) for a in (xv, xh)]
    sk = tuple(torch.from_numpy(s) for s in skips)
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    got = gc.gated_stream_plain(*args, sk, torch.from_numpy(cond), tw, keep=KEEP,
                                seed=9, base_pair=L)
    masks = gc.step_masks(9, L, L, xv.shape, KEEP)
    want = gc.gated_stream_plain(*args, sk, torch.from_numpy(cond), tw, keep=KEEP,
                                 masks=masks)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)

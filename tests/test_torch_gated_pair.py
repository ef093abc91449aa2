"""The port's pair and segment chains (``ops/gated_chain.py``) against the
JAX package, and the PixelCNN's three chain modes against each other.

``gated_pair_plain`` against the JAX ``gated_pair`` and
``gated_segment_plain`` against the JAX ``gated_segment`` (two levels, and
one: the remainder segment of a pass that the segment length does not
divide), run through the Pallas interpreter with injected masks
(``mask_mode="input"``), up and down at keep 0.6, at four seeds each. The
weights are drawn at the model's own scale (std 1 / sqrt(fan in), as
``_trunc_normal_fan_in`` draws them), the activations at std 1. Every
level's outputs agree within 1e-5 (relative and absolute, as
``tests/test_gated_chain.py`` holds the JAX paths). Every gradient (inputs,
skips, cond, each level's weights and biases) of either package's float32
run lies within 2e-5 x scale of the port's plain version evaluated in
float64, the bar of that file's pair test: both packages then compute the
same function, each to float32 rounding. Over 20 seeds per case the worst
reading was 1e-6 of scale (either package), while rounding the float64
gradients to bfloat16 alone errs by 2.4e-3 of scale, so the bar holds at
any seed and fails a lower precision. Then the port's PixelCNN on the CPU:
logits and every parameter's gradient, in training with hash dropout, equal
(1e-6 of scale) with ``chain_segment`` ``"stream"``, ``1`` and ``2`` at 3
levels (segments 2 + 1).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posterior_matching_tpu.ops.gated_chain import gated_pair as jax_gated_pair
from posterior_matching_tpu.ops.gated_chain import gated_segment as jax_gated_segment
from posterior_matching_torch.models.pixelcnn import PixelCNN
from posterior_matching_torch.ops import gated_chain as gc
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, H, W, F, CD = 2, 4, 4, 8, 16
KEEP = 0.6
BASE = 3


def _case(down: bool, n_lvl: int, seed: int, weight_std=None):
    """Inputs, skips, weights and masks; the weights at std 1 / sqrt(fan in)
    (or ``weight_std``), the biases at 0.1."""
    rng = np.random.RandomState(seed)
    mk = lambda *s: rng.randn(*s).astype(np.float32)
    shapes = gc.weight_shapes(F, CD, *gc.chain_taps(), down)
    std = lambda s: 0.1 if len(s) == 1 else (weight_std or s[0] ** -0.5)
    ws = [{n: mk(*s) * np.float32(std(s)) for n, s in shapes} for _ in range(n_lvl)]
    xv, xh, cond = mk(B, H, W, F), mk(B, H, W, F), mk(B, CD)
    skips = [(mk(B, H, W, F), mk(B, H, W, F)) for _ in range(n_lvl)] if down else None
    masks = [tuple((rng.rand(B, H, W, 2 * F) < KEEP).astype(np.float32) for _ in range(2))
             for _ in range(n_lvl)]
    return xv, xh, skips, cond, ws, masks


def _scalar(outs, lib):
    """A loss that weighs every level's outputs."""
    return sum((lib.sin(v) * 0.7).sum() + lib.cos(h).sum() for v, h in outs)


@functools.lru_cache(maxsize=None)
def _jax_fn(kind: str, down: bool):
    """The JAX pair or segment, jitted: a function of (xv, xh, skips, cond,
    ws, masks) returning the gradient of :func:`_scalar` and the list of
    level outputs; biases go in as ``[1, F]``."""
    common = dict(keep=KEEP, bc_fwd=1, bc_bwd=1, mask_mode="input", interpret=True)

    def fn(xv, xh, skips, cond, ws, masks):
        ws = [{k: (v.reshape(1, -1) if k.startswith("b") else v) for k, v in w.items()}
              for w in ws]
        seed = jnp.zeros((), jnp.int32)
        if kind == "pair":
            return [jax_gated_pair(xv, xh, skips[0] if down else None, cond, ws[0], seed, BASE,
                                   masks=masks[0], **common)]
        return jax_gated_segment(xv, xh, skips, cond, ws, seed, BASE, masks=masks, **common)

    def loss(*a):
        outs = fn(*a)
        return _scalar(outs, jnp), outs

    argnums = (0, 1, 2, 3, 4) if down else (0, 1, 3, 4)
    return jax.jit(jax.grad(loss, argnums=argnums, has_aux=True))


def _port(kind, down, n_lvl, case, dtype):
    """The port's outputs and named gradients at ``dtype``."""
    xv, xh, skips, cond, ws, masks = case
    t = lambda a: torch.tensor(a, dtype=dtype, requires_grad=True)
    txv, txh, tcond = t(xv), t(xh), t(cond)
    tws = [{k: t(v) for k, v in w.items()} for w in ws]
    tsk = [(t(a), t(b)) for a, b in skips] if down else None
    tmasks = [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in masks]
    if kind == "pair":
        got = [gc.gated_pair(txv, txh, tsk[0] if down else None, tcond, tws[0], seed=0,
                             pair_index=BASE, keep=KEEP, masks=tmasks[0])]
    else:
        got = gc.gated_segment(txv, txh, tsk, tcond, tws, seed=0, base_pair=BASE, keep=KEEP,
                               masks=tmasks)
    _scalar(got, torch).backward()
    grads = {"xv": txv.grad, "xh": txh.grad, "cond": tcond.grad}
    for l in range(n_lvl):
        if down:
            grads[f"skv{l}"], grads[f"skh{l}"] = tsk[l][0].grad, tsk[l][1].grad
        grads.update({f"{k}{l}": tws[l][k].grad for k in ws[l]})
    outs = [t_.detach().numpy() for pair in got for t_ in pair]
    return outs, {k: v.numpy() for k, v in grads.items()}


def _jax(kind, down, n_lvl, case):
    """The JAX package's outputs and named gradients (float32)."""
    xv, xh, skips, cond, ws, masks = case
    jgrads, want = _jax_fn(kind, down)(xv, xh, skips, cond, ws, masks)
    jg = dict(zip([a for a in ("xv", "xh", "skips", "cond", "ws") if a != "skips" or down],
                  jgrads))
    grads = {"xv": jg["xv"], "xh": jg["xh"], "cond": jg["cond"]}
    for l in range(n_lvl):
        if down:
            grads[f"skv{l}"], grads[f"skh{l}"] = jg["skips"][l]
        grads.update({f"{k}{l}": jg["ws"][l][k].reshape(ws[l][k].shape) for k in ws[l]})
    outs = [np.asarray(t_) for pair in want for t_ in pair]
    return outs, {k: np.asarray(v) for k, v in grads.items()}


CASES = [("pair", 1, False), ("pair", 1, True), ("segment", 2, False), ("segment", 2, True),
         ("segment", 1, True)]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind,n_lvl,down", CASES, ids=[
    "pair-up", "pair-down", "segment2-up", "segment2-down", "segment1-down"])
def test_pair_and_segment_plain_match_jax(kind, n_lvl, down, seed):
    case = _case(down, n_lvl, seed)
    want, jg32 = _jax(kind, down, n_lvl, case)
    got, pg32 = _port(kind, down, n_lvl, case, torch.float32)
    _, pg64 = _port(kind, down, n_lvl, case, torch.float64)
    assert len(got) == len(want) == 2 * n_lvl
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_, w_, rtol=1e-5, atol=1e-5)

    assert set(jg32) == set(pg32) == set(pg64)
    for name, want_g in pg64.items():
        scale = max(float(np.abs(want_g).max()), 1e-6)
        for who, got_g in (("port", pg32[name]), ("jax", jg32[name])):
            np.testing.assert_allclose(got_g, want_g, rtol=2e-5, atol=2e-5 * scale,
                                       err_msg=f"{who} {name}")


if __name__ == "__main__":
    # The readings behind the bars: the worst gradient error relative to
    # scale against the float64 plain version, over many seeds per case,
    # of each float32 package and of bfloat16 rounding of the float64
    # gradients. Usage, from the repository's root: PYTHONPATH=. python
    # tests/test_torch_gated_pair.py [SEEDS] [WEIGHT_STD] (WEIGHT_STD
    # replaces the fan-in scale of the weights).
    import sys

    n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    std = float(sys.argv[2]) if len(sys.argv) > 2 else None
    rel = lambda a, b: float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-6))
    bf16 = lambda a: torch.from_numpy(a).bfloat16().double().numpy()
    for kind, n_lvl, down in CASES:
        worst = {"port": 0.0, "jax": 0.0, "bfloat16": np.inf}
        for seed in range(n_seeds):
            case = _case(down, n_lvl, seed, std)
            _, jg32 = _jax(kind, down, n_lvl, case)
            _, pg32 = _port(kind, down, n_lvl, case, torch.float32)
            _, pg64 = _port(kind, down, n_lvl, case, torch.float64)
            for who, g in (("port", pg32), ("jax", jg32)):
                worst[who] = max(worst[who], *(rel(g[k], pg64[k]) for k in pg64))
            worst["bfloat16"] = min(worst["bfloat16"],
                                    max(rel(bf16(v), v) for v in pg64.values()))
        print(f"{kind} L={n_lvl} {'down' if down else 'up'}, {n_seeds} seeds: worst "
              f"float32 port {worst['port']:.3g}, jax {worst['jax']:.3g}; "
              f"bfloat16 rounding at least {worst['bfloat16']:.3g}")


def test_pixelcnn_chain_modes_agree():
    torch.manual_seed(0)
    model = PixelCNN(num_indices=12, image_shape=(4, 4), dropout=0.5, num_resnet=3,
                     num_filters=F, conditional_dim=CD)
    rng = np.random.RandomState(1)
    codes = torch.from_numpy(rng.randint(0, 12, (B, 4, 4)))
    cond = torch.from_numpy(rng.randn(B, CD).astype(np.float32))
    out = {}
    for mode in ("stream", 1, 2):
        model.chain_segment = mode
        logits = model(codes, cond, training=True, seed=11)
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad((logits * torch.linspace(-1, 1, logits.numel())
                                     .reshape(logits.shape)).sum(), params)
        out[mode] = (logits.detach(), dict(zip(names, grads)))
    want_l, want_g = out["stream"]
    for mode in (1, 2):
        got_l, got_g = out[mode]
        torch.testing.assert_close(got_l, want_l, rtol=0, atol=1e-6 * want_l.abs().max())
        for n, w_ in want_g.items():
            torch.testing.assert_close(got_g[n], w_, rtol=0, atol=1e-6 * max(w_.abs().max(), 1e-6),
                                       msg=f"{mode} {n}")
    with pytest.raises(ValueError, match="chain_segment"):
        model.chain_segment = 0

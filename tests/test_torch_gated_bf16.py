"""The port's gated chain at bf16 (``ops/gated_chain.py``: the plain
:class:`~posterior_matching_torch.ops.gated_chain.Bf16Levels` the three
modes run on the CPU) against the JAX package's chain at
``compute_dtype=bfloat16`` run through the Pallas interpreter with injected
masks (``mask_mode="input"``), at a toy width (8 filters) and keep 0.6.

The modes differ at bf16 in their backward carries only, as the JAX
kernels' do (``models/pixelcnn.py:398-406``), so each is held against its
own JAX counterpart: the stream (a down pass with skips), the pair (one
down level) and a segment (3 up levels). The loss weighs every level
output in float32, as JAX's ``astype`` to float32 and torch's ``.float()``
both round the cotangent back to bf16. Tolerances: the JAX package's own
bf16 ones (``tests/test_gated_chain.py:321-360``), rtol 1e-2 on values,
rtol 2e-2 and atol 2e-3 on gradients, with an atol of 1e-3 on values (the
JAX test compares one scalar) and the gradients' atol taken as 2e-3 of the
gradient's scale. ``python tests/test_torch_gated_bf16.py`` prints each
comparison's worst error.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posterior_matching_tpu.ops import gated_chain as jgc
from posterior_matching_torch.ops import gated_chain as gc
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, H, W, F, CD = 2, 4, 4, 8, 16
KEEP = 0.6
VAL_RTOL, VAL_ATOL, GRAD_RTOL, GRAD_ATOL = 1e-2, 1e-3, 2e-2, 2e-3
# (mode, levels, down)
CASES = {"stream": (2, True), "pair": (1, True), "segment": (3, False)}


def _case(n_lvl: int, down: bool, seed: int = 4):
    rng = np.random.RandomState(seed)
    mk = lambda *s: (rng.randn(*s) * 0.5).astype(np.float32)
    taps = gc.chain_taps()
    ws = [{n: (mk(*s) * (0.2 if len(s) == 1 else s[0] ** -0.5 / 0.5)).astype(np.float32)
           for n, s in gc.weight_shapes(F, CD, *taps, down)} for _ in range(n_lvl)]
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    xv, xh = bf(mk(B, H, W, F)), bf(mk(B, H, W, F))
    sk = [(bf(mk(B, H, W, F)), bf(mk(B, H, W, F))) for _ in range(n_lvl)] if down else None
    cond = mk(B, CD)
    masks = [tuple((rng.rand(B, H, W, 2 * F) < KEEP).astype(np.float32) for _ in range(2))
             for _ in range(n_lvl)]
    return xv, xh, sk, cond, ws, masks


def _loss(outs, lib):
    return sum((lib.sin(o) * (0.5 + 0.25 * i)).sum() for i, o in enumerate(outs))


def _jax_run(mode, case):
    xv, xh, sk, cond, ws, masks = case
    jm = [(jnp.asarray(a), jnp.asarray(b)) for a, b in masks]
    kw = dict(keep=KEEP, compute_dtype=jnp.bfloat16, bc_fwd=1, bc_bwd=1,
              mask_mode="input", interpret=True)

    def fn(xv, xh, sk, cond, ws):
        lv = [{k: (v.reshape(1, -1) if k.startswith("b") else v) for k, v in w.items()}
              for w in ws]
        seed = jnp.zeros((), jnp.int32)
        if mode == "stream":
            outs = jgc.gated_stream(xv, xh, sk, cond, lv, seed, 2, masks=jm, **kw)
        elif mode == "pair":
            outs = [jgc.gated_pair(xv, xh, sk and sk[0], cond, lv[0], seed, 2, masks=jm[0],
                                   **kw)]
        else:
            outs = jgc.gated_segment(xv, xh, sk, cond, lv, seed, 0, masks=jm, **kw)
        return [t.astype(jnp.float32) for pair in outs for t in pair]

    outs = fn(xv, xh, sk, cond, ws)
    grads = jax.grad(lambda *a: _loss(fn(*a), jnp), argnums=(0, 1, 2, 3, 4))(
        xv, xh, sk, cond, ws)
    return [np.asarray(o) for o in outs], grads


@pytest.fixture(scope="module", params=list(CASES))
def compared(request):
    mode = request.param
    n_lvl, down = CASES[mode]
    case = _case(n_lvl, down)
    want_o, jg = _jax_run(mode, case)
    xv, xh, sk, cond, ws, masks = case
    t = lambda a: torch.tensor(a, requires_grad=True)
    txv, txh, tcond = t(xv), t(xh), t(cond)
    tws = [{k: t(v) for k, v in w.items()} for w in ws]
    tsk = [(t(a), t(b)) for a, b in sk] if sk else None
    tm = [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in masks]
    kw = dict(keep=KEEP, compute_dtype=torch.bfloat16)
    if mode == "stream":
        skips = tuple(torch.stack([p[i] for p in tsk]) for i in (0, 1)) if tsk else None
        ov, oh = gc.gated_stream_plain(txv, txh, skips, tcond, gc.stack_levels(tws),
                                       masks=tuple(torch.stack([m[i] for m in tm])
                                                   for i in (0, 1)), **kw)
        outs = [t for l in range(n_lvl) for t in (ov[l], oh[l])]
    elif mode == "pair":
        outs = list(gc.gated_pair_plain(txv, txh, tsk and tsk[0], tcond, tws[0], masks=tm[0],
                                        **kw))
    else:
        outs = [t for p in gc.gated_segment_plain(txv, txh, tsk, tcond, tws, masks=tm, **kw)
                for t in p]
    outs = [o.float() for o in outs]
    _loss(outs, torch).backward()
    got = {"outputs": [o.detach().numpy() for o in outs],
           "xv": txv.grad, "xh": txh.grad, "cond": tcond.grad}
    want = {"outputs": want_o, "xv": jg[0], "xh": jg[1], "cond": jg[3]}
    if sk:
        for l in range(n_lvl):
            for i, n in enumerate(("skv", "skh")):
                got[f"{n}{l}"], want[f"{n}{l}"] = tsk[l][i].grad, jg[2][l][i]
    for l in range(n_lvl):
        for k in ws[l]:
            got[f"{k}{l}"] = tws[l][k].grad
            want[f"{k}{l}"] = np.asarray(jg[4][l][k]).reshape(ws[l][k].shape)
    return mode, got, want


def _worst(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    return float(np.abs(got - want).max()) / scale


def test_outputs_match_jax(compared):
    mode, got, want = compared
    assert got["outputs"] and all(o.dtype == np.float32 for o in got["outputs"])
    for i, (g, w) in enumerate(zip(got["outputs"], want["outputs"])):
        np.testing.assert_allclose(g, w, rtol=VAL_RTOL, atol=VAL_ATOL, err_msg=f"{mode} {i}")


def test_gradients_match_jax(compared):
    mode, got, want = compared
    for name in want:
        if name == "outputs":
            continue
        g, w = got[name].numpy(), np.asarray(want[name], np.float32)
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL * scale,
                                   err_msg=f"{mode} {name}")


if __name__ == "__main__":
    for mode in CASES:
        class _R:
            param = mode
        m, got, want = compared.__wrapped__(_R())
        worst = {k: _worst(got[k], want[k]) for k in want if k != "outputs"}
        out = max(_worst(g, w) for g, w in zip(got["outputs"], want["outputs"]))
        print(f"{m}: outputs worst {out:.2e} of scale; gradients worst "
              f"{max(worst.values()):.2e} ({max(worst, key=worst.get)})", file=sys.stdout)

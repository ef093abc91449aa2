"""The block chain's bf16 builds (``csrc/block_chain_{fwd,bwd}.cu`` with
``-DPM_CORE_BF16=1``), emulated on the CPU, against the bf16 plain version.

The emulation, the bars (BF16_TOL, BF16_SHARE, SAVE_FLIPS, END_TOL) and the
float32 builds' cases are ``test_torch_block_kernel_emulated.py``'s; this
file builds only the bf16 libraries, so that the suite's workers (``--dist
loadfile``) build and run the two dtypes side by side. Skips where no C++20
compiler is found.
"""
import pytest
import torch

from posterior_matching_torch.ops import block_chain as bc
from test_torch_block_kernel_emulated import (
    END_TOL,
    _bf16_close,
    _saves_close,
    block_libraries,
    emulated_chain,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return block_libraries(tmp_path_factory, ("fwd_bf16", "bwd_bf16"))


# (b, h, w, L, k, (width, mid)): MNIST's (192, 48) at 2 x 7 x 5 with 3 x 3
# taps (70 rows: 16-row tiles, two weight-gradient splits), digits16's
# (64, 16) at 80 x 1 x 1 (k = 1, two splits); both on one build per source.
@pytest.mark.parametrize("b,h,w,L,k,geo", [
    (2, 7, 5, 2, 3, (192, 48)), (80, 1, 1, 2, 1, (64, 16)),
])
def test_emulated_bf16_block_chain_matches_plain(emu, b, h, w, L, k, geo):
    c, m = geo
    gen = torch.Generator().manual_seed(b * 100 + h * 10 + k + c + 7)
    x = torch.randn(b, h, w, c, generator=gen)
    weights = {n: (torch.randn((L, *s), generator=gen) * s[0] ** -0.5).contiguous()
               for n, s in bc.weight_shapes(c, m, k)}
    leaves = [x.requires_grad_(True), *(weights[n].requires_grad_(True) for n in bc.NAMES)]
    want = bc.block_chain_plain(x, weights, mid=m, k=k, compute_dtype=torch.bfloat16)
    cot = torch.randn(want.shape, generator=gen)
    grads_p = torch.autograd.grad(want, leaves, cot)

    cfg = bc.ChainConfig(x, L, m, k, torch.bfloat16)
    R = cfg.rows
    flat = lambda t: t.detach().reshape(R, c).contiguous()
    wk = {n: weights[n].detach().to(cfg.dtype_of(n)).contiguous() for n in bc.NAMES}
    outs, grads, part = emulated_chain(emu["fwd_bf16"], emu["bwd_bf16"], cfg, flat(x), wk,
                                       flat(cot), 2)
    assert part > 0
    assert all(outs[h_].dtype == torch.bfloat16 for h_ in ("h1", "h2", "h3"))
    # the forward: its output, and its saves against the plain forward's
    _bf16_close(outs["xout"][-1], flat(want), "x_final")
    with torch.no_grad():
        xs, plain_saves = x.detach(), []
        for lvl in range(L):
            *hs, h4 = bc.bf16_sub_fwd(xs, {n: weights[n][lvl].detach() for n in bc.NAMES}, k)
            plain_saves.append(hs)
            xs = xs + h4
    for i, name in enumerate(("h1", "h2", "h3")):
        _saves_close(outs[name], torch.stack([hs[i] for hs in plain_saves]).reshape(L, R, m),
                     name)
    # the backward against the plain backward from the kernel's saves
    shape = lambda t: t.reshape(L, b, h, w, -1).float()
    d_x0, d_w = bc.bf16_chain_bwd(x.detach(), shape(outs["xout"]),
                                  [shape(outs[n]) for n in ("h1", "h2", "h3")],
                                  {n: weights[n].detach() for n in bc.NAMES}, cot, k)
    for name, gp in zip(("x0", *bc.NAMES), grads_p):
        key = "dx0" if name == "x0" else "d" + name
        got = grads[-1][key]
        assert got.dtype == torch.float32
        _bf16_close(got.reshape(gp.shape), d_x0 if name == "x0" else d_w[name], name)
        _bf16_close(got.reshape(gp.shape), gp, name, END_TOL)
        assert torch.equal(grads[0][key], got), f"{name}: a relaunch changed the bits"

"""The decoder chain's bf16 builds (``csrc/decoder_chain_{fwd,bwd}.cu``
with ``-DPM_CORE_BF16=1``), emulated on the CPU, against the bf16 plain
version.

The emulation and the float32 builds' cases are
``test_torch_decoder_kernel_emulated.py``'s, the bars
``test_torch_block_kernel_emulated.py``'s; this file builds only the bf16
libraries, so that the suite's workers (``--dist loadfile``) build and run
the two dtypes side by side. Skips where no C++20 compiler is found.
"""
import pytest
import torch

from posterior_matching_torch.ops import decoder_chain as dc
from test_torch_decoder_kernel_emulated import _case, decoder_libraries, emulated_chain
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return decoder_libraries(tmp_path_factory, ("fwd_bf16", "bwd_bf16"))


@pytest.mark.parametrize("b,h,w,k", [(2, 7, 7, 3), (80, 1, 1, 1)])
def test_emulated_bf16_decoder_chain_matches_plain(emu, b, h, w, k):
    from posterior_matching_torch.ops import block_chain as bc
    from test_torch_block_kernel_emulated import END_TOL, _bf16_close, _saves_close

    c, m, ld = 64, 16, 8
    L = 2
    x0, acts, macts, eps, weights, gen = _case(b * 100 + h * 10 + k + 3, b, h, w, L, k, c, m, ld)
    leaves = [x0, acts, macts, *(weights[n] for n in dc.NAMES)]
    for t in leaves:
        t.requires_grad_(True)
    want = dc.dec_chain_plain(x0, acts, macts, eps, weights, ld=ld, k=k,
                              compute_dtype=torch.bfloat16)
    cot = [torch.randn(t.shape, generator=gen) for t in want]
    grads_p = torch.autograd.grad(want, leaves, cot)

    cfg = dc.DecConfig(x0, acts, L, m, ld, k, torch.bfloat16)
    R = cfg.rows
    flat = lambda t: t.detach().reshape(R, t.shape[-1]).contiguous()
    lvl = lambda t: t.detach().reshape(L, R, t.shape[-1]).contiguous()
    inputs = {"x0": flat(x0), "acts": flat(acts), "macts": flat(macts), "eps": lvl(eps),
              **{n: weights[n].detach().to(cfg.dtype_of(n)).contiguous() for n in dc.NAMES}}
    cots = {"g": flat(cot[0]), "gpost": lvl(cot[1]), "gprior": lvl(cot[2]),
            "gmask": lvl(cot[3])}
    outs, grads, part = emulated_chain(emu["fwd_bf16"], emu["bwd_bf16"], cfg, inputs, cots, 2)
    assert part > 0
    assert all(outs[s].dtype == torch.bfloat16 for s in dc.SAVES)
    for name, got, ref in zip(("x_final", "post", "prior", "masked"),
                              (outs["xout"][-1], outs["post"], outs["prior"], outs["masked"]),
                              want):
        _bf16_close(got, flat(ref) if name == "x_final" else lvl(ref), name)
    # the saves against the plain forward's, level by level
    with torch.no_grad():
        x_in, w_ = x0.detach(), {n: t.detach() for n, t in weights.items()}
        for lv in range(L):
            wl = {n: w_[n][lv] for n in dc.NAMES}
            blk = lambda tag: {n: wl[f"{tag}_{n}"] for n in bc.NAMES}
            *ph, post = bc.bf16_sub_fwd(torch.cat([x_in, acts.detach()], -1), blk("p"), k)
            *mh, _ = bc.bf16_sub_fwd(torch.cat([x_in, macts.detach()], -1), blk("m"), k)
            *qh, _ = bc.bf16_sub_fwd(x_in, blk("q"), k)
            for name, hs in zip(dc.SAVES, (*ph, *mh, *qh)):
                if name[0] != "r":
                    _saves_close(outs[name][lv], hs.reshape(R, m), name)
            x_in = outs["xout"][lv].reshape(x_in.shape)
    # the backward against the plain backward from the kernel's saves
    shape = lambda t: t.reshape(L, b, h, w, -1).float()
    d_x0, d_acts, d_macts, d_w = dc.bf16_dec_chain_bwd(
        x0.detach(), acts.detach(), macts.detach(), eps, shape(outs["xout"]),
        [shape(outs[n]) for n in dc.SAVES], w_, cot, ld=ld, k=k)
    plain = {"dx0": d_x0, "dacts": d_acts, "dmacts": d_macts,
             **{"d" + n: d_w[n] for n in dc.NAMES}}
    for name, gp, t in zip(("x0", "acts", "macts", *dc.NAMES), grads_p, leaves):
        key = {"x0": "dx0", "acts": "dacts", "macts": "dmacts"}.get(name, "d" + name)
        got = grads[-1][key].reshape(gp.shape)
        _bf16_close(got, plain[key].reshape(gp.shape), name)
        _bf16_close(got, gp, name, END_TOL)
        assert torch.equal(grads[0][key].reshape(gp.shape), got), \
            f"{name}: a relaunch changed the bits"

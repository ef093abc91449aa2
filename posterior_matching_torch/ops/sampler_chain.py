"""Per-row PixelCNN raster sampler (the imputation hot loop).

Counterpart of ``posterior_matching_tpu/ops/sampler_chain.py::
pixelcnn_sample_rowkernel`` (:340-788). Each image row takes two kernels:

- ``vrow`` (replaces ``_vrow_kernel_factory``, :124, ``pallas_call`` :557):
  the whole row's vertical stack. ``v_init`` and ``h_init_up`` from the two
  previous rows' code embeddings, then the L = 2 * num_resnet gated vertical
  levels, each a 6-tap (rows r-1 and r, columns c-1..c+1) conv as one wide-K
  matmul, concat_elu, the skip projection on down levels, the conditional
  projection and the sigmoid gate.
- ``row`` (replaces ``_row_kernel_factory``, :215, ``pallas_call`` :693):
  the horizontal chain pixel by pixel. At each pixel the L gated levels run
  on cached taps (previous row at columns c-1 and c, previous pixel), then
  the logits head, ``argmax(logits + gumbel)`` and the embedding of the
  sample for the next pixel.

Both kernels are CUDA C++ for ``sm_90a`` (``csrc/sampler_vrow.cu``,
``csrc/sampler_row.cu``), in float32 with float32 accumulation, each
compiled for the num_filters of :data:`KERNEL_WIDTHS` (the row kernel also
for logits chunks of 256 and 128 columns, so any ``num_indices`` that is a
multiple of 128); on the card a wrapper refuses other shapes by name.
Beside each is its plain PyTorch version (:func:`vrow_plain`,
:func:`row_plain`), which the wrapper runs only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.

Row tensors are column-major flat rows ``[W, n, C]`` (row ``c * n + j``);
per-level tensors are ``[L, W, n, C]``; ``n = num_samples * batch`` in
sample-major order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from posterior_matching_torch.models.pixelcnn import PixelCNN
from posterior_matching_torch.models.pixelcnn_fast import _conv_taps, _dense
from posterior_matching_torch.ops import _build
from posterior_matching_torch.ops.gated_block import _concat_elu, _elu

# Cached-tap order of the horizontal stacks: (-1,-1), (-1,0), (0,-1), then
# the in-chain (0,0) tap (then the aux slot).
_TAP_ORDER = ((-1, -1), (-1, 0), (0, -1), (0, 0))
# Vertical-stack tap orders: v_init reads rows r-2 and r-1, the gated
# vertical levels rows r-1 and r, h_init_up row r-1; dx = -1, 0, +1 each
# (dx = +1 is causal for the vertical stack).
_VI_ORDER = ((-2, -1), (-2, 0), (-2, 1), (-1, -1), (-1, 0), (-1, 1))
_VG_ORDER = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1))
_HU_ORDER = ((-1, -1), (-1, 0), (-1, 1))

# Shapes the kernels are compiled for: num_filters (csrc/sampler_common.cuh
# PMK_DISPATCH_WIDTHS: PM-VQVAE CelebA's and MNIST's 128, digits16's 64),
# the vrow kernel's 32 row slots, the row kernel's logits column chunks (256
# columns, or 128 where num_indices is an odd multiple of 128).
KERNEL_WIDTHS = (64, 128)
VROW_MAX_WIDTH = 32
ROW_LOGITS_CHUNK = 128


def _fuse_level(bp, f: int):
    """One horizontal gated level -> ``wa [12F, F]``, ``ba``, ``wb [8F, 2F]``,
    ``bb``. The 4F aux slot takes ``concat_elu(concat(aux_p, aux_q))``: up
    levels (aux = V_i, F wide) scatter their ``[2F, F]`` aux kernel into rows
    [8F:9F] and [10F:11F] with zeros between, so that ``aux_q = 0`` meets
    zero rows; down levels' ``[4F, F]`` kernels map directly."""
    (taps_a, bias_a), (taps_b, bias_b) = bp["a"], bp["b"]
    tap_a = {(dy, dx): w for dy, dx, w in taps_a}
    ak, ab = bp["aux"].kernel, bp["aux"].bias
    if ak.shape[0] == 2 * f:
        z = torch.zeros(f, ak.shape[1], dtype=ak.dtype, device=ak.device)
        aux_rows = torch.cat([ak[:f], z, ak[f:], z], 0)
    elif ak.shape[0] == 4 * f:
        aux_rows = ak
    else:
        raise ValueError(f"unexpected aux kernel rows {ak.shape[0]}")
    wa = torch.cat([tap_a[o] for o in _TAP_ORDER] + [aux_rows], 0)
    tap_b = {(dy, dx): w for dy, dx, w in taps_b}
    wb = torch.cat([tap_b[o] for o in _TAP_ORDER], 0)
    return wa, bias_a + ab, wb, bias_b


def _vtap_stack(taps_bias, order):
    taps, bias = taps_bias
    tapmap = {(dy, dx): w for dy, dx, w in taps}
    return torch.cat([tapmap[o] for o in order], 0), bias


@dataclass
class SamplerWeights:
    """The PixelCNN's weights cut into the kernels' fused stacks (all f32,
    contiguous, on the model's device)."""

    viw: torch.Tensor   # [6F, F]    v_init taps
    vib: torch.Tensor   # [F]
    huw: torch.Tensor   # [3F, F]    h_init_up taps
    hub: torch.Tensor   # [F]
    wav: torch.Tensor   # [L, 12F, F]  vertical conv_a taps
    bav: torch.Tensor   # [L, F]       (+ aux bias on down levels)
    wbv: torch.Tensor   # [L, 12F, 2F] vertical conv_b taps
    bbv: torch.Tensor   # [L, 2F]
    waux: torch.Tensor  # [L, 2F, F]   vertical skip projection (0 on up levels)
    wa: torch.Tensor    # [L, 12F, F]  horizontal conv_a taps + aux slot
    ba: torch.Tensor    # [L, F]
    wb: torch.Tensor    # [L, 8F, 2F]  horizontal conv_b taps
    bb: torch.Tensor    # [L, 2F]
    hlw: torch.Tensor   # [2F, F]    h_init_left taps (-1,-1), (0,-1)
    hlb: torch.Tensor   # [F]
    lw: torch.Tensor    # [F, K]     logits head
    lb: torch.Tensor    # [K]
    emb: torch.Tensor   # [K, F]     code embedding


@torch.no_grad()
def fuse_sampler_weights(pixel_cnn: PixelCNN) -> SamplerWeights:
    if tuple(pixel_cnn.receptive_field_dims) != (3, 3):
        raise ValueError("the sampler supports receptive_field_dims == (3, 3)")
    p = pixel_cnn.layers
    f = pixel_cnn.num_filters
    n_res = pixel_cnn.num_resnet

    def block(tag):
        # vertical taps (0,2)x(0,3): look-right dx=+1 is causal there;
        # horizontal (0,2)x(0,2)
        cols = (0, 3) if "vertical" in tag else (0, 2)
        return {
            "a": _conv_taps(p[f"{tag}_conv_a"], (0, 2), cols),
            "b": _conv_taps(p[f"{tag}_conv_b"], (0, 2), cols),
            "aux": p[f"{tag}_aux"] if f"{tag}_aux" in p else None,
        }

    vert = [block(f"{d}_0_{r}_vertical") for d in ("up", "dn") for r in range(n_res)]
    horiz = [block(f"{d}_0_{r}_horizontal") for d in ("up", "dn") for r in range(n_res)]

    viw, vib = _vtap_stack(_conv_taps(p["v_init"], (0, 2), (0, 3)), _VI_ORDER)
    huw, hub = _vtap_stack(_conv_taps(p["h_init_up"], (0, 1), (0, 3)), _HU_ORDER)
    wav, bav, wbv, bbv, waux = [], [], [], [], []
    for lvl, bp in enumerate(vert):
        wa_, ba_ = _vtap_stack(bp["a"], _VG_ORDER)
        wb_, bb_ = _vtap_stack(bp["b"], _VG_ORDER)
        if lvl >= n_res:
            waux.append(bp["aux"].kernel)
            ba_ = ba_ + bp["aux"].bias
        else:
            waux.append(torch.zeros_like(wa_[: 2 * f]))
        wav.append(wa_)
        bav.append(ba_)
        wbv.append(wb_)
        bbv.append(bb_)
    fused = [_fuse_level(bp, f) for bp in horiz]
    hleft_taps, hlb = _conv_taps(p["h_init_left"], (0, 2), (0, 1))

    def prep(x):
        return x.detach().float().contiguous()

    return SamplerWeights(
        viw=prep(viw), vib=prep(vib), huw=prep(huw), hub=prep(hub),
        wav=prep(torch.stack(wav)), bav=prep(torch.stack(bav)),
        wbv=prep(torch.stack(wbv)), bbv=prep(torch.stack(bbv)),
        waux=prep(torch.stack(waux)),
        wa=prep(torch.stack([x[0] for x in fused])),
        ba=prep(torch.stack([x[1] for x in fused])),
        wb=prep(torch.stack([x[2] for x in fused])),
        bb=prep(torch.stack([x[3] for x in fused])),
        hlw=prep(torch.cat([w for _, _, w in hleft_taps], 0)), hlb=prep(hlb),
        lw=prep(p["logits_conv"].kernel[0, 0]), lb=prep(p["logits_conv"].bias),
        emb=prep(pixel_cnn.embed),
    )


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _shift3(x: torch.Tensor) -> torch.Tensor:
    """``[W, n, C] -> [W, n, 3C]``: the columns c-1, c, c+1 side by side,
    zero off the row (the vertical convs' three dx taps as one operand)."""
    z = torch.zeros_like(x[:1])
    return torch.cat(
        [torch.cat([z, x[:-1]], 0), x, torch.cat([x[1:], z], 0)], -1
    )


def vrow_plain(
    e2, e1, pv0, pv, pm, cpv, viw, vib, huw, hub, wav, bav, wbv, bbv, waux,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One image row's vertical stack.

    ``e2``/``e1``: code embeddings of rows r-2 and r-1, ``[W, n, F]``;
    ``pv0``, ``pv [L, W, n, F]``, ``pm [L, W, n, 2F]``: the previous row's
    ``v0``, level outputs and level intermediates; ``cpv [L, n, 2F]``: the
    conditional projections. Returns ``outv [L, W, n, F]`` (the aux cues of
    the horizontal levels), ``outm [L, W, n, 2F]``, ``v0`` and ``hup``
    (``[W, n, F]`` each).
    """
    n_lvl = wav.shape[0]
    n_res = n_lvl // 2
    f = e1.shape[-1]
    v0 = torch.cat([_shift3(e2), _shift3(e1)], -1) @ viw + vib
    hup = _shift3(e1) @ huw + hub
    vstack = [v0]  # v0, then the up levels' outputs: the down levels' skips
    cur = v0
    outv, outm = [], []
    for lvl in range(n_lvl):
        prev = pv0 if lvl == 0 else pv[lvl - 1]
        a = torch.cat(
            [_shift3(_concat_elu(prev)), _shift3(_concat_elu(cur))], -1
        ) @ wav[lvl] + bav[lvl]
        if lvl >= n_res:
            a = a + _concat_elu(vstack[2 * n_res - 1 - lvl]) @ waux[lvl]
        m = _concat_elu(a)
        b = torch.cat([_shift3(pm[lvl]), _shift3(m)], -1) @ wbv[lvl] \
            + bbv[lvl] + cpv[lvl][None]
        cur = cur + torch.sigmoid(b[..., f:]) * b[..., :f]
        outv.append(cur)
        outm.append(m)
        if lvl + 1 <= n_res:
            vstack.append(cur)
    return torch.stack(outv), torch.stack(outm), v0, hup


def row_plain(
    wa, ba, wb, bb, cph, prevh, prevm, aux, hup, e1, gumbel,
    emb, lw, lb, hlw, hlb, with_logits: bool = False,
):
    """One image row's horizontal chain, pixel by pixel.

    ``prevh [L, W, n, F]`` / ``prevm [L, W, n, 2F]``: the previous row's
    per-level chain inputs and intermediates (this function's ``outh`` /
    ``outm`` one row earlier); ``aux [L, W, n, F]``: this row's vertical
    outputs; ``hup``, ``e1``: ``[W, n, F]``; ``gumbel [W, n, K]``.
    Returns ``(outh, outm, samples [W, n] int32, logits [W, n, K] or None)``.
    """
    n_lvl, wid, n, f = prevh.shape
    n_res = n_lvl // 2
    zf = prevh.new_zeros(n, f)
    z2f = prevm.new_zeros(n, 2 * f)
    outh = torch.empty_like(prevh)
    outm = torch.empty_like(prevm)
    samples = torch.empty(wid, n, dtype=torch.int32, device=prevh.device)
    logits_out = (
        gumbel.new_empty(wid, n, lw.shape[1]) if with_logits else None
    )
    h0cur = zf
    for c in range(wid):
        # T_0: h_init_up (row pass) + h_init_left's taps (-1,-1) and (0,-1),
        # both zero at the row's first column
        h0p = e1[c - 1] if c > 0 else zf
        h0c = h0cur if c > 0 else zf
        xin = hup[c] + torch.cat([h0p, h0c], -1) @ hlw + hlb
        for lvl in range(n_lvl):
            old_h = outh[lvl, c - 1] if c > 0 else zf
            old_m = outm[lvl, c - 1] if c > 0 else z2f
            outh[lvl, c] = xin
            aux_p = aux[lvl, c]
            # down levels: the skip is this pixel's chain input at level
            # 2R-1-lvl, written earlier in this pixel
            aux_q = outh[2 * n_res - 1 - lvl, c] if lvl >= n_res else zf
            tap_aa = prevh[lvl, c - 1] if c > 0 else zf
            a_in = torch.cat([
                _concat_elu(tap_aa), _concat_elu(prevh[lvl, c]),
                _concat_elu(old_h), _concat_elu(xin),
                _elu(aux_p), _elu(aux_q), _elu(-aux_p), _elu(-aux_q),
            ], -1)
            m = _concat_elu(a_in @ wa[lvl] + ba[lvl])
            tap_ba = prevm[lvl, c - 1] if c > 0 else z2f
            b = torch.cat([tap_ba, prevm[lvl, c], old_m, m], -1) @ wb[lvl] \
                + bb[lvl] + cph[lvl]
            outm[lvl, c] = m
            xin = xin + torch.sigmoid(b[:, f:]) * b[:, :f]
        logits = _elu(xin) @ lw + lb
        y = torch.argmax(logits + gumbel[c], -1)
        samples[c] = y.to(torch.int32)
        if with_logits:
            logits_out[c] = logits
        h0cur = emb[y]
    return outh, outm, samples, logits_out


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_check, _on_cpu, _raise_on = _build.check, _build.on_cpu, _build.raise_on


def _load(name: str, fn: str, nptr: int, nint: int):
    return _build.load_fn(name, fn, [_build.P] * nptr + [_build.I] * nint + [_build.P])


def _check_width(kernel: str, f: int, n_lvl: int):
    if f not in KERNEL_WIDTHS or n_lvl % 2:
        raise ValueError(
            f"{kernel} kernel is built for num_filters in {KERNEL_WIDTHS} "
            f"and needs an even level count, got F={f}, L={n_lvl}"
        )


class _Vrow:
    """Wrapper of ``csrc/sampler_vrow.cu``. ``launches`` counts kernel
    launches; the plain version (CPU tensors) does not count."""

    def __init__(self):
        self.launches = 0

    def __call__(self, e2, e1, pv0, pv, pm, cpv, viw, vib, huw, hub,
                 wav, bav, wbv, bbv, waux):
        args = (e2, e1, pv0, pv, pm, cpv, viw, vib, huw, hub,
                wav, bav, wbv, bbv, waux)
        if _on_cpu(args):
            return vrow_plain(*args)
        n_lvl, wid, n, f = pv.shape
        _check_width("vrow", f, n_lvl)
        if not 1 <= wid <= VROW_MAX_WIDTH:
            raise ValueError(
                f"vrow kernel needs 1 <= W <= {VROW_MAX_WIDTH}, got W={wid}"
            )
        shapes = {
            "e2": (wid, n, f), "e1": (wid, n, f), "pv0": (wid, n, f),
            "pv": (n_lvl, wid, n, f), "pm": (n_lvl, wid, n, 2 * f),
            "cpv": (n_lvl, n, 2 * f), "viw": (6 * f, f), "vib": (f,),
            "huw": (3 * f, f), "hub": (f,), "wav": (n_lvl, 12 * f, f),
            "bav": (n_lvl, f), "wbv": (n_lvl, 12 * f, 2 * f),
            "bbv": (n_lvl, 2 * f), "waux": (n_lvl, 2 * f, f),
        }
        ptrs = [_check(k, t, shapes[k]) for k, t in zip(shapes, args)]
        outv = torch.empty_like(pv)
        outm = torch.empty_like(pm)
        v0 = torch.empty_like(e1)
        hup = torch.empty_like(e1)
        lib = _load("sampler_vrow", "pm_sampler_vrow", 19, 4)
        stream = torch.cuda.current_stream(e1.device).cuda_stream
        err = lib.pm_sampler_vrow(
            *ptrs, outv.data_ptr(), outm.data_ptr(), v0.data_ptr(),
            hup.data_ptr(), n_lvl, wid, n, f, stream,
        )
        self.launches += 1
        _raise_on(lib, err, "sampler_vrow")
        return outv, outm, v0, hup


def vrow_blocks(wid: int, n: int) -> int:
    """Blocks of one ``vrow`` kernel launch at width ``wid`` and ``n``
    samples, as the kernel's entry point splits them."""
    fn = _build.load("sampler_vrow").pm_sampler_vrow_blocks
    fn.argtypes, fn.restype = [_build.I, _build.I], _build.I
    return fn(wid, n)


class _Row:
    """Wrapper of ``csrc/sampler_row.cu``. ``launches`` counts kernel
    launches; the plain version (CPU tensors) does not count."""

    def __init__(self):
        self.launches = 0

    def __call__(self, wa, ba, wb, bb, cph, prevh, prevm, aux, hup, e1,
                 gumbel, emb, lw, lb, hlw, hlb, with_logits: bool = False):
        args = (wa, ba, wb, bb, cph, prevh, prevm, aux, hup, e1, gumbel,
                emb, lw, lb, hlw, hlb)
        if _on_cpu(args):
            return row_plain(*args, with_logits=with_logits)
        n_lvl, wid, n, f = prevh.shape
        k = lw.shape[1]
        _check_width("row", f, n_lvl)
        if k % ROW_LOGITS_CHUNK:
            raise ValueError(
                f"row kernel needs num_indices % {ROW_LOGITS_CHUNK} "
                f"== 0, got {k}"
            )
        shapes = {
            "wa": (n_lvl, 12 * f, f), "ba": (n_lvl, f),
            "wb": (n_lvl, 8 * f, 2 * f), "bb": (n_lvl, 2 * f),
            "cph": (n_lvl, n, 2 * f), "prevh": (n_lvl, wid, n, f),
            "prevm": (n_lvl, wid, n, 2 * f), "aux": (n_lvl, wid, n, f),
            "hup": (wid, n, f), "e1": (wid, n, f), "gumbel": (wid, n, k),
            "emb": (k, f), "lw": (f, k), "lb": (k,), "hlw": (2 * f, f),
            "hlb": (f,),
        }
        ptrs = [_check(key, t, shapes[key]) for key, t in zip(shapes, args)]
        outh = torch.empty_like(prevh)
        outm = torch.empty_like(prevm)
        samples = torch.empty(wid, n, dtype=torch.int32, device=prevh.device)
        logits = gumbel.new_empty(wid, n, k) if with_logits else None
        lib = _load("sampler_row", "pm_sampler_row", 20, 5)
        stream = torch.cuda.current_stream(prevh.device).cuda_stream
        err = lib.pm_sampler_row(
            *ptrs, outh.data_ptr(), outm.data_ptr(), samples.data_ptr(),
            logits.data_ptr() if with_logits else None,
            n_lvl, wid, n, k, f, stream,
        )
        self.launches += 1
        _raise_on(lib, err, "sampler_row")
        return outh, outm, samples, logits


vrow = _Vrow()
row = _Row()


# ---------------------------------------------------------------------------
# The raster sampler
# ---------------------------------------------------------------------------


def cond_projections(
    pixel_cnn: PixelCNN, cond: Optional[torch.Tensor], n: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each gated level's conditional projection of ``cond [n, D]`` (or
    zeros without a condition): ``cpv`` for the vertical levels and ``cph``
    for the horizontal ones, ``[L, n, 2F]`` each, up levels first."""
    layers = pixel_cnn.layers
    f = pixel_cnn.num_filters

    def proj(tag):
        key = f"{tag}_cond_proj"
        if cond is None or key not in layers:
            return torch.zeros(n, 2 * f, device=pixel_cnn.embed.device)
        return _dense(layers[key], cond)

    tags = [f"{d}_0_{r}" for d in ("up", "dn") for r in range(pixel_cnn.num_resnet)]
    cpv = torch.stack([proj(f"{t}_vertical") for t in tags]).contiguous()
    cph = torch.stack([proj(f"{t}_horizontal") for t in tags]).contiguous()
    return cpv, cph


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise, ``-log(-log(u))`` with ``u`` in [tiny, 1) as
    ``jax.random.gumbel`` draws it."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


@torch.no_grad()
def pixelcnn_sample(
    pixel_cnn: PixelCNN,
    num_samples: int,
    conditional_input: Optional[torch.Tensor] = None,
    *,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    return_logits: bool = False,
):
    """Raster-samples code grids, one ``vrow`` and one ``row`` call per
    image row.

    The Gumbel noise is either given, ``noise [H, W, n, K]`` float32 (the
    layout of the JAX sampler's ``noise=``), or drawn on the model's device
    from ``generator`` one image row at a time. ``n`` is sample-major
    (``conditional_input`` is broadcast to ``[S, B]``).

    Returns ``[S, B, H, W]`` int64 (``[S, H, W]`` when unconditional), and
    with ``return_logits`` also the logits ``[n, H, W, K]``.
    """
    if (noise is None) == (generator is None):
        raise ValueError("pass exactly one of noise= and generator=")
    device = pixel_cnn.embed.device
    w = fuse_sampler_weights(pixel_cnn)
    f = pixel_cnn.num_filters
    hgt, wid = pixel_cnn.image_shape
    n_res = pixel_cnn.num_resnet
    n_lvl = 2 * n_res
    num_idx = w.emb.shape[0]

    if conditional_input is not None:
        bsz = conditional_input.shape[0]
        cond = conditional_input.float()[None].expand(
            num_samples, *conditional_input.shape
        ).reshape(num_samples * bsz, -1)
        n = num_samples * bsz
    else:
        bsz, cond, n = None, None, num_samples
    if noise is not None and tuple(noise.shape) != (hgt, wid, n, num_idx):
        raise ValueError(
            f"noise must be [H, W, n, K] = {(hgt, wid, n, num_idx)}, got "
            f"{tuple(noise.shape)}"
        )

    cpv, cph = cond_projections(pixel_cnn, cond, n)
    zeros_row = torch.zeros(wid, n, f, device=device)
    e2, e1 = zeros_row, zeros_row
    pv0 = zeros_row
    pv = torch.zeros(n_lvl, wid, n, f, device=device)
    pm = torch.zeros(n_lvl, wid, n, 2 * f, device=device)
    prevh, prevm = pv, pm
    samples, logits = [], []
    for r in range(hgt):
        outv, outm_v, v0, hup = vrow(
            e2, e1, pv0, pv, pm, cpv, w.viw, w.vib, w.huw, w.hub,
            w.wav, w.bav, w.wbv, w.bbv, w.waux,
        )
        if noise is not None:
            g = noise[r].to(device=device, dtype=torch.float32).contiguous()
        else:
            g = gumbel_noise((wid, n, num_idx), generator, device)
        prevh, prevm, s_row, l_row = row(
            w.wa, w.ba, w.wb, w.bb, cph, prevh, prevm, outv, hup, e1, g,
            w.emb, w.lw, w.lb, w.hlw, w.hlb, with_logits=return_logits,
        )
        samples.append(s_row)
        logits.append(l_row)
        e2, e1 = e1, w.emb[s_row.long()]
        pv0, pv, pm = v0, outv, outm_v
    out = torch.stack(samples).permute(2, 0, 1).long()  # [n, H, W]
    if bsz is not None:
        out = out.reshape(num_samples, bsz, hgt, wid)
    if return_logits:
        return out, torch.stack(logits).permute(2, 0, 1, 3)
    return out

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
``csrc/sampler_row.cu``), each compiled for the num_filters of
:data:`KERNEL_WIDTHS` (the row kernel also for logits chunks of 256 and 128
columns, so any ``num_indices`` that is a multiple of 128); on the card a
wrapper refuses other shapes by name. Each is built twice, for the JAX
kernels' two compute dtypes: float32, and bfloat16 (``-DPM_CORE_BF16=1``,
the ``*_bf16`` libraries), where the weights, the matrix operands and the
row state are bf16 and every product sums in float32. Beside each is its
plain PyTorch version (:func:`vrow_plain`, :func:`row_plain`, both with a
``compute_dtype``), which a wrapper runs only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.

bfloat16 mirrors where the JAX kernels round (``sampler_chain.py:124-330,
406-439, 536-549, 706-780``): the weight stacks, the code embedding and the
conditional projections are bf16, the biases and the Gumbel noise float32;
every matrix operand is rounded to bf16 and multiplied in float32 (a product
of two bf16 values is exact in float32, as ``preferred_element_type=f32``);
the row state carried between launches (``v0``, ``hup``, ``outv``,
``outm``, ``outh``, the row's embeddings) is bf16. The vertical stack's
running value stays float32 within a launch (its down levels' skips read
the rounded outputs); the horizontal chain's is rounded at the start of
each pixel and then once every ``lpg`` levels (:func:`levels_per_group`,
the JAX row kernel's levels per grid step), and the logits read the last
group's unrounded value.

Row tensors are column-major flat rows ``[W, n, C]`` (row ``c * n + j``);
per-level tensors are ``[L, W, n, C]``; ``n = num_samples * batch`` in
sample-major order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import os

import torch

from posterior_matching_torch.models.pixelcnn import PixelCNN, gumbel_noise
from posterior_matching_torch.models.pixelcnn_fast import _conv_taps, _dense
from posterior_matching_torch.ops import _build
from posterior_matching_torch.ops.block_chain import round_bf16
from posterior_matching_torch.ops.gated_block import _concat_elu, _elu
from posterior_matching_torch.runtime import torch_dtype

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


def levels_per_group(n_lvl: int, lpg: Optional[int] = None) -> int:
    """The bf16 row chain's rounding cadence: ``lpg`` (by default
    ``$PM_TPU_SAMPLER_LPG``, else 4, as the JAX sampler reads it) lowered
    until it divides ``n_lvl`` (``sampler_chain.py:617-619``)."""
    if lpg is None:
        lpg = int(os.environ.get("PM_TPU_SAMPLER_LPG", "4"))
    if lpg < 1:
        raise ValueError(f"levels per group must be >= 1, got {lpg}")
    while n_lvl % lpg:
        lpg -= 1
    return lpg


def _rounder(compute_dtype):
    """``(dtype, rd)``: the compute dtype and the rounding to it of float32
    values (the identity in float32)."""
    dtype = torch_dtype(compute_dtype)
    if dtype == torch.bfloat16:
        return dtype, round_bf16
    return dtype, lambda t: t


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
    """The PixelCNN's weights cut into the kernels' fused stacks (contiguous,
    on the model's device): the biases float32, the rest at the compute
    dtype."""

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
def fuse_sampler_weights(pixel_cnn: PixelCNN, compute_dtype="float32") -> SamplerWeights:
    """The kernels' weight stacks at ``compute_dtype`` ("float32" or
    "bfloat16"; the biases stay float32). The row kernels take one
    hierarchy and the (3, 3) receptive field (:func:`row_sampler_topology`)."""
    if not row_sampler_topology(pixel_cnn):
        raise ValueError(
            "the row sampler takes num_hierarchies == 1 and receptive_field_dims "
            f"== (3, 3), got {pixel_cnn.num_hierarchies} and "
            f"{tuple(pixel_cnn.receptive_field_dims)}"
        )
    cdtype = torch_dtype(compute_dtype)
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

    def prep(x, dtype=torch.float32):
        return x.detach().float().to(dtype).contiguous()

    def wt(x):
        return prep(x, cdtype)

    return SamplerWeights(
        viw=wt(viw), vib=prep(vib), huw=wt(huw), hub=prep(hub),
        wav=wt(torch.stack(wav)), bav=prep(torch.stack(bav)),
        wbv=wt(torch.stack(wbv)), bbv=prep(torch.stack(bbv)),
        waux=wt(torch.stack(waux)),
        wa=wt(torch.stack([x[0] for x in fused])),
        ba=prep(torch.stack([x[1] for x in fused])),
        wb=wt(torch.stack([x[2] for x in fused])),
        bb=prep(torch.stack([x[3] for x in fused])),
        hlw=wt(torch.cat([w for _, _, w in hleft_taps], 0)), hlb=prep(hlb),
        lw=wt(p["logits_conv"].kernel[0, 0]), lb=prep(p["logits_conv"].bias),
        emb=wt(pixel_cnn.embed),
    )


def row_sampler_topology(pixel_cnn: PixelCNN) -> bool:
    """Whether the row kernels take this PixelCNN: one hierarchy and the
    (3, 3) receptive field, the JAX row-kernel and cached samplers' test
    (``pm_vqvae.py:150-153``, ``sampler_chain.py:360-365``)."""
    return (pixel_cnn.num_hierarchies == 1
            and tuple(pixel_cnn.receptive_field_dims) == (3, 3))


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
    compute_dtype="float32",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One image row's vertical stack.

    ``e2``/``e1``: code embeddings of rows r-2 and r-1, ``[W, n, F]``;
    ``pv0``, ``pv [L, W, n, F]``, ``pm [L, W, n, 2F]``: the previous row's
    ``v0``, level outputs and level intermediates; ``cpv [L, n, 2F]``: the
    conditional projections. Returns ``outv [L, W, n, F]`` (the aux cues of
    the horizontal levels), ``outm [L, W, n, 2F]``, ``v0`` and ``hup``
    (``[W, n, F]`` each), at ``compute_dtype``. In bfloat16 the carry
    stays float32 and each product reads its operands rounded to bf16
    (``_vrow_kernel_factory``, ``sampler_chain.py:124-212``).
    """
    cdtype, rd = _rounder(compute_dtype)
    e2, e1, pv0, pv, pm, cpv = (t.float() for t in (e2, e1, pv0, pv, pm, cpv))
    viw, huw, wav, wbv, waux = (rd(t.float()) for t in (viw, huw, wav, wbv, waux))
    n_lvl = wav.shape[0]
    n_res = n_lvl // 2
    f = e1.shape[-1]
    v0 = rd(torch.cat([_shift3(e2), _shift3(e1)], -1)) @ viw + vib
    hup = rd(_shift3(e1)) @ huw + hub
    vstack = [rd(v0)]  # v0, then the up levels' outputs: the down levels' skips
    cur = v0
    outv, outm = [], []
    for lvl in range(n_lvl):
        prev = pv0 if lvl == 0 else pv[lvl - 1]
        a = rd(torch.cat(
            [_shift3(_concat_elu(prev)), _shift3(_concat_elu(cur))], -1
        )) @ wav[lvl] + bav[lvl]
        if lvl >= n_res:
            a = a + rd(_concat_elu(vstack[2 * n_res - 1 - lvl])) @ waux[lvl]
        m = _concat_elu(a)
        b = rd(torch.cat([_shift3(pm[lvl]), _shift3(m)], -1)) @ wbv[lvl] \
            + bbv[lvl] + rd(cpv[lvl])[None]
        cur = cur + torch.sigmoid(b[..., f:]) * b[..., :f]
        outv.append(cur)
        outm.append(m)
        if lvl + 1 <= n_res:
            vstack.append(rd(cur))
    return tuple(t.to(cdtype) for t in (torch.stack(outv), torch.stack(outm), v0, hup))


def row_plain(
    wa, ba, wb, bb, cph, prevh, prevm, aux, hup, e1, gumbel,
    emb, lw, lb, hlw, hlb, with_logits: bool = False,
    compute_dtype="float32", lpg: int = 1,
):
    """One image row's horizontal chain, pixel by pixel.

    ``prevh [L, W, n, F]`` / ``prevm [L, W, n, 2F]``: the previous row's
    per-level chain inputs and intermediates (this function's ``outh`` /
    ``outm`` one row earlier); ``aux [L, W, n, F]``: this row's vertical
    outputs; ``hup``, ``e1``: ``[W, n, F]``; ``gumbel [W, n, K]``.
    Returns ``(outh, outm, samples [W, n] int32, logits [W, n, K] or None)``,
    ``outh`` and ``outm`` at ``compute_dtype``. In bfloat16 (the JAX row
    kernel, ``sampler_chain.py:215-330``) each product reads its operands
    rounded to bf16; the chain value is rounded at the pixel's start and
    then before every ``lpg``-th level (``lpg`` divides L; it changes
    nothing in float32), and the logits read the last group's unrounded
    value.
    """
    cdtype, rd = _rounder(compute_dtype)
    bf16 = cdtype == torch.bfloat16
    prevh, prevm, aux, hup, e1, cph = (t.float() for t in (prevh, prevm, aux, hup, e1, cph))
    wa, wb, emb, lw, hlw = (rd(t.float()) for t in (wa, wb, emb, lw, hlw))
    n_lvl, wid, n, f = prevh.shape
    if n_lvl % lpg:
        raise ValueError(f"lpg {lpg} must divide the level count {n_lvl}")
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
        if bf16:
            xin = rd(hup[c] + (torch.cat([h0p, h0c], -1) @ hlw + hlb))
        else:
            xin = hup[c] + torch.cat([h0p, h0c], -1) @ hlw + hlb
        for lvl in range(n_lvl):
            if lvl % lpg == 0:
                xin = rd(xin)
            old_h = outh[lvl, c - 1] if c > 0 else zf
            old_m = outm[lvl, c - 1] if c > 0 else z2f
            outh[lvl, c] = rd(xin)
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
            m = _concat_elu(rd(a_in) @ wa[lvl] + ba[lvl])
            tap_ba = prevm[lvl, c - 1] if c > 0 else z2f
            b = rd(torch.cat([tap_ba, prevm[lvl, c], old_m, m], -1)) @ wb[lvl] \
                + bb[lvl] + rd(cph[lvl])
            outm[lvl, c] = rd(m)
            xin = xin + torch.sigmoid(b[:, f:]) * b[:, :f]
        logits = rd(_elu(xin)) @ lw + lb
        y = torch.argmax(logits + gumbel[c], -1)
        samples[c] = y.to(torch.int32)
        if with_logits:
            logits_out[c] = logits
        h0cur = emb[y]
    return outh.to(cdtype), outm.to(cdtype), samples, logits_out


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


class _Wrapper:
    """A sampler kernel's build for ``compute_dtype`` (:func:`_build.
    bf16_build`): the arguments named in ``CDT`` at that dtype, the others
    float32. ``launches`` counts kernel launches; the plain version (CPU
    tensors) does not count."""

    KERNEL = ""
    NAMES: Tuple[str, ...] = ()
    CDT: Tuple[str, ...] = ()

    def __init__(self, compute_dtype=torch.float32):
        self.cdtype = torch_dtype(compute_dtype)
        self.lib = _build.bf16_build(self.KERNEL, self.cdtype)
        self.launches = 0

    def dtype(self, name: str) -> torch.dtype:
        return self.cdtype if name in self.CDT else torch.float32

    def check_dtypes(self, args):
        """Raises unless every argument has its dtype (a build takes one)."""
        for name, t in zip(self.NAMES, args):
            if t.dtype != self.dtype(name):
                raise ValueError(f"{self.lib}: {name} must be {self.dtype(name)}, got "
                                 f"{t.dtype} (the {self.cdtype} build)")


class _Vrow(_Wrapper):
    """Wrapper of ``csrc/sampler_vrow.cu``: ``e2``, ``e1``, ``pv0``, ``pv``,
    ``pm``, ``cpv`` and the weight matrices at the build's dtype, the
    biases float32; the outputs at the build's dtype."""

    KERNEL = "sampler_vrow"
    NAMES = ("e2", "e1", "pv0", "pv", "pm", "cpv", "viw", "vib", "huw", "hub",
             "wav", "bav", "wbv", "bbv", "waux")
    CDT = ("e2", "e1", "pv0", "pv", "pm", "cpv", "viw", "huw", "wav", "wbv", "waux")

    def __call__(self, e2, e1, pv0, pv, pm, cpv, viw, vib, huw, hub,
                 wav, bav, wbv, bbv, waux):
        args = (e2, e1, pv0, pv, pm, cpv, viw, vib, huw, hub,
                wav, bav, wbv, bbv, waux)
        self.check_dtypes(args)
        if _on_cpu(args):
            return vrow_plain(*args, compute_dtype=self.cdtype)
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
        ptrs = [_check(k, t, shapes[k], self.dtype(k)) for k, t in zip(shapes, args)]
        outv = torch.empty_like(pv)
        outm = torch.empty_like(pm)
        v0 = torch.empty_like(e1)
        hup = torch.empty_like(e1)
        lib = _load(self.lib, "pm_sampler_vrow", 19, 5)
        stream = torch.cuda.current_stream(e1.device).cuda_stream
        err = lib.pm_sampler_vrow(
            *ptrs, outv.data_ptr(), outm.data_ptr(), v0.data_ptr(),
            hup.data_ptr(), n_lvl, wid, n, f, int(self.cdtype == torch.bfloat16), stream,
        )
        self.launches += 1
        _raise_on(lib, err, self.lib)
        return outv, outm, v0, hup


def vrow_blocks(wid: int, n: int) -> int:
    """Blocks of one ``vrow`` kernel launch at width ``wid`` and ``n``
    samples, as the kernel's entry point splits them."""
    fn = _build.load("sampler_vrow").pm_sampler_vrow_blocks
    fn.argtypes, fn.restype = [_build.I, _build.I], _build.I
    return fn(wid, n)


class _Row(_Wrapper):
    """Wrapper of ``csrc/sampler_row.cu``: ``cph``, ``prevh``, ``prevm``,
    ``aux``, ``hup``, ``e1`` and the weight matrices (``wa``, ``wb``,
    ``emb``, ``lw``, ``hlw``) at the build's dtype, the biases and
    ``gumbel`` float32; ``outh`` and ``outm`` at the build's dtype, the
    logits float32. ``lpg``: the bf16 chain's rounding cadence (a divisor
    of L; :func:`levels_per_group`)."""

    KERNEL = "sampler_row"
    NAMES = ("wa", "ba", "wb", "bb", "cph", "prevh", "prevm", "aux", "hup", "e1",
             "gumbel", "emb", "lw", "lb", "hlw", "hlb")
    CDT = ("wa", "wb", "cph", "prevh", "prevm", "aux", "hup", "e1", "emb", "lw", "hlw")

    def __call__(self, wa, ba, wb, bb, cph, prevh, prevm, aux, hup, e1,
                 gumbel, emb, lw, lb, hlw, hlb, with_logits: bool = False,
                 lpg: int = 1):
        args = (wa, ba, wb, bb, cph, prevh, prevm, aux, hup, e1, gumbel,
                emb, lw, lb, hlw, hlb)
        self.check_dtypes(args)
        n_lvl, wid, n, f = prevh.shape
        if lpg < 1 or n_lvl % lpg:
            raise ValueError(f"{self.lib}: lpg {lpg} must divide the level count {n_lvl}")
        if _on_cpu(args):
            return row_plain(*args, with_logits=with_logits, compute_dtype=self.cdtype,
                             lpg=lpg)
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
        ptrs = [_check(key, t, shapes[key], self.dtype(key)) for key, t in zip(shapes, args)]
        outh = torch.empty_like(prevh)
        outm = torch.empty_like(prevm)
        samples = torch.empty(wid, n, dtype=torch.int32, device=prevh.device)
        logits = gumbel.new_empty(wid, n, k) if with_logits else None
        lib = _load(self.lib, "pm_sampler_row", 20, 7)
        stream = torch.cuda.current_stream(prevh.device).cuda_stream
        err = lib.pm_sampler_row(
            *ptrs, outh.data_ptr(), outm.data_ptr(), samples.data_ptr(),
            logits.data_ptr() if with_logits else None,
            n_lvl, wid, n, k, f, int(self.cdtype == torch.bfloat16), lpg, stream,
        )
        self.launches += 1
        _raise_on(lib, err, self.lib)
        return outh, outm, samples, logits


# ---------------------------------------------------------------------------
# The bf16 builds' gate against their plain versions
# ---------------------------------------------------------------------------

# A bf16 build and its plain version sum in other orders, so a rounded value
# can differ by one bf16 ulp, and a flip moves what depends on it: flips
# cascade down the levels and along the row. The plain version against
# itself summed in float64 differs on 15% of the vrow's bf16 outputs and 7%
# of the row's at the flagship's depth, each within 7e-3 of scale (``python
# tests/test_torch_sampler_bf16.py`` prints them), so a share of differing
# values over a whole launch cannot be gated. Before the cascade it can:
# there float64 sums differ on at most 0.1% of the values, the row at a
# wrong cadence (lpg 1 for 4) on 26-27%, while its error (1e-2 of scale)
# stays within the tolerance. The gate (the GPU
# and emulated tests, chip_smoke.py): at most BF16_SHARE of the bf16 values
# differ in the vrow's v0, hup and first two levels and in the row's column
# 0 over its first two groups of lpg levels; every output within BF16_TOL
# of its scale (max |x|, at least 1), for the row kernel over each chain's
# columns up to and including its first differing sample, the logits too;
# that first divergence at a near-tie: the plain version's top two of
# logits + noise closer than 2 * BF16_TOL of the logits' scale, the most
# that two logits each within BF16_TOL can move.
BF16_SHARE = 0.02
BF16_TOL = 2e-2


def _share(got, want) -> float:
    return (got.float() != want.float()).float().mean().item() if want.numel() else 0.0


def _abs_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item() if want.numel() else 0.0


def _err(got, want) -> float:
    """max |got - want| over max(1, max |want|)."""
    return _abs_err(got, want) / max(1.0, want.abs().max().item()) if want.numel() else 0.0


def vrow_bf16_report(got, want) -> dict:
    """The vrow outputs ``(outv, outm, v0, hup)`` against the plain
    version's: the share of differing values before the cascade (v0, hup,
    the first two levels) and over all, and the worst error (relative to
    scale, and absolute)."""
    early = [(g.cpu()[:2], w.cpu()[:2]) for g, w in zip(got[:2], want[:2])]
    early += [(g.cpu(), w.cpu()) for g, w in zip(got[2:], want[2:])]
    return {"share": max(_share(g, w) for g, w in early),
            "share_all": max(_share(g.cpu(), w.cpu()) for g, w in zip(got, want)),
            "err": max(_err(g.cpu(), w.cpu()) for g, w in zip(got, want)),
            "abs_err": max(_abs_err(g.cpu(), w.cpu()) for g, w in zip(got, want))}


def row_bf16_report(got, want, gumbel, lpg: int) -> dict:
    """The row outputs ``(outh, outm, samples, logits)`` against the plain
    version's: the share of differing bf16 values in column 0's first
    ``2 lpg`` levels and over each chain's columns up to and including its
    first differing sample, the worst error there (outh, outm, logits;
    relative to scale, and absolute), the
    chains that diverge and the largest top-two gap of ``want``'s logits +
    ``gumbel`` at a first divergence, over the logits' scale."""
    got = [t.cpu() for t in got]
    want = [t.cpu() for t in want]
    s_got, s_want = got[2].long(), want[2].long()
    wid, n = s_want.shape
    cols = torch.arange(wid)[:, None].expand(wid, n)
    first = torch.where(s_got != s_want, cols, wid).min(0).values
    keep = cols <= first[None]                          # [W, n]
    early = max(_share(g[:2 * lpg, 0], w[:2 * lpg, 0]) for g, w in zip(got[:2], want[:2]))
    logits = want[3]
    scale = max(1.0, logits[keep].abs().max().item())
    gaps = [0.0]
    for j in torch.nonzero(first < wid).flatten().tolist():
        c = int(first[j])
        top = torch.topk(logits[c, j] + gumbel.cpu()[c, j].float(), 2).values
        gaps.append((top[0] - top[1]).item() / scale)
    return {"share": early,
            "share_all": max(_share(g[:, keep], w[:, keep]) for g, w in zip(got[:2], want[:2])),
            "err": max(_err(got[0][:, keep], want[0][:, keep]),
                       _err(got[1][:, keep], want[1][:, keep]),
                       _err(got[3][keep], logits[keep])),
            "abs_err": max(_abs_err(got[0][:, keep], want[0][:, keep]),
                           _abs_err(got[1][:, keep], want[1][:, keep]),
                           _abs_err(got[3][keep], logits[keep])),
            "diverged": int((first < wid).sum()), "chains": n, "tie_gap": max(gaps)}


def bf16_gate_ok(report: dict) -> bool:
    return (report["share"] <= BF16_SHARE and report["err"] <= BF16_TOL
            and report.get("tie_gap", 0.0) < 2 * BF16_TOL)


vrow = _Vrow()
row = _Row()
vrow_bf16 = _Vrow(torch.bfloat16)
row_bf16 = _Row(torch.bfloat16)
# the wrappers by compute dtype
VROW = {torch.float32: vrow, torch.bfloat16: vrow_bf16}
ROW = {torch.float32: row, torch.bfloat16: row_bf16}


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


@torch.no_grad()
def row1_inputs(pixel_cnn: PixelCNN, cond: Optional[torch.Tensor], n: int,
                generator: torch.Generator, compute_dtype="float32", lpg: int = 1):
    """The kernels' arguments at image row 1 of a request of ``n`` chains
    (``cond [n, D]`` or None), row 0 run through the plain versions at
    ``compute_dtype``, so that the previous-row state is what the sampler
    sees there: ``(vrow_in, row_in)``, ``row_in`` with row 1's vertical
    outputs from the plain version and its Gumbel noise drawn from
    ``generator`` (after row 0's), on the model's device."""
    dev = pixel_cnn.embed.device
    cdtype = torch_dtype(compute_dtype)
    f, n_lvl, k_idx = pixel_cnn.num_filters, 2 * pixel_cnn.num_resnet, pixel_cnn.num_indices
    wid = pixel_cnn.image_shape[1]
    w = fuse_sampler_weights(pixel_cnn, cdtype)
    cpv, cph = (t.to(cdtype) for t in cond_projections(pixel_cnn, cond, n))
    z = torch.zeros(wid, n, f, device=dev, dtype=cdtype)
    zl = torch.zeros(n_lvl, wid, n, f, device=dev, dtype=cdtype)
    zm = torch.zeros(n_lvl, wid, n, 2 * f, device=dev, dtype=cdtype)
    g0 = gumbel_noise((wid, n, k_idx), generator, dev)
    g1 = gumbel_noise((wid, n, k_idx), generator, dev)
    wv = (w.viw, w.vib, w.huw, w.hub, w.wav, w.bav, w.wbv, w.bbv, w.waux)
    wr = (w.wa, w.ba, w.wb, w.bb, cph)
    wt = (w.emb, w.lw, w.lb, w.hlw, w.hlb)
    outv0, outm0, v00, hup0 = vrow_plain(z, z, z, zl, zm, cpv, *wv, compute_dtype=cdtype)
    outh0, outmh0, s0, _ = row_plain(*wr, zl, zm, outv0, hup0, z, g0, *wt,
                                     compute_dtype=cdtype, lpg=lpg)
    e1 = w.emb[s0.long()].contiguous()
    vrow_in = (z, e1, v00, outv0, outm0, cpv, *wv)
    outv1, _, _, hup1 = vrow_plain(*vrow_in, compute_dtype=cdtype)
    return vrow_in, (*wr, outh0, outmh0, outv1, hup1, e1, g1, *wt)


@torch.no_grad()
def pixelcnn_sample(
    pixel_cnn: PixelCNN,
    num_samples: int,
    conditional_input: Optional[torch.Tensor] = None,
    *,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    return_logits: bool = False,
    compute_dtype="float32",
    lpg: Optional[int] = None,
):
    """Raster-samples code grids, one ``vrow`` and one ``row`` call per
    image row, at ``compute_dtype`` ("float32" or "bfloat16": the JAX
    ``pixelcnn_sample_rowkernel``'s ``compute_dtype``); in bf16 ``lpg`` is
    the chain's rounding cadence, :func:`levels_per_group`'s choice.

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
    cdtype = torch_dtype(compute_dtype)
    w = fuse_sampler_weights(pixel_cnn, cdtype)
    f = pixel_cnn.num_filters
    hgt, wid = pixel_cnn.image_shape
    n_res = pixel_cnn.num_resnet
    n_lvl = 2 * n_res
    num_idx = w.emb.shape[0]
    lpg = levels_per_group(n_lvl, lpg) if cdtype == torch.bfloat16 else 1
    vrow_fn, row_fn = VROW[cdtype], ROW[cdtype]

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

    cpv, cph = (t.to(cdtype) for t in cond_projections(pixel_cnn, cond, n))
    zeros_row = torch.zeros(wid, n, f, device=device, dtype=cdtype)
    e2, e1 = zeros_row, zeros_row
    pv0 = zeros_row
    pv = torch.zeros(n_lvl, wid, n, f, device=device, dtype=cdtype)
    pm = torch.zeros(n_lvl, wid, n, 2 * f, device=device, dtype=cdtype)
    prevh, prevm = pv, pm
    samples, logits = [], []
    for r in range(hgt):
        outv, outm_v, v0, hup = vrow_fn(
            e2, e1, pv0, pv, pm, cpv, w.viw, w.vib, w.huw, w.hub,
            w.wav, w.bav, w.wbv, w.bbv, w.waux,
        )
        if noise is not None:
            g = noise[r].to(device=device, dtype=torch.float32).contiguous()
        else:
            g = gumbel_noise((wid, n, num_idx), generator, device)
        prevh, prevm, s_row, l_row = row_fn(
            w.wa, w.ba, w.wb, w.bb, cph, prevh, prevm, outv, hup, e1, g,
            w.emb, w.lw, w.lb, w.hlw, w.hlb, with_logits=return_logits, lpg=lpg,
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

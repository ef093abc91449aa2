"""The PixelCNN's gated resnet chain for training: one whole up or down pass.

Counterpart of the stream path of ``posterior_matching_tpu/ops/
gated_chain.py`` (``gated_stream``, :1725). One level is a vertical gated
block, then a horizontal gated block that takes the new vertical as aux:

- ``a1 = conv_a(concat_elu(x)) + sum concat_elu(aux) @ Wx + ba``;
- ``d = concat_elu(a1) * mask / keep``;
- ``b1 = conv_b(d) + bb + cond @ Wc``;
- ``x' = x + sigmoid(b1[F:]) * b1[:F]``.

The sliced masked convs run as shifted taps (:class:`~posterior_matching_
torch.ops.gated_block.TapPlan`). Down levels take skips: the vertical block
``concat_elu(skv) @ wxv``, the horizontal one its ``[4F, F]`` aux Dense
split by rows into ``wxh_u`` (for the new vertical) and ``wxh_s`` (for the
skip).

On the GPU a pass is two hand-written kernels, ``csrc/gated_stream_fwd.cu``
(replacing ``_stream_fwd_kernel_factory``, :1337, ``pallas_call`` :1595) and
``csrc/gated_stream_bwd.cu`` (``_stream_bwd_kernel_factory``, :1407,
``pallas_call`` :1660), joined by :class:`GatedStream`, a
``torch.autograd.Function``. Beside them is :func:`gated_stream_plain`, the
same L levels in plain PyTorch, differentiated by autograd, which the
dispatcher :func:`gated_stream` runs only for tensors on the CPU.

Dropout. The TPU kernels draw their masks from the TPU's PRNG, seeded per
(step seed, ``block_id = 2 (base_pair + level) + sub_block``, image), so the
backward regenerates the forward's masks (``gated_chain.py:262-297``). That
generator exists only on a TPU. Here a counter-based hash of the same fields
and the element index (``position * 2F + channel``) is compared with
``keep * 2^32``; the kernels compute it in-kernel in both directions, and
:func:`dropout_keep_mask` computes it in torch, so kernel and plain realise
the same masks bit for bit. The plain path also takes injected masks, which
is how the tests match the JAX package's ``mask_mode="input"``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from posterior_matching_torch.ops import _build
from posterior_matching_torch.ops.gated_block import TapPlan, _concat_elu, plan_taps

# num_filters the kernels are compiled for (csrc/gated_common.cuh kF).
KERNEL_FILTERS = 128

Weights = Dict[str, torch.Tensor]
Skips = Optional[Tuple[torch.Tensor, torch.Tensor]]


def chain_taps(receptive_field_dims: Tuple[int, int] = (3, 3)) -> Tuple[TapPlan, TapPlan]:
    """The vertical and horizontal blocks' tap plans (``gated_chain.py:
    1766-1768``): 2x3 and 2x2 taps at the flagship's (3, 3)."""
    rows, cols = receptive_field_dims
    return (
        plan_taps((2 * rows - 3, cols), (0, rows - 1), (0, cols)),
        plan_taps((3, cols), (0, 2), (0, cols // 2 + 1)),
    )


def weight_shapes(
    f: int, cond_dim: int, taps_v: TapPlan, taps_h: TapPlan, down: bool
) -> List[Tuple[str, Tuple[int, ...]]]:
    """``(name, shape)`` of one level's packed weights (``gated_chain.py:
    489-509``); the chain stacks each to ``[L, *shape]``. Biases are 1-D
    here (``[1, F]`` in the JAX package)."""
    tv = taps_v.skh * taps_v.skw
    th = taps_h.skh * taps_h.skw
    shapes = [
        ("wav", (tv * 2 * f, f)), ("bav", (f,)),
        ("wbv", (tv * 2 * f, 2 * f)), ("bbv", (2 * f,)),
        ("wcv", (cond_dim, 2 * f)),
    ]
    if down:
        shapes.append(("wxv", (2 * f, f)))
    shapes += [
        ("wah", (th * 2 * f, f)), ("bah", (f,)),
        ("wbh", (th * 2 * f, 2 * f)), ("bbh", (2 * f,)),
        ("wch", (cond_dim, 2 * f)),
        ("wxh_u", (2 * f, f)),
    ]
    if down:
        shapes.append(("wxh_s", (2 * f, f)))
    return shapes


# ---------------------------------------------------------------------------
# Per-level weights from the canonical parameters
# ---------------------------------------------------------------------------


def _block_params(layers, tag: str, constraint, aux: bool) -> Weights:
    """One gated block's canonical parameters, packed for the chain
    (``PixelCNN._chain_block_params``, ``models/pixelcnn.py:252-285``): conv
    kernels sliced to their valid taps and flattened tap-major, the aux bias
    folded into ``ba`` and the cond bias into ``bb``. Slicing keeps the
    masked-out taps out of the graph, so their gradients are exactly 0."""
    (r0, r1), (c0, c1) = constraint
    ca, cb = layers[f"{tag}_conv_a"], layers[f"{tag}_conv_b"]
    cp = layers[f"{tag}_cond_proj"]
    out = {
        "wa": ca.kernel[r0:r1, c0:c1].reshape(-1, ca.kernel.shape[-1]),
        "wb": cb.kernel[r0:r1, c0:c1].reshape(-1, cb.kernel.shape[-1]),
        "wc": cp.kernel,
        "ba": ca.bias,
        "bb": cb.bias + cp.bias,
    }
    if aux:
        ax = layers[f"{tag}_aux"]
        out["ba"] = out["ba"] + ax.bias
        out["waux"] = ax.kernel
    return out


def pack_level(layers, prefix: str, p: int, f: int, down: bool,
               receptive_field_dims: Tuple[int, int] = (3, 3)) -> Weights:
    """Level ``p`` of the ``prefix`` (``"up"`` / ``"dn"``) pass as the
    chain's named weights (``pack_pair``, ``models/pixelcnn.py:358-384``)."""
    rows, cols = receptive_field_dims
    pv = _block_params(layers, f"{prefix}_0_{p}_vertical",
                       ((0, rows - 1), (0, cols)), aux=down)
    ph = _block_params(layers, f"{prefix}_0_{p}_horizontal",
                       ((0, 2), (0, cols // 2 + 1)), aux=True)
    w = {
        "wav": pv["wa"], "bav": pv["ba"], "wbv": pv["wb"], "bbv": pv["bb"],
        "wcv": pv["wc"],
        "wah": ph["wa"], "bah": ph["ba"], "wbh": ph["wb"], "bbh": ph["bb"],
        "wch": ph["wc"],
    }
    if down:
        w["wxv"] = pv["waux"]
        # concat_elu(concat(u, s)) is [elu u, elu s, elu -u, elu -s]: the
        # rows of the [4F, F] aux Dense that meet u, and those that meet s
        wx = ph["waux"]
        w["wxh_u"] = torch.cat([wx[:f], wx[2 * f: 3 * f]])
        w["wxh_s"] = torch.cat([wx[f: 2 * f], wx[3 * f:]])
    else:
        w["wxh_u"] = ph["waux"]
    return w


def stack_levels(levels: Sequence[Weights]) -> Weights:
    """Per-level dicts -> ``[L, ...]`` stacks (differentiable)."""
    return {k: torch.stack([lv[k] for lv in levels]) for k in levels[0]}


# ---------------------------------------------------------------------------
# The dropout hash
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_MIX_A, _MIX_B = 0x7FEB352D, 0x846CA68B


def _mix32_int(x: int) -> int:
    """A 32-bit integer hash (the "lowbias32" mixer), on Python ints."""
    x &= _M32
    x ^= x >> 16
    x = (x * _MIX_A) & _M32
    x ^= x >> 15
    x = (x * _MIX_B) & _M32
    x ^= x >> 16
    return x


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32), split so that no
    product exceeds 2^63: ``c = c_hi 2^16 + c_lo``."""
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (hi + x * (c & 0xFFFF)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """:func:`_mix32_int` on an int64 tensor of uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, _MIX_A)
    x = x ^ (x >> 15)
    x = _mul32(x, _MIX_B)
    return x ^ (x >> 16)


def stream_key(seed: int, block_id: int) -> int:
    """The per-(step seed, block) key the kernels also derive."""
    return _mix32_int(_mix32_int(seed) ^ (block_id & _M32))


def keep_threshold(keep: float) -> int:
    """An element is kept when its 32 hash bits are below this."""
    return min(int(keep * 2.0 ** 32), 2 ** 32 - 1)


def dropout_keep_mask(
    seed: int, block_id: int, batch: int, h: int, w: int, c2: int,
    keep: float, device=None,
) -> torch.Tensor:
    """``[batch, h, w, c2]`` float32 0/1 keep mask of one block:
    ``mix(mix(key ^ image) ^ (position * c2 + channel)) < keep * 2^32``."""
    key = stream_key(seed, block_id)
    img = torch.arange(batch, device=device, dtype=torch.int64)
    kimg = _mix32(img ^ key)                                   # [B]
    elem = torch.arange(h * w * c2, device=device, dtype=torch.int64)
    bits = _mix32(kimg[:, None] ^ elem[None, :])               # [B, HW*C2]
    return (bits < keep_threshold(keep)).to(torch.float32).reshape(batch, h, w, c2)


def step_masks(seed: int, base_pair: int, n_levels: int, shape, keep: float,
               device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hash masks of a pass: ``(mv, mh)``, each ``[L, B, H, W, 2F]``."""
    b, h, w, f = shape
    return tuple(
        torch.stack([
            dropout_keep_mask(seed, 2 * (base_pair + lvl) + sub, b, h, w,
                              2 * f, keep, device)
            for lvl in range(n_levels)
        ])
        for sub in (0, 1)
    )


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


def _conv_taps(x: torch.Tensor, w: torch.Tensor, tp: TapPlan) -> torch.Tensor:
    """Sliced masked conv of ``x [B, H, W, C]`` with the flattened tap-major
    kernel ``w [T * C, N]`` -> ``[B * H * W, N]``."""
    b, h, wd, _ = x.shape
    xp = F.pad(x, (0, 0, tp.pad_left, tp.skw - 1 - tp.pad_left,
                   tp.pad_top, tp.skh - 1 - tp.pad_top))
    cols = [xp[:, i: i + h, j: j + wd, :]
            for i in range(tp.skh) for j in range(tp.skw)]
    return torch.cat(cols, -1).reshape(b * h * wd, -1) @ w


def _block_plain(x, auxes, proj, mask, wa, ba, wb, bb, tp: TapPlan, keep):
    """One gated block (``_block_fwd``, ``gated_chain.py:166-203``)."""
    b, h, wd, f = x.shape
    a1 = _conv_taps(_concat_elu(x), wa, tp)
    for aux, wx in auxes:
        a1 = a1 + _concat_elu(aux).reshape(-1, 2 * f) @ wx
    a1 = a1 + ba
    ce2 = _concat_elu(a1)
    if mask is not None:
        ce2 = ce2 * mask.reshape(-1, 2 * f) * (1.0 / keep)
    b1 = _conv_taps(ce2.reshape(b, h, wd, 2 * f), wb, tp) + bb
    b1 = (b1.reshape(b, h * wd, 2 * f) + proj[:, None, :]).reshape(-1, 2 * f)
    x_new = x.reshape(-1, f) + torch.sigmoid(b1[:, f:]) * b1[:, :f]
    return x_new.reshape(b, h, wd, f)


def gated_stream_plain(
    xv0: torch.Tensor,
    xh0: torch.Tensor,
    skips: Skips,
    cond: torch.Tensor,
    w: Weights,
    *,
    keep: float = 1.0,
    masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    seed: int = 0,
    base_pair: int = 0,
    taps: Optional[Tuple[TapPlan, TapPlan]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """L gated levels in plain PyTorch, differentiable by autograd.

    ``xv0``, ``xh0``: ``[B, H, W, F]``; ``skips``: ``None`` (up) or
    ``(skv, skh)``, each ``[L, B, H, W, F]`` (down level ``l`` reads
    ``skips[.][l]``); ``cond [B, CD]``; ``w``: the stacked weights of
    :func:`weight_shapes`. With ``keep < 1`` the masks are ``masks = (mv,
    mh)``, each ``[L, B, H, W, 2F]`` 0/1, or else the hash masks of
    ``(seed, base_pair)``. Returns the level outputs ``(xvo, xho)``, each
    ``[L, B, H, W, F]``."""
    taps_v, taps_h = taps or chain_taps()
    n_lvl = w["wav"].shape[0]
    down = skips is not None
    if keep < 1.0 and masks is None:
        masks = step_masks(seed, base_pair, n_lvl, xv0.shape, keep, xv0.device)
    xv, xh = xv0, xh0
    outs_v, outs_h = [], []
    for lvl in range(n_lvl):
        mv, mh = (None, None) if keep >= 1.0 else (masks[0][lvl], masks[1][lvl])
        aux_v = [(skips[0][lvl], w["wxv"][lvl])] if down else []
        xv = _block_plain(
            xv, aux_v, cond @ w["wcv"][lvl], mv, w["wav"][lvl], w["bav"][lvl],
            w["wbv"][lvl], w["bbv"][lvl], taps_v, keep,
        )
        aux_h = [(xv, w["wxh_u"][lvl])]
        if down:
            aux_h.append((skips[1][lvl], w["wxh_s"][lvl]))
        xh = _block_plain(
            xh, aux_h, cond @ w["wch"][lvl], mh, w["wah"][lvl], w["bah"][lvl],
            w["wbh"][lvl], w["bbh"][lvl], taps_h, keep,
        )
        outs_v.append(xv)
        outs_h.append(xh)
    return torch.stack(outs_v), torch.stack(outs_h)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

# Argument order of the C entry points (csrc/gated_stream_{fwd,bwd}.cu).
_GEOMETRY = ("L", "B", "H", "W", "CD", "tv_skh", "tv_skw", "tv_pt", "tv_pl",
             "th_skh", "th_skw", "th_pt", "th_pl", "seed", "base_pair",
             "thresh", "use_drop")
_W_FWD = ("wav", "bav", "wbv", "bbv", "wcv", "wxv",
          "wah", "bah", "wbh", "bbh", "wch", "wxh_u", "wxh_s")
_FWD_PTRS = ("xv0", "xh0", "skv", "skh", "cond", *_W_FWD,
             "xvo", "xho", "a1v", "a1h", "b1v", "b1h", "proj")
_W_BWD = ("wav", "wbv", "wcv", "wxv", "wah", "wbh", "wch", "wxh_u", "wxh_s")
_BWD_PTRS = (
    "gv", "gh", "xv0", "xh0", "xvo", "xho", "skv", "skh", "cond",
    "a1v", "a1h", "b1v", "b1h", *_W_BWD,
    "dxv0", "dxh0", "dskv", "dskh", "dcond",
    *("d" + n for n in _W_FWD),
    "db1v", "db1h", "da1v", "da1h", "gtot", "gvtot", "rsv", "rsh", "rav", "rah",
)


class StreamConfig:
    """Static geometry of one pass, shared by the forward and backward
    launches."""

    def __init__(self, xv0: torch.Tensor, cond: torch.Tensor, n_levels: int,
                 down: bool, keep: float, seed: int, base_pair: int,
                 taps: Tuple[TapPlan, TapPlan]):
        self.b, self.h, self.w, self.f = xv0.shape
        self.cd = cond.shape[-1]
        self.n_levels, self.down, self.keep = n_levels, down, float(keep)
        self.seed, self.base_pair = int(seed), int(base_pair)
        self.taps_v, self.taps_h = taps
        if self.f != KERNEL_FILTERS:
            raise ValueError(
                f"gated_stream kernels need num_filters == {KERNEL_FILTERS}, "
                f"got {self.f}"
            )
        for tp in taps:
            if tp.skh > 3 or tp.skw > 3:
                raise ValueError(f"gated_stream kernels take at most 3x3 taps, got {tp}")

    @property
    def rows(self) -> int:
        return self.b * self.h * self.w

    def ints(self) -> List[int]:
        thresh = keep_threshold(self.keep)
        vals = {
            "L": self.n_levels, "B": self.b, "H": self.h, "W": self.w,
            "CD": self.cd,
            "tv_skh": self.taps_v.skh, "tv_skw": self.taps_v.skw,
            "tv_pt": self.taps_v.pad_top, "tv_pl": self.taps_v.pad_left,
            "th_skh": self.taps_h.skh, "th_skw": self.taps_h.skw,
            "th_pt": self.taps_h.pad_top, "th_pl": self.taps_h.pad_left,
            # 32-bit patterns passed as C ints
            "seed": ctypes.c_int32(self.seed & 0xFFFFFFFF).value,
            "base_pair": self.base_pair,
            "thresh": ctypes.c_int32(thresh).value,
            "use_drop": int(self.keep < 1.0),
        }
        return [vals[k] for k in _GEOMETRY]

    def weight_shapes(self, bias: bool = True) -> Dict[str, Tuple[int, ...]]:
        shp = dict(weight_shapes(self.f, self.cd, self.taps_v, self.taps_h,
                                 self.down))
        out = {k: (self.n_levels, *v) for k, v in shp.items()}
        if not bias:
            out = {k: v for k, v in out.items() if not k.startswith("b")}
        return out


def _launch(lib_name: str, fn: str, names: Sequence[str],
            tensors: Dict[str, Optional[torch.Tensor]], cfg: StreamConfig,
            device: torch.device):
    ptrs = (ctypes.c_void_p * len(names))(
        *[tensors[n].data_ptr() if tensors.get(n) is not None else None
          for n in names]
    )
    ints = (ctypes.c_int * len(_GEOMETRY))(*cfg.ints())
    lib = _build.load_fn(
        lib_name, fn,
        [_build.P, _build.I, _build.P, _build.I, _build.F32, _build.P],
    )
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, fn)(ptrs, len(names), ints, len(_GEOMETRY),
                           1.0 / cfg.keep, stream)
    return lib, err


def _check_all(tensors: Dict[str, Optional[torch.Tensor]],
               shapes: Dict[str, Tuple[int, ...]]):
    for name, shape in shapes.items():
        t = tensors.get(name)
        if t is None:
            raise ValueError(f"{name}: missing")
        if t.device.type != "cuda":
            raise ValueError(f"{name}: the kernels take CUDA tensors, got {t.device}")
        if _build.check(name, t, shape) % 16:
            raise ValueError(f"{name}: the kernels need 16-byte aligned tensors")


class _StreamFwd:
    """Wrapper of ``csrc/gated_stream_fwd.cu``: one call runs a whole pass
    (a few kernels per level on one stream) and counts as one launch."""

    def __init__(self):
        self.launches = 0

    def __call__(self, cfg: StreamConfig, xv0, xh0, skips: Skips, cond,
                 w: Weights) -> Dict[str, torch.Tensor]:
        L, R, f = cfg.n_levels, cfg.rows, cfg.f
        t = {"xv0": xv0, "xh0": xh0, "cond": cond, **w}
        shapes = {"xv0": (cfg.b, cfg.h, cfg.w, f), "xh0": (cfg.b, cfg.h, cfg.w, f),
                  "cond": (cfg.b, cfg.cd), **cfg.weight_shapes()}
        if cfg.down:
            t["skv"], t["skh"] = skips
            shapes["skv"] = shapes["skh"] = (L, cfg.b, cfg.h, cfg.w, f)
        _check_all(t, shapes)
        empty = lambda *s: torch.empty(s, device=xv0.device)
        out = {"xvo": empty(L, R, f), "xho": empty(L, R, f),
               "a1v": empty(L, R, f), "a1h": empty(L, R, f),
               "b1v": empty(L, R, 2 * f), "b1h": empty(L, R, 2 * f)}
        t.update(out, proj=empty(L, 2, cfg.b, 2 * f))
        lib, err = _launch("gated_stream_fwd", "pm_gated_stream_fwd",
                           _FWD_PTRS, t, cfg, xv0.device)
        self.launches += 1
        _build.raise_on(lib, err, "gated_stream_fwd")
        return out


class _StreamBwd:
    """Wrapper of ``csrc/gated_stream_bwd.cu``: one call is a whole pass's
    VJP and counts as one launch."""

    def __init__(self):
        self.launches = 0

    def __call__(self, cfg: StreamConfig, gv, gh, saved: Dict[str, torch.Tensor],
                 w: Weights) -> Dict[str, torch.Tensor]:
        L, R, f, b = cfg.n_levels, cfg.rows, cfg.f, cfg.b
        t = {"gv": gv, "gh": gh, **saved, **w}
        shapes = {
            "gv": (L, R, f), "gh": (L, R, f),
            "xv0": (cfg.b, cfg.h, cfg.w, f), "xh0": (cfg.b, cfg.h, cfg.w, f),
            "xvo": (L, R, f), "xho": (L, R, f), "cond": (b, cfg.cd),
            "a1v": (L, R, f), "a1h": (L, R, f),
            "b1v": (L, R, 2 * f), "b1h": (L, R, 2 * f),
            **cfg.weight_shapes(bias=False),
        }
        if cfg.down:
            shapes["skv"] = shapes["skh"] = (L, cfg.b, cfg.h, cfg.w, f)
        _check_all(t, shapes)
        dev = gv.device
        empty = lambda *s: torch.empty(s, device=dev)
        grads = {"dxv0": empty(cfg.b, cfg.h, cfg.w, f),
                 "dxh0": empty(cfg.b, cfg.h, cfg.w, f),
                 "dcond": empty(b, cfg.cd)}
        if cfg.down:
            grads["dskv"] = empty(L, cfg.b, cfg.h, cfg.w, f)
            grads["dskh"] = empty(L, cfg.b, cfg.h, cfg.w, f)
        for name, shape in cfg.weight_shapes().items():
            grads["d" + name] = empty(*shape)
        scratch = {
            "db1v": empty(L, R, 2 * f), "db1h": empty(L, R, 2 * f),
            "da1v": empty(L, R, f), "da1h": empty(L, R, f),
            "gtot": empty(R, f), "gvtot": empty(R, f),
            "rsv": empty(L, b, 2 * f), "rsh": empty(L, b, 2 * f),
            "rav": empty(L, b, f), "rah": empty(L, b, f),
        }
        t.update(grads, **scratch)
        lib, err = _launch("gated_stream_bwd", "pm_gated_stream_bwd",
                           _BWD_PTRS, t, cfg, dev)
        self.launches += 1
        _build.raise_on(lib, err, "gated_stream_bwd")
        return grads


stream_fwd = _StreamFwd()
stream_bwd = _StreamBwd()


class GatedStream(torch.autograd.Function):
    """A pass whose forward and backward are the hand-written kernels.
    Saved for the backward: the chain inputs, every level's outputs and
    both blocks' conv outputs ``a1``, ``b1``; everything else (concat_elu,
    the dropout masks, the gates) is recomputed. Level ``l``'s inputs are
    level ``l - 1``'s outputs, so they are not saved twice."""

    @staticmethod
    def forward(ctx, cfg: StreamConfig, xv0, xh0, skv, skh, cond, *ws):
        names = list(cfg.weight_shapes())
        w = dict(zip(names, ws))
        skips = (skv, skh) if cfg.down else None
        out = stream_fwd(cfg, xv0, xh0, skips, cond, w)
        ctx.cfg = cfg
        ctx.names = names
        ctx.save_for_backward(
            xv0, xh0, skv, skh, cond, out["xvo"], out["xho"], out["a1v"],
            out["a1h"], out["b1v"], out["b1h"], *ws,
        )
        shape = (cfg.n_levels, cfg.b, cfg.h, cfg.w, cfg.f)
        return out["xvo"].view(shape), out["xho"].view(shape)

    @staticmethod
    def backward(ctx, gxvo, gxho):
        cfg = ctx.cfg
        (xv0, xh0, skv, skh, cond, xvo, xho, a1v, a1h, b1v, b1h,
         *ws) = ctx.saved_tensors
        w = dict(zip(ctx.names, ws))
        L, R, f = cfg.n_levels, cfg.rows, cfg.f
        zeros = lambda: torch.zeros(L, R, f, device=xv0.device)
        gv = zeros() if gxvo is None else gxvo.reshape(L, R, f).contiguous()
        gh = zeros() if gxho is None else gxho.reshape(L, R, f).contiguous()
        saved = {"xv0": xv0, "xh0": xh0, "skv": skv, "skh": skh, "cond": cond,
                 "xvo": xvo, "xho": xho, "a1v": a1v, "a1h": a1h, "b1v": b1v,
                 "b1h": b1h}
        g = stream_bwd(cfg, gv, gh, saved,
                       {k: v for k, v in w.items() if not k.startswith("b")})
        dws = [g["d" + n] for n in ctx.names]
        return (None, g["dxv0"], g["dxh0"], g.get("dskv"), g.get("dskh"),
                g["dcond"], *dws)


def gated_stream(
    xv0: torch.Tensor,
    xh0: torch.Tensor,
    skips: Skips,
    cond: torch.Tensor,
    w: Weights,
    *,
    seed: int,
    base_pair: int,
    keep: float,
    masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    taps: Optional[Tuple[TapPlan, TapPlan]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pass of L gated levels (the arguments of
    :func:`gated_stream_plain`): the plain version for CPU tensors, the
    kernels (:class:`GatedStream`) for CUDA tensors. The kernels realise
    dropout only through the hash, so they take no injected ``masks``."""
    taps = taps or chain_taps()
    tensors = [xv0, xh0, cond, *w.values()] + (list(skips) if skips else [])
    if _build.on_cpu(tensors):
        return gated_stream_plain(
            xv0, xh0, skips, cond, w, keep=keep, masks=masks, seed=seed,
            base_pair=base_pair, taps=taps,
        )
    if masks is not None:
        raise ValueError("the gated_stream kernels draw their own dropout "
                         "masks; injected masks run on the CPU only")
    cfg = StreamConfig(xv0, cond, w["wav"].shape[0], skips is not None,
                       keep, seed, base_pair, taps)
    names = list(cfg.weight_shapes())
    skv, skh = skips if skips is not None else (None, None)
    contig = lambda t: None if t is None else t.contiguous()
    return GatedStream.apply(
        cfg, contig(xv0), contig(xh0), contig(skv), contig(skh),
        contig(cond), *[contig(w[n]) for n in names],
    )

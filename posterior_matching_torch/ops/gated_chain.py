"""The PixelCNN's gated resnet chain for training, at three granularities.

Counterpart of ``posterior_matching_tpu/ops/gated_chain.py``'s training
paths: ``gated_stream`` (:1725, one whole up or down pass), ``gated_pair``
(:723, one level) and ``gated_segment`` (:1215, L consecutive levels). One
level is a vertical gated block, then a horizontal gated block that takes
the new vertical as aux:

- ``a1 = conv_a(concat_elu(x)) + sum concat_elu(aux) @ Wx + ba``;
- ``d = concat_elu(a1) * mask / keep``;
- ``b1 = conv_b(d) + bb + cond @ Wc``;
- ``x' = x + sigmoid(b1[F:]) * b1[:F]``.

The sliced masked convs run as shifted taps (:class:`~posterior_matching_
torch.ops.gated_block.TapPlan`). Down levels take skips: the vertical block
``concat_elu(skv) @ wxv``, the horizontal one its ``[4F, F]`` aux Dense
split by rows into ``wxh_u`` (for the new vertical) and ``wxh_s`` (for the
skip).

On the GPU each granularity is two hand-written kernels, a forward and a
backward joined by a ``torch.autograd.Function``:

- the stream, ``csrc/gated_stream_fwd.cu`` (replacing
  ``_stream_fwd_kernel_factory``, :1337, ``pallas_call`` :1595) and
  ``csrc/gated_stream_bwd.cu`` (``_stream_bwd_kernel_factory``, :1407,
  :1660), through :class:`GatedStream`, with ``[L, ...]`` stacked weights;
- the pair (``_fwd_kernel_factory`` :305 -> :586, ``_bwd_kernel_factory``
  :368 -> :649) and the segment (``_seg_fwd_kernel_factory`` :801 -> :1046,
  ``_seg_bwd_kernel_factory`` :861 -> :1125), each an entry point of
  ``csrc/gated_levels_fwd.cu`` and ``csrc/gated_levels_bwd.cu``
  (``pm_gated_pair_*``, ``pm_gated_segment_*``), both through
  :class:`GatedLevels`, with each level's weights and skips as their own
  tensors and each level's outputs returned.

All six run the launch sequence of ``csrc/gated_levels.cuh``, each launch
over all ``B*H*W`` rows: the JAX batch chunks ``bc_fwd`` / ``bc_bwd``
(``PM_TPU_CHAIN_BC_*``) tile the TPU's VMEM and have no counterpart here.
Beside them are the plain versions, :func:`gated_stream_plain`,
:func:`gated_pair_plain` and :func:`gated_segment_plain`, the same levels in
plain PyTorch differentiated by autograd, which the dispatchers
(:func:`gated_stream`, :func:`gated_pair`, :func:`gated_segment`) run only
for tensors on the CPU.

Dropout. The TPU kernels draw their masks from the TPU's PRNG, seeded per
(step seed, ``block_id = 2 (base_pair + level) + sub_block``, image), so the
backward regenerates the forward's masks (``gated_chain.py:262-297``). That
generator exists only on a TPU. Here a counter-based hash of the same fields
and the element index (``position * 2F + channel``) is compared with
``keep * 2^32``; the kernels compute it in-kernel in both directions, and
:func:`dropout_keep_mask` computes it in torch, so kernel and plain realise
the same masks bit for bit, and a level gets the same masks whichever
granularity runs it. The plain path also takes injected masks, which is how
the tests match the JAX package's ``mask_mode="input"``.
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


def _level_plain(xv, xh, sk, cond, w: Weights, mv, mh, taps: Tuple[TapPlan, TapPlan],
                 keep: float):
    """One level: the vertical block, then the horizontal one with the new
    vertical (and the skips ``sk = (skv, skh)`` of a down level) as aux."""
    taps_v, taps_h = taps
    aux_v = [(sk[0], w["wxv"])] if sk is not None else []
    xv = _block_plain(xv, aux_v, cond @ w["wcv"], mv, w["wav"], w["bav"], w["wbv"],
                      w["bbv"], taps_v, keep)
    aux_h = [(xv, w["wxh_u"])] + ([(sk[1], w["wxh_s"])] if sk is not None else [])
    xh = _block_plain(xh, aux_h, cond @ w["wch"], mh, w["wah"], w["bah"], w["wbh"],
                      w["bbh"], taps_h, keep)
    return xv, xh


def gated_segment_plain(
    xv: torch.Tensor,
    xh: torch.Tensor,
    skips: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]],
    cond: torch.Tensor,
    ws: Sequence[Weights],
    *,
    keep: float = 1.0,
    masks: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
    seed: int = 0,
    base_pair: int = 0,
    taps: Optional[Tuple[TapPlan, TapPlan]] = None,
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``L = len(ws)`` gated levels in plain PyTorch, differentiable by
    autograd (``gated_segment``, ``gated_chain.py:1215``).

    ``xv``, ``xh``: ``[B, H, W, F]``; ``skips``: ``None`` (up) or level
    ``l``'s ``(skv, skh)``, each ``[B, H, W, F]``; ``cond [B, CD]``; ``ws``:
    each level's weights of :func:`weight_shapes`. With ``keep < 1`` the
    masks are ``masks[l] = (mv, mh)``, each ``[B, H, W, 2F]`` 0/1, or else
    the hash masks of blocks ``2 (base_pair + l) + sub``. Returns each
    level's ``(xv, xh)``."""
    taps = taps or chain_taps()
    b, h, w, f = xv.shape
    outs = []
    for lvl, wl in enumerate(ws):
        if keep >= 1.0:
            mv = mh = None
        elif masks is not None:
            mv, mh = masks[lvl]
        else:
            mv, mh = (dropout_keep_mask(seed, 2 * (base_pair + lvl) + sub, b, h, w, 2 * f,
                                        keep, xv.device) for sub in (0, 1))
        xv, xh = _level_plain(xv, xh, None if skips is None else skips[lvl], cond, wl,
                              mv, mh, taps, keep)
        outs.append((xv, xh))
    return outs


def gated_pair_plain(
    xv: torch.Tensor,
    xh: torch.Tensor,
    skips: Skips,
    cond: torch.Tensor,
    w: Weights,
    *,
    keep: float = 1.0,
    masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    seed: int = 0,
    pair_index: int = 0,
    taps: Optional[Tuple[TapPlan, TapPlan]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One level (``gated_pair``, ``gated_chain.py:723``): the arguments of
    :func:`gated_segment_plain` for one level, ``skips`` the level's
    ``(skv, skh)`` or ``None``, ``masks`` its ``(mv, mh)``. Returns
    ``(xv', xh')``."""
    return gated_segment_plain(
        xv, xh, None if skips is None else [skips], cond, [w], keep=keep,
        masks=None if masks is None else [masks], seed=seed, base_pair=pair_index,
        taps=taps,
    )[0]


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
    """A pass of L levels with stacked weights (``gated_stream``,
    ``gated_chain.py:1725``): ``skips`` ``None`` or ``(skv, skh)``, each
    ``[L, B, H, W, F]`` (down level ``l`` reads ``skips[.][l]``); ``w`` the
    ``[L, ...]`` stacks of :func:`weight_shapes`; ``masks`` ``(mv, mh)``,
    each ``[L, B, H, W, 2F]``. Returns the level outputs ``(xvo, xho)``,
    each ``[L, B, H, W, F]``."""
    n_lvl = w["wav"].shape[0]
    per_level = lambda pair: [(pair[0][l], pair[1][l]) for l in range(n_lvl)]
    outs = gated_segment_plain(
        xv0, xh0, None if skips is None else per_level(skips), cond,
        [{k: v[l] for k, v in w.items()} for l in range(n_lvl)], keep=keep,
        masks=None if masks is None else per_level(masks), seed=seed,
        base_pair=base_pair, taps=taps,
    )
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

# Argument order of the C entry points: the geometry ints of all six, the
# stream's pointers (csrc/gated_stream_{fwd,bwd}.cu) ...
_GEOMETRY = ("L", "B", "H", "W", "CD", "tv_skh", "tv_skw", "tv_pt", "tv_pl",
             "th_skh", "th_skw", "th_pt", "th_pl", "seed", "base_pair",
             "thresh", "use_drop")
_W_FWD = ("wav", "bav", "wbv", "bbv", "wcv", "wxv",
          "wah", "bah", "wbh", "bbh", "wch", "wxh_u", "wxh_s")
_FWD_PTRS = ("xv0", "xh0", "skv", "skh", "cond", *_W_FWD,
             "xvo", "xho", "a1v", "a1h", "b1v", "b1h", "proj")
_W_BWD = ("wav", "wbv", "wcv", "wxv", "wah", "wbh", "wch", "wxh_u", "wxh_s")
_SCRATCH = ("db1v", "db1h", "da1v", "da1h", "gtot", "gvtot", "rsv", "rsh", "rav", "rah")
_BWD_PTRS = (
    "gv", "gh", "xv0", "xh0", "xvo", "xho", "skv", "skh", "cond",
    "a1v", "a1h", "b1v", "b1h", *_W_BWD,
    "dxv0", "dxh0", "dskv", "dskh", "dcond",
    *("d" + n for n in _W_FWD), *_SCRATCH,
)
# ... and the pair's and segment's (csrc/gated_levels_{fwd,bwd}.cu,
# csrc/gated_levels.cuh): a head, then one list per level
_SAVES = ("xvo", "xho", "a1v", "a1h", "b1v", "b1h")
_SEG_FWD = ("xv0", "xh0", "cond", "proj")
_LEVEL_FWD = ("skv", "skh", *_W_FWD, *_SAVES)
_SEG_BWD = ("xv0", "xh0", "cond", "dxv0", "dxh0", "dcond", *_SCRATCH)
_LEVEL_BWD = ("gv", "gh", *_SAVES[:2], "skv", "skh", *_SAVES[2:], *_W_BWD,
              "dskv", "dskh", *("d" + n for n in _W_FWD))
# The most levels one launch takes (csrc/gated_levels.cuh kMaxLevels).
MAX_LEVELS = 32


class StreamConfig:
    """Static geometry of the levels of one launch (a pass, a pair or a
    segment), shared by the forward and backward launches."""

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
                f"the gated chain kernels need num_filters == {KERNEL_FILTERS}, "
                f"got {self.f}"
            )
        if not 1 <= n_levels <= MAX_LEVELS:
            raise ValueError(f"the gated chain kernels take 1 to {MAX_LEVELS} levels "
                             f"a launch, got {n_levels}")
        for tp in taps:
            if tp.skh > 3 or tp.skw > 3:
                raise ValueError(f"the gated chain kernels take at most 3x3 taps, got {tp}")

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

    def level_shapes(self, bias: bool = True) -> Dict[str, Tuple[int, ...]]:
        """One level's weight shapes (without the biases with ``bias``
        false)."""
        shp = dict(weight_shapes(self.f, self.cd, self.taps_v, self.taps_h, self.down))
        return {k: v for k, v in shp.items() if bias or not k.startswith("b")}

    def weight_shapes(self, bias: bool = True) -> Dict[str, Tuple[int, ...]]:
        """The stream's ``[L, ...]`` stacks."""
        return {k: (self.n_levels, *v) for k, v in self.level_shapes(bias).items()}


def _ptrs(names: Sequence[str], tensors: Dict[str, Optional[torch.Tensor]]) -> List:
    """Device pointers of ``names`` (null for a missing or ``None`` one)."""
    return [tensors[n].data_ptr() if tensors.get(n) is not None else None for n in names]


def _launch(lib_name: str, ptrs: Sequence, cfg: StreamConfig, device: torch.device,
            entry: Optional[str] = None):
    """Calls entry point ``pm_<entry>`` (by default ``pm_<lib_name>``) of
    kernel library ``lib_name``."""
    fn = f"pm_{entry or lib_name}"
    arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    ints = (ctypes.c_int * len(_GEOMETRY))(*cfg.ints())
    lib = _build.load_fn(
        lib_name, fn,
        [_build.P, _build.I, _build.P, _build.I, _build.F32, _build.P],
    )
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, fn)(arr, len(ptrs), ints, len(_GEOMETRY), 1.0 / cfg.keep, stream)
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
        lib, err = _launch("gated_stream_fwd", _ptrs(_FWD_PTRS, t), cfg, xv0.device)
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
        lib, err = _launch("gated_stream_bwd", _ptrs(_BWD_PTRS, t), cfg, dev)
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


# ---------------------------------------------------------------------------
# The pair and the segment
# ---------------------------------------------------------------------------

LevelSkips = Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]]


class _LevelsFwd:
    """Wrapper of entry point ``pm_<entry>`` of ``csrc/gated_levels_fwd.cu``:
    ``gated_pair_fwd`` (one level) or ``gated_segment_fwd`` (any number).
    One call runs the config's levels and counts as one launch. Returns each
    level's outputs and saves (:data:`_SAVES`), every one its own
    ``[B, H, W, C]`` tensor."""

    lib = "gated_levels_fwd"

    def __init__(self, entry: str):
        self.entry = entry
        self.launches = 0

    def __call__(self, cfg: StreamConfig, xv0, xh0, skips: LevelSkips, cond,
                 ws: Sequence[Weights]) -> List[Dict[str, torch.Tensor]]:
        act = (cfg.b, cfg.h, cfg.w, cfg.f)
        head = {"xv0": xv0, "xh0": xh0, "cond": cond}
        _check_all(head, {"xv0": act, "xh0": act, "cond": (cfg.b, cfg.cd)})
        empty = lambda *s: torch.empty(s, device=xv0.device)
        head["proj"] = empty(cfg.n_levels, 2, cfg.b, 2 * cfg.f)
        shapes = cfg.level_shapes()
        if cfg.down:
            shapes.update(skv=act, skh=act)
        ptrs, outs = _ptrs(_SEG_FWD, head), []
        for lvl in range(cfg.n_levels):
            t = dict(ws[lvl])
            if cfg.down:
                t["skv"], t["skh"] = skips[lvl]
            _check_all(t, shapes)
            out = {n: empty(*act[:3], (2 if n.startswith("b1") else 1) * cfg.f)
                   for n in _SAVES}
            ptrs += _ptrs(_LEVEL_FWD, {**t, **out})
            outs.append(out)
        lib, err = _launch(self.lib, ptrs, cfg, xv0.device, self.entry)
        self.launches += 1
        _build.raise_on(lib, err, self.entry)
        return outs


class _LevelsBwd:
    """Wrapper of entry point ``pm_<entry>`` of ``csrc/gated_levels_bwd.cu``
    (``gated_pair_bwd`` or ``gated_segment_bwd``): one call is the VJP of the
    config's levels and counts as one launch. ``gs[l]`` are level ``l``'s
    output cotangents (``None``: zero). Returns the cotangents of ``xv0``,
    ``xh0`` and ``cond``, and each level's skip and weight gradients."""

    lib = "gated_levels_bwd"

    def __init__(self, entry: str):
        self.entry = entry
        self.launches = 0

    def __call__(self, cfg: StreamConfig, gs, xv0, xh0, cond, skips: LevelSkips,
                 saves: Sequence[Dict[str, torch.Tensor]], ws: Sequence[Weights]):
        n_lvl, r, f = cfg.n_levels, cfg.rows, cfg.f
        act = (cfg.b, cfg.h, cfg.w, f)
        empty = lambda *s: torch.empty(s, device=xv0.device)
        head = {"xv0": xv0, "xh0": xh0, "cond": cond,
                "dxv0": empty(*act), "dxh0": empty(*act), "dcond": empty(cfg.b, cfg.cd),
                "db1v": empty(n_lvl, r, 2 * f), "db1h": empty(n_lvl, r, 2 * f),
                "da1v": empty(n_lvl, r, f), "da1h": empty(n_lvl, r, f),
                "gtot": empty(r, f), "gvtot": empty(r, f),
                "rsv": empty(n_lvl, cfg.b, 2 * f), "rsh": empty(n_lvl, cfg.b, 2 * f),
                "rav": empty(n_lvl, cfg.b, f), "rah": empty(n_lvl, cfg.b, f)}
        shapes = cfg.level_shapes(bias=False)
        if cfg.down:
            shapes.update(skv=act, skh=act)
        ptrs, grads = _ptrs(_SEG_BWD, head), []
        for lvl in range(n_lvl):
            t = {k: v for k, v in ws[lvl].items() if not k.startswith("b")}
            if cfg.down:
                t["skv"], t["skh"] = skips[lvl]
            _check_all(t, shapes)
            cot = dict(zip(("gv", "gh"), gs[lvl]))
            _check_all({k: v for k, v in cot.items() if v is not None},
                       {k: act for k, v in cot.items() if v is not None})
            g = {"d" + n: empty(*s) for n, s in cfg.level_shapes().items()}
            if cfg.down:
                g["dskv"], g["dskh"] = empty(*act), empty(*act)
            ptrs += _ptrs(_LEVEL_BWD, {**t, **cot, **saves[lvl], **g})
            grads.append(g)
        lib, err = _launch(self.lib, ptrs, cfg, xv0.device, self.entry)
        self.launches += 1
        _build.raise_on(lib, err, self.entry)
        return {k: head[k] for k in ("dxv0", "dxh0", "dcond")}, grads


pair_fwd = _LevelsFwd("gated_pair_fwd")
pair_bwd = _LevelsBwd("gated_pair_bwd")
seg_fwd = _LevelsFwd("gated_segment_fwd")
seg_bwd = _LevelsBwd("gated_segment_bwd")


class GatedLevels(torch.autograd.Function):
    """Consecutive levels whose forward and backward are the pair kernels
    (``kernels = (pair_fwd, pair_bwd)``, one level) or the segment kernels
    (``(seg_fwd, seg_bwd)``). Inputs: ``xv0``, ``xh0``, ``cond``, then level
    by level the skips (down) and the weights (:func:`weight_shapes`'
    order). Outputs: each level's ``(xv, xh)``, separate tensors, so that up
    outputs can be down skips. Saved for the backward: the inputs and each
    level's outputs and ``a1``, ``b1``; a level's inputs are the previous
    level's outputs. An output that later code does not use gets a ``None``
    cotangent, which the kernels read as zero."""

    @staticmethod
    def forward(ctx, kernels, cfg: StreamConfig, xv0, xh0, cond, *rest):
        n_lvl = cfg.n_levels
        names = list(cfg.level_shapes())
        n_sk = 2 * n_lvl if cfg.down else 0
        skips = [rest[2 * l: 2 * l + 2] for l in range(n_lvl)] if cfg.down else None
        ws = [dict(zip(names, rest[n_sk + l * len(names): n_sk + (l + 1) * len(names)]))
              for l in range(n_lvl)]
        saves = kernels[0](cfg, xv0, xh0, skips, cond, ws)
        ctx.kernels, ctx.cfg, ctx.names = kernels, cfg, names
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(xv0, xh0, cond, *rest, *(s[k] for s in saves for k in _SAVES))
        return tuple(s[k] for s in saves for k in ("xvo", "xho"))

    @staticmethod
    def backward(ctx, *gouts):
        cfg, names = ctx.cfg, ctx.names
        n_lvl, n_s = cfg.n_levels, len(_SAVES)
        xv0, xh0, cond, *rest = ctx.saved_tensors
        rest, flat_saves = rest[:-n_s * n_lvl], rest[-n_s * n_lvl:]
        n_sk = 2 * n_lvl if cfg.down else 0
        skips = [rest[2 * l: 2 * l + 2] for l in range(n_lvl)] if cfg.down else None
        ws = [dict(zip(names, rest[n_sk + l * len(names): n_sk + (l + 1) * len(names)]))
              for l in range(n_lvl)]
        saves = [dict(zip(_SAVES, flat_saves[n_s * l: n_s * (l + 1)])) for l in range(n_lvl)]
        contig = lambda t: None if t is None else t.contiguous()
        gs = [(contig(gouts[2 * l]), contig(gouts[2 * l + 1])) for l in range(n_lvl)]
        g, per_level = ctx.kernels[1](cfg, gs, xv0, xh0, cond, skips, saves, ws)
        dsk = [g_["d" + k] for g_ in per_level for k in ("skv", "skh")] if cfg.down else []
        dws = [g_["d" + n] for g_ in per_level for n in names]
        return (None, None, g["dxv0"], g["dxh0"], g["dcond"], *dsk, *dws)


def _levels(kernels, xv, xh, skips: LevelSkips, cond, ws: Sequence[Weights], *, seed: int,
            base_pair: int, keep: float, masks, taps):
    """The plain version for CPU tensors, :class:`GatedLevels` through
    ``kernels`` for CUDA tensors (which take no injected masks)."""
    taps = taps or chain_taps()
    tensors = [xv, xh, cond, *(t for w in ws for t in w.values()),
               *(t for sk in (skips or ()) for t in sk)]
    if _build.on_cpu(tensors):
        return gated_segment_plain(xv, xh, skips, cond, ws, keep=keep, masks=masks,
                                   seed=seed, base_pair=base_pair, taps=taps)
    if masks is not None:
        raise ValueError("the gated chain kernels draw their own dropout masks; "
                         "injected masks run on the CPU only")
    cfg = StreamConfig(xv, cond, len(ws), skips is not None, keep, seed, base_pair, taps)
    names = list(cfg.level_shapes())
    flat = [t.contiguous() for sk in (skips or ()) for t in sk]
    flat += [w[n].contiguous() for w in ws for n in names]
    out = GatedLevels.apply(kernels, cfg, xv.contiguous(), xh.contiguous(),
                            cond.contiguous(), *flat)
    return [(out[2 * l], out[2 * l + 1]) for l in range(len(ws))]


def gated_pair(
    xv: torch.Tensor,
    xh: torch.Tensor,
    skips: Skips,
    cond: torch.Tensor,
    w: Weights,
    *,
    seed: int,
    pair_index: int,
    keep: float,
    masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    taps: Optional[Tuple[TapPlan, TapPlan]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One level (the arguments of :func:`gated_pair_plain`): the plain
    version for CPU tensors, the pair kernels for CUDA tensors."""
    return _levels(
        (pair_fwd, pair_bwd), xv, xh, None if skips is None else [skips], cond, [w],
        seed=seed, base_pair=pair_index, keep=keep,
        masks=None if masks is None else [masks], taps=taps,
    )[0]


def gated_segment(
    xv: torch.Tensor,
    xh: torch.Tensor,
    skips: LevelSkips,
    cond: torch.Tensor,
    ws: Sequence[Weights],
    *,
    seed: int,
    base_pair: int,
    keep: float,
    masks: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
    taps: Optional[Tuple[TapPlan, TapPlan]] = None,
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``len(ws)`` levels (the arguments of :func:`gated_segment_plain`): the
    plain version for CPU tensors, the segment kernels for CUDA tensors.
    Returns each level's ``(xv, xh)``."""
    return _levels((seg_fwd, seg_bwd), xv, xh, skips, cond, ws, seed=seed,
                   base_pair=base_pair, keep=keep, masks=masks, taps=taps)

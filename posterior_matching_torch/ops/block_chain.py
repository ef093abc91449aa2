"""The VDVAE encoder's residual block chains: one whole run of blocks.

Counterpart of ``posterior_matching_tpu/ops/block_chain.py``. A run is L
consecutive residual bottleneck blocks at one resolution, each
``x + c4(gelu(c3(gelu(c2(gelu(c1(gelu(x))))))))`` with tanh-gelu, 1x1
convolutions c1 and c4 and k x k SAME convolutions c2 and c3 (k = 3 above
resolution 2, else 1).

Weights are stacked ``[L, rows, cols]`` in the kernel-native layout of the
JAX package (:func:`weight_shapes`): ``w2 = kernel.reshape(k*k*mid, mid)``,
whose row block ``t`` is tap ``(t // k, t % k)``; biases are ``[L, 1, n]``.

On the GPU a run is two hand-written kernels, ``csrc/block_chain_fwd.cu``
(replacing ``_fwd_kernel_factory``, :270, ``pallas_call`` :467) and
``csrc/block_chain_bwd.cu`` (``_bwd_kernel_factory``, :308, ``pallas_call``
:509), joined by :class:`BlockChain`, a ``torch.autograd.Function``. Beside
them is :func:`block_chain_plain`, the same blocks in plain PyTorch,
differentiated by autograd, which the dispatcher :func:`block_chain` runs
only for tensors on the CPU. The TPU kernels' VMEM chunk sizes
(``bc_fwd``, ``bc_bwd``, ``PM_TPU_BLOCK_BC_*``) tune Mosaic and have no
counterpart here.

``compute_dtype=torch.bfloat16`` is the JAX package's bf16 chain
(``block_chain.py:282-301``, ``:345-383``): c1..c3 and their gradients are
bf16 products summed in float32 (the weights w1..w3 and the saved h1..h3
rounded to bf16, the cotangent rounded as it enters a product), gelu and
its derivative in the backward are taken at the rounded saves, and c4, the
residual stream, the biases and every gradient stay float32. On the GPU it
runs on the kernels' bf16 builds (``_build.bf16_build``); its plain version
:func:`block_chain_plain` rounds with ``.to(torch.bfloat16).float()`` and
multiplies in float32 (a product of two bf16 values is exact in float32:
what ``preferred_element_type=float32`` computes; a bf16 ``matmul`` would
round its output), one :class:`Bf16Block` a level, whose backward is the
Pallas kernel's.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from posterior_matching_torch.ops import _build

# (width, mid) pairs the kernels are compiled for
# (csrc/block_chain_common.cuh, BCK_DISPATCH_WIDTHS): PM-VDVAE MNIST's 192
# and digits16's 64, both at bottleneck_multiple 0.25.
KERNEL_WIDTHS = ((192, 48), (64, 16))

Weights = Dict[str, torch.Tensor]
NAMES = ("w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4")


def weight_shapes(cin: int, mid: int, k: int) -> List[Tuple[str, Tuple[int, int]]]:
    """One level's ``(name, shape)`` in kernel-native layout
    (``block_chain.py:108-122``); a run stacks each to ``[L, *shape]``."""
    kk = k * k
    return [
        ("w1", (cin, mid)), ("b1", (1, mid)),
        ("w2", (kk * mid, mid)), ("b2", (1, mid)),
        ("w3", (kk * mid, mid)), ("b3", (1, mid)),
        ("w4", (mid, cin)), ("b4", (1, cin)),
    ]


def tap_pixels(h: int, w: int, k: int) -> int:
    """Pixel-tap pairs of a k x k SAME convolution on an h x w image whose
    tap lands inside the image (the padding's taps do no work)."""
    pad = k // 2
    return sum(max(h - abs(dy), 0) * max(w - abs(dx), 0)
               for dy in range(-pad, pad + 1) for dx in range(-pad, pad + 1))


def chain_flops(b: int, h: int, w: int, c: int, mid: int, k: int, n_lvl: int) -> float:
    """Forward operations of a run (2 a multiply-add): c1 and c4, [c, mid]
    products, at every row; c2 and c3, [mid, mid] products, at each row's
    taps that land inside the image only. The backward's are twice these
    (data and weight gradients)."""
    return 2.0 * n_lvl * b * (2 * h * w * c * mid + 2 * tap_pixels(h, w, k) * mid * mid)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def conv_taps(x: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """k x k SAME convolution of NHWC ``x [B, H, W, Cin]`` with the
    tap-major kernel ``w [k*k*Cin, N]`` -> ``[B, H, W, N]``."""
    if k == 1:
        return x @ w
    cin = x.shape[-1]
    kernel = w.reshape(k, k, cin, -1).permute(3, 2, 0, 1)
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel, padding=k // 2)
    return y.permute(0, 2, 3, 1)


def chain_supported(batch: int, h: int, w: int, compute_dtype=torch.float32) -> bool:
    """Whether a run is fused: its rows fill the TPU kernel's sublane tiles,
    8 rows in float32 and 16 in bf16 (``block_chain.py:542-549``), so that
    the port fuses exactly the runs the JAX package fuses."""
    return (batch * h * w) % (16 if compute_dtype == torch.bfloat16 else 8) == 0


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (to nearest even), kept in float32."""
    return t.to(torch.bfloat16).float()


def gelu_grad(z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``g * gelu'(z)``, as ``block_chain.py::_gelu_grad``."""
    u = 0.7978845608028654 * (z + 0.044715 * z * z * z)
    t = torch.tanh(u)
    du = 0.7978845608028654 * (1.0 + 3.0 * 0.044715 * z * z)
    return g * (0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * du)


def _vjp(fn, a: torch.Tensor, w: torch.Tensor, ct: torch.Tensor):
    """The cotangents of ``a`` and ``w`` in ``fn(a, w)`` for ``ct``."""
    with torch.enable_grad():
        a_, w_ = a.detach().requires_grad_(True), w.detach().requires_grad_(True)
        return torch.autograd.grad(fn(a_, w_), (a_, w_), ct)


def _rows_sum(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1]).sum(0, keepdim=True)


def _mm(a, w):
    return a @ w


def bf16_sub_fwd(x_in: torch.Tensor, w: Weights, k: int):
    """One Block at bf16 without its residual (``decoder_chain.py::_sub_fwd``
    at ``cdtype`` bf16): ``(h1, h2, h3, h4)``, all float32, h1..h3 not
    rounded (the forward reads them as they are)."""
    conv = lambda a, n: conv_taps(round_bf16(gelu(a)), round_bf16(w[n]), k)
    h1 = round_bf16(gelu(x_in)) @ round_bf16(w["w1"]) + w["b1"]
    h2 = conv(h1, "w2") + w["b2"]
    h3 = conv(h2, "w3") + w["b3"]
    return h1, h2, h3, gelu(h3) @ w["w4"] + w["b4"]


def bf16_sub_bwd(x_in: torch.Tensor, saves, w: Weights, dh4: torch.Tensor, k: int):
    """The backward of :func:`bf16_sub_fwd` from the rounded saves ``(h1,
    h2, h3)`` and the c4 cotangent ``dh4`` (``decoder_chain.py::_sub_bwd``):
    the cotangent of ``x_in`` and the Block's weight gradients."""
    h1, h2, h3 = saves
    conv = lambda a, b: conv_taps(a, b, k)
    dg3, dw4 = _vjp(_mm, gelu(h3), w["w4"], dh4)
    dh3 = gelu_grad(h3, dg3)
    dg2, dw3 = _vjp(conv, round_bf16(gelu(h2)), round_bf16(w["w3"]), round_bf16(dh3))
    dh2 = gelu_grad(h2, dg2)
    dg1, dw2 = _vjp(conv, round_bf16(gelu(h1)), round_bf16(w["w2"]), round_bf16(dh2))
    dh1 = gelu_grad(h1, dg1)
    dg0, dw1 = _vjp(_mm, round_bf16(gelu(x_in)), round_bf16(w["w1"]), round_bf16(dh1))
    grads = {"w1": dw1, "b1": _rows_sum(dh1), "w2": dw2, "b2": _rows_sum(dh2),
             "w3": dw3, "b3": _rows_sum(dh3), "w4": dw4, "b4": _rows_sum(dh4)}
    return gelu_grad(x_in, dg0), grads


class Bf16Block(torch.autograd.Function):
    """One Block at bf16 without its residual, ``h4`` of
    :func:`bf16_sub_fwd`, whose backward is :func:`bf16_sub_bwd` from the
    h1..h3 saves rounded to bf16 (as the Pallas kernels save them)."""

    @staticmethod
    def forward(ctx, k: int, x_in, *ws):
        w = dict(zip(NAMES, ws))
        h1, h2, h3, h4 = bf16_sub_fwd(x_in, w, k)
        ctx.k = k
        ctx.save_for_backward(x_in, round_bf16(h1), round_bf16(h2), round_bf16(h3), *ws)
        return h4

    @staticmethod
    def backward(ctx, dh4):
        x_in, h1, h2, h3, *ws = ctx.saved_tensors
        dx, grads = bf16_sub_bwd(x_in, (h1, h2, h3), dict(zip(NAMES, ws)), dh4, ctx.k)
        return (None, dx, *(grads[n] for n in NAMES))


def bf16_chain_bwd(x0: torch.Tensor, xout: torch.Tensor, saves, weights: Weights,
                   g: torch.Tensor, k: int):
    """The backward of a bf16 run from given forward saves: ``x0 [B, H, W,
    C]``, every level's output ``xout [L, B, H, W, C]``, the h1, h2, h3
    saves (each ``[L, B, H, W, mid]``, rounded to bf16) and the cotangent
    ``g`` of the run's output. Returns ``dx0`` and the stacked weight
    gradients. :class:`Bf16Block`'s backward level by level; fed the
    kernel's forward saves, it is the plain version of the backward kernel
    alone."""
    d, grads = g, {n: [] for n in NAMES}
    for lvl in reversed(range(weights["w1"].shape[0])):
        x_in = xout[lvl - 1] if lvl else x0
        dx, gl = bf16_sub_bwd(x_in, tuple(h[lvl] for h in saves),
                              {n: weights[n][lvl] for n in NAMES}, d, k)
        d = d + dx
        for n in NAMES:
            grads[n].insert(0, gl[n])
    return d, {n: torch.stack(v) for n, v in grads.items()}


def block_chain_plain(x: torch.Tensor, weights: Weights, *, mid: int, k: int,
                      compute_dtype=torch.float32) -> torch.Tensor:
    """L residual bottleneck blocks in plain PyTorch: ``x [B, H, W, C]``,
    ``weights`` stacked as :func:`weight_shapes` says; returns the last
    block's output. In bf16 one :class:`Bf16Block` a level."""
    w = weights
    if w["w1"].shape[-1] != mid:
        raise ValueError(f"w1 has {w['w1'].shape[-1]} columns, mid is {mid}")
    _build.bf16_build("block_chain", compute_dtype)   # float32 or bfloat16 only
    for lvl in range(w["w1"].shape[0]):
        if compute_dtype == torch.bfloat16:
            x = x + Bf16Block.apply(k, x, *(w[n][lvl] for n in NAMES))
            continue
        h = gelu(x) @ w["w1"][lvl] + w["b1"][lvl]
        h = conv_taps(gelu(h), w["w2"][lvl], k) + w["b2"][lvl]
        h = conv_taps(gelu(h), w["w3"][lvl], k) + w["b3"][lvl]
        x = x + gelu(h) @ w["w4"][lvl] + w["b4"][lvl]
    return x


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

# Argument order of the C entry points (csrc/block_chain_{fwd,bwd}.cu).
_GEOMETRY = ("L", "B", "H", "W", "C", "M", "K", "BF")
_FWD_PTRS = ("x0", *NAMES, "xout", "h1", "h2", "h3")
_BWD_PTRS = ("g", "x0", "xout", "h1", "h2", "h3", "w1", "w2", "w3", "w4",
             "dx0", *("d" + n for n in NAMES), "dxs", "dh1", "dh2", "dh3", "part")


class ChainConfig:
    """Static geometry of one run, shared by its forward and backward, and
    its compute dtype (float32 or bfloat16)."""

    def __init__(self, x: torch.Tensor, n_levels: int, mid: int, k: int,
                 compute_dtype=torch.float32):
        self.b, self.h, self.w, self.c = x.shape
        self.n_levels, self.mid, self.k = n_levels, mid, k
        self.fwd_lib = _build.bf16_build("block_chain_fwd", compute_dtype)
        self.bwd_lib = _build.bf16_build("block_chain_bwd", compute_dtype)
        self.bf16 = compute_dtype == torch.bfloat16
        # the dtype of w1..w3 and of the h saves
        self.cdtype = torch.bfloat16 if self.bf16 else torch.float32
        if (self.c, mid) not in KERNEL_WIDTHS:
            raise ValueError(
                f"block_chain kernels take (width, mid) in {KERNEL_WIDTHS}, "
                f"got ({self.c}, {mid})"
            )
        if k not in (1, 3):
            raise ValueError(f"block_chain kernels take k = 1 or 3, got {k}")

    @property
    def rows(self) -> int:
        return self.b * self.h * self.w

    def ints(self):
        vals = {"L": self.n_levels, "B": self.b, "H": self.h, "W": self.w,
                "C": self.c, "M": self.mid, "K": self.k, "BF": int(self.bf16)}
        return (ctypes.c_int * len(_GEOMETRY))(*[vals[n] for n in _GEOMETRY])

    def weight_shapes(self) -> Dict[str, Tuple[int, ...]]:
        return {n: (self.n_levels, *s)
                for n, s in weight_shapes(self.c, self.mid, self.k)}

    def dtype_of(self, name: str) -> torch.dtype:
        """The dtype the kernels take for tensor ``name``: w1..w3 and the h
        saves (and their names with a ``d``) are of the compute dtype."""
        return self.cdtype if name in ("w1", "w2", "w3", "h1", "h2", "h3") else torch.float32


def _launch(lib_name: str, fn: str, names: Sequence[str],
            tensors: Dict[str, torch.Tensor], cfg: ChainConfig, device):
    if lib_name.endswith("_fwd_bf16"):
        names = (*names, "hs")   # the bf16 build's float32 scratch
    ptrs = (ctypes.c_void_p * len(names))(*[tensors[n].data_ptr() for n in names])
    lib = _build.load_fn(lib_name, fn, [_build.P, _build.I, _build.P, _build.I, _build.P])
    stream = torch.cuda.current_stream(device).cuda_stream
    return lib, getattr(lib, fn)(ptrs, len(names), cfg.ints(), len(_GEOMETRY), stream)


def _part_floats(cfg: ChainConfig) -> int:
    """Floats of the backward's ``part`` scratch, as the kernel reports it."""
    fn = _build.load(cfg.bwd_lib).pm_block_chain_bwd_part_floats
    fn.argtypes, fn.restype = [_build.P, _build.I], ctypes.c_longlong
    n = fn(cfg.ints(), len(_GEOMETRY))
    if n < 0:
        raise ValueError("block_chain_bwd refuses this geometry")
    return n


def _check_all(tensors: Dict[str, torch.Tensor], shapes: Dict[str, Tuple[int, ...]],
               cfg: ChainConfig):
    for name, shape in shapes.items():
        t = tensors.get(name)
        if t is None:
            raise ValueError(f"{name}: missing")
        if t.device.type != "cuda":
            raise ValueError(f"{name}: the kernels take CUDA tensors, got {t.device}")
        if _build.check(name, t, shape, cfg.dtype_of(name)) % 16:
            raise ValueError(f"{name}: the kernels need 16-byte aligned tensors")


class _ChainFwd:
    """Wrapper of ``csrc/block_chain_fwd.cu`` (its float32 or bf16 build, by
    ``cfg``): one call runs a whole run (4 kernels per level on one stream)
    and counts as one launch."""

    def __init__(self):
        self.launches = 0

    def __call__(self, cfg: ChainConfig, x0: torch.Tensor, w: Weights) -> Dict[str, torch.Tensor]:
        L, R, m = cfg.n_levels, cfg.rows, cfg.mid
        t = {"x0": x0, **w}
        _check_all(t, {"x0": (R, cfg.c), **cfg.weight_shapes()}, cfg)
        empty = lambda *s, dtype=torch.float32: torch.empty(s, device=x0.device, dtype=dtype)
        out = {"xout": empty(L, R, cfg.c),
               **{h: empty(L, R, m, dtype=cfg.cdtype) for h in ("h1", "h2", "h3")}}
        t.update(out)
        if cfg.fwd_lib.endswith("_bf16"):   # the bf16 build's float32 scratch
            t["hs"] = empty(3, R, m)
        lib, err = _launch(cfg.fwd_lib, "pm_block_chain_fwd", _FWD_PTRS, t, cfg, x0.device)
        self.launches += 1
        _build.raise_on(lib, err, cfg.fwd_lib)
        return out


class _ChainBwd:
    """Wrapper of ``csrc/block_chain_bwd.cu``: one call is a whole run's VJP
    and counts as one launch."""

    def __init__(self):
        self.launches = 0

    def __call__(self, cfg: ChainConfig, g: torch.Tensor, saved: Dict[str, torch.Tensor],
                 w: Weights) -> Dict[str, torch.Tensor]:
        L, R, c, m = cfg.n_levels, cfg.rows, cfg.c, cfg.mid
        t = {"g": g, **saved, **w}
        shapes = {"g": (R, c), "x0": (R, c), "xout": (L, R, c), "h1": (L, R, m),
                  "h2": (L, R, m), "h3": (L, R, m),
                  **{n: s for n, s in cfg.weight_shapes().items() if n.startswith("w")}}
        _check_all(t, shapes, cfg)
        empty = lambda *s: torch.empty(s, device=g.device)
        grads = {"dx0": empty(R, c)}
        for name, shape in cfg.weight_shapes().items():
            grads["d" + name] = empty(*shape)
        scratch = {"dxs": empty(L, R, c), "dh1": empty(L, R, m), "dh2": empty(L, R, m),
                   "dh3": empty(L, R, m), "part": empty(_part_floats(cfg))}
        t.update(grads, **scratch)
        lib, err = _launch(cfg.bwd_lib, "pm_block_chain_bwd", _BWD_PTRS, t, cfg, g.device)
        self.launches += 1
        _build.raise_on(lib, err, cfg.bwd_lib)
        return grads


# the float32 builds' wrappers and the bf16 builds', each with its count
chain_fwd = _ChainFwd()
chain_bwd = _ChainBwd()
chain_fwd_bf16 = _ChainFwd()
chain_bwd_bf16 = _ChainBwd()


class BlockChain(torch.autograd.Function):
    """A run whose forward and backward are the hand-written kernels. Saved
    for the backward: the run's input, every level's output and the
    pre-gelu h1, h2, h3; level ``l``'s input is level ``l - 1``'s output,
    so it is not saved twice."""

    @staticmethod
    def forward(ctx, cfg: ChainConfig, x0, *ws):
        # w1..w3 cast to the compute dtype here, inside the Function, so
        # that their float32 gradients reach the float32 weights unrounded
        w = {n: t.to(cfg.dtype_of(n)) for n, t in zip(NAMES, ws)}
        out = (chain_fwd_bf16 if cfg.bf16 else chain_fwd)(cfg, x0, w)
        ctx.cfg = cfg
        ctx.save_for_backward(x0, out["xout"], out["h1"], out["h2"], out["h3"],
                              w["w1"], w["w2"], w["w3"], w["w4"])
        return out["xout"][-1]

    @staticmethod
    def backward(ctx, g):
        cfg = ctx.cfg
        x0, xout, h1, h2, h3, w1, w2, w3, w4 = ctx.saved_tensors
        saved = {"x0": x0, "xout": xout, "h1": h1, "h2": h2, "h3": h3}
        grads = (chain_bwd_bf16 if cfg.bf16 else chain_bwd)(
            cfg, g.contiguous(), saved, {"w1": w1, "w2": w2, "w3": w3, "w4": w4})
        return (None, grads["dx0"], *(grads["d" + n] for n in NAMES))


def block_chain(x: torch.Tensor, weights: Weights, *, mid: int, k: int,
                compute_dtype=torch.float32) -> torch.Tensor:
    """One run of L blocks (the arguments of :func:`block_chain_plain`):
    the plain version for CPU tensors, the kernels (:class:`BlockChain`) for
    CUDA tensors. In bf16 w1..w3 are cast to bf16 here, as the JAX
    wrapper does (``block_chain.py:626-631``); their gradients come back in
    float32."""
    if _build.on_cpu([x, *weights.values()]):
        return block_chain_plain(x, weights, mid=mid, k=k, compute_dtype=compute_dtype)
    n_levels = weights["w1"].shape[0]
    cfg = ChainConfig(x, n_levels, mid, k, compute_dtype)
    b, h, w_, c = x.shape
    out = BlockChain.apply(cfg, x.reshape(b * h * w_, c).contiguous(),
                           *[weights[n].contiguous() for n in NAMES])
    return out.reshape(b, h, w_, c)

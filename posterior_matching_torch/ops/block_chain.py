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


def block_chain_plain(x: torch.Tensor, weights: Weights, *, mid: int, k: int) -> torch.Tensor:
    """L residual bottleneck blocks in plain PyTorch: ``x [B, H, W, C]``,
    ``weights`` stacked as :func:`weight_shapes` says; returns the last
    block's output."""
    w = weights
    if w["w1"].shape[-1] != mid:
        raise ValueError(f"w1 has {w['w1'].shape[-1]} columns, mid is {mid}")
    for lvl in range(w["w1"].shape[0]):
        h = gelu(x) @ w["w1"][lvl] + w["b1"][lvl]
        h = conv_taps(gelu(h), w["w2"][lvl], k) + w["b2"][lvl]
        h = conv_taps(gelu(h), w["w3"][lvl], k) + w["b3"][lvl]
        x = x + gelu(h) @ w["w4"][lvl] + w["b4"][lvl]
    return x


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

# Argument order of the C entry points (csrc/block_chain_{fwd,bwd}.cu).
_GEOMETRY = ("L", "B", "H", "W", "C", "M", "K")
_FWD_PTRS = ("x0", *NAMES, "xout", "h1", "h2", "h3")
_BWD_PTRS = ("g", "x0", "xout", "h1", "h2", "h3", "w1", "w2", "w3", "w4",
             "dx0", *("d" + n for n in NAMES), "dxs", "dh1", "dh2", "dh3", "part")


class ChainConfig:
    """Static geometry of one run, shared by its forward and backward."""

    def __init__(self, x: torch.Tensor, n_levels: int, mid: int, k: int):
        self.b, self.h, self.w, self.c = x.shape
        self.n_levels, self.mid, self.k = n_levels, mid, k
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
                "C": self.c, "M": self.mid, "K": self.k}
        return (ctypes.c_int * len(_GEOMETRY))(*[vals[n] for n in _GEOMETRY])

    def weight_shapes(self) -> Dict[str, Tuple[int, ...]]:
        return {n: (self.n_levels, *s)
                for n, s in weight_shapes(self.c, self.mid, self.k)}


def _launch(lib_name: str, fn: str, names: Sequence[str],
            tensors: Dict[str, torch.Tensor], cfg: ChainConfig, device):
    ptrs = (ctypes.c_void_p * len(names))(*[tensors[n].data_ptr() for n in names])
    lib = _build.load_fn(lib_name, fn, [_build.P, _build.I, _build.P, _build.I, _build.P])
    stream = torch.cuda.current_stream(device).cuda_stream
    return lib, getattr(lib, fn)(ptrs, len(names), cfg.ints(), len(_GEOMETRY), stream)


def _part_floats(cfg: ChainConfig) -> int:
    """Floats of the backward's ``part`` scratch, as the kernel reports it."""
    fn = _build.load("block_chain_bwd").pm_block_chain_bwd_part_floats
    fn.argtypes, fn.restype = [_build.P, _build.I], ctypes.c_longlong
    n = fn(cfg.ints(), len(_GEOMETRY))
    if n < 0:
        raise ValueError("block_chain_bwd refuses this geometry")
    return n


def _check_all(tensors: Dict[str, torch.Tensor], shapes: Dict[str, Tuple[int, ...]]):
    for name, shape in shapes.items():
        t = tensors.get(name)
        if t is None:
            raise ValueError(f"{name}: missing")
        if t.device.type != "cuda":
            raise ValueError(f"{name}: the kernels take CUDA tensors, got {t.device}")
        if _build.check(name, t, shape) % 16:
            raise ValueError(f"{name}: the kernels need 16-byte aligned tensors")


class _ChainFwd:
    """Wrapper of ``csrc/block_chain_fwd.cu``: one call runs a whole run (4
    kernels per level on one stream) and counts as one launch."""

    def __init__(self):
        self.launches = 0

    def __call__(self, cfg: ChainConfig, x0: torch.Tensor, w: Weights) -> Dict[str, torch.Tensor]:
        L, R = cfg.n_levels, cfg.rows
        t = {"x0": x0, **w}
        _check_all(t, {"x0": (R, cfg.c), **cfg.weight_shapes()})
        empty = lambda *s: torch.empty(s, device=x0.device)
        out = {"xout": empty(L, R, cfg.c), "h1": empty(L, R, cfg.mid),
               "h2": empty(L, R, cfg.mid), "h3": empty(L, R, cfg.mid)}
        t.update(out)
        lib, err = _launch("block_chain_fwd", "pm_block_chain_fwd", _FWD_PTRS,
                           t, cfg, x0.device)
        self.launches += 1
        _build.raise_on(lib, err, "block_chain_fwd")
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
        _check_all(t, shapes)
        empty = lambda *s: torch.empty(s, device=g.device)
        grads = {"dx0": empty(R, c)}
        for name, shape in cfg.weight_shapes().items():
            grads["d" + name] = empty(*shape)
        scratch = {"dxs": empty(L, R, c), "dh1": empty(L, R, m), "dh2": empty(L, R, m),
                   "dh3": empty(L, R, m), "part": empty(_part_floats(cfg))}
        t.update(grads, **scratch)
        lib, err = _launch("block_chain_bwd", "pm_block_chain_bwd", _BWD_PTRS,
                           t, cfg, g.device)
        self.launches += 1
        _build.raise_on(lib, err, "block_chain_bwd")
        return grads


chain_fwd = _ChainFwd()
chain_bwd = _ChainBwd()


class BlockChain(torch.autograd.Function):
    """A run whose forward and backward are the hand-written kernels. Saved
    for the backward: the run's input, every level's output and the
    pre-gelu h1, h2, h3; level ``l``'s input is level ``l - 1``'s output,
    so it is not saved twice."""

    @staticmethod
    def forward(ctx, cfg: ChainConfig, x0, *ws):
        w = dict(zip(NAMES, ws))
        out = chain_fwd(cfg, x0, w)
        ctx.cfg = cfg
        ctx.save_for_backward(x0, out["xout"], out["h1"], out["h2"], out["h3"],
                              w["w1"], w["w2"], w["w3"], w["w4"])
        return out["xout"][-1]

    @staticmethod
    def backward(ctx, g):
        cfg = ctx.cfg
        x0, xout, h1, h2, h3, w1, w2, w3, w4 = ctx.saved_tensors
        saved = {"x0": x0, "xout": xout, "h1": h1, "h2": h2, "h3": h3}
        grads = chain_bwd(cfg, g.contiguous(), saved,
                          {"w1": w1, "w2": w2, "w3": w3, "w4": w4})
        return (None, grads["dx0"], *(grads["d" + n] for n in NAMES))


def block_chain(x: torch.Tensor, weights: Weights, *, mid: int, k: int) -> torch.Tensor:
    """One run of L blocks (the arguments of :func:`block_chain_plain`):
    the plain version for CPU tensors, the kernels (:class:`BlockChain`) for
    CUDA tensors."""
    if _build.on_cpu([x, *weights.values()]):
        return block_chain_plain(x, weights, mid=mid, k=k)
    n_levels = weights["w1"].shape[0]
    cfg = ChainConfig(x, n_levels, mid, k)
    b, h, w_, c = x.shape
    out = BlockChain.apply(cfg, x.reshape(b * h * w_, c).contiguous(),
                           *[weights[n].contiguous() for n in NAMES])
    return out.reshape(b, h, w_, c)

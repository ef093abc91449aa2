"""The VDVAE decoder's block runs: one resolution's run of PM decoder blocks.

Counterpart of ``posterior_matching_tpu/ops/decoder_chain.py``. A run is L
consecutive decoder blocks at one resolution (the first may carry the
mixin, which the caller folds into ``x0``). Each level, on the state ``x``
and the encoders' activations ``acts`` / ``macts`` at this resolution:

- ``post = Block_p([x, acts])``, ``2 ld`` wide: the posterior's loc and raw
  scale;
- ``masked = Block_m([stop_grad(x), macts])``, ``ld + tril`` wide: the
  masked posterior's raw parameters;
- ``q = Block_q(x)``: the prior's head ``q[:, :2 ld]`` and the tail that
  joins the state;
- ``z = loc + (softplus(raw) + 1e-5) eps``, with ``eps`` drawn beforehand;
- ``u = x + tail + z @ wz + bz``; the level's output is ``u + Block_r(u)``.

``Block`` is ``gelu -> c1 (1x1) -> gelu -> c2 (k x k) -> gelu -> c3 (k x k)
-> gelu -> c4 (1x1)`` with tanh-gelu, c1..c3 ``mid`` wide, k = 3 above
resolution 2, else 1. Weights are stacked ``[L, rows, cols]`` in the JAX
package's kernel-native layout (:func:`weight_shapes`, ``:104-129``).

On the GPU a run is two hand-written kernels, ``csrc/decoder_chain_fwd.cu``
(replacing ``_fwd_kernel_factory``, :226, ``pallas_call`` :479) and
``csrc/decoder_chain_bwd.cu`` (``_bwd_kernel_factory``, :291,
``pallas_call`` :532), both on the tensor-core GEMM core of
``csrc/vdvae_gemm.cuh``, joined by :class:`DecChain`, a
``torch.autograd.Function`` whose backward takes the cotangents of all four
outputs. Beside them is :func:`dec_chain_plain`, the same run in plain
PyTorch, differentiated by autograd, which the dispatcher :func:`dec_chain`
runs only for tensors on the CPU. The TPU kernels' VMEM chunk sizes
(``bc_fwd``, ``bc_bwd``, ``PM_TPU_DEC_BC_*``) tune Mosaic and have no
counterpart here.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from posterior_matching_torch.distributions._math import softplus_scale, tril_size
from posterior_matching_torch.ops import _build
from posterior_matching_torch.ops.block_chain import conv_taps, gelu, tap_pixels

# (width, mid, latent) triples the kernels are compiled for
# (csrc/decoder_chain_common.cuh, DCK_DISPATCH_WIDTHS): PM-VDVAE MNIST's and
# digits16's. The encoder activations are as wide as the state.
KERNEL_GEOMETRIES = ((192, 48, 16), (64, 16, 8))

Weights = Dict[str, torch.Tensor]
TAGS = ("p", "m", "q", "r")
NAMES = tuple(f"{t}_{n}" for t in TAGS
              for n in ("w1", "b1", "w2", "b2", "w3", "b3", "w4", "b4")) + ("wz", "bz")
SAVES = tuple(f"{t}h{i}" for t in TAGS for i in (1, 2, 3))


def weight_shapes(width: int, awidth: int, mid: int, ld: int, k: int
                  ) -> List[Tuple[str, Tuple[int, int]]]:
    """One level's ``(name, shape)`` in kernel-native layout, in
    :data:`NAMES` order; a run stacks each to ``[L, *shape]``."""
    kk, tril = k * k, tril_size(ld)
    io = {"p": (width + awidth, 2 * ld), "m": (width + awidth, ld + tril),
          "q": (width, 2 * ld + width), "r": (width, width)}
    shapes = []
    for tag in TAGS:
        cin, cout = io[tag]
        shapes += [(f"{tag}_w1", (cin, mid)), (f"{tag}_b1", (1, mid)),
                   (f"{tag}_w2", (kk * mid, mid)), (f"{tag}_b2", (1, mid)),
                   (f"{tag}_w3", (kk * mid, mid)), (f"{tag}_b3", (1, mid)),
                   (f"{tag}_w4", (mid, cout)), (f"{tag}_b4", (1, cout))]
    return shapes + [("wz", (ld, width)), ("bz", (1, width))]


def chain_flops(b: int, h: int, w: int, c: int, mid: int, ld: int, k: int,
                n_lvl: int) -> float:
    """Forward operations of a run (2 a multiply-add): at every row c1 of
    the four Blocks (inputs 2c, 2c, c, c), their c4 (outputs 2 ld, ld +
    tril, 2 ld + c, c) and the z projection; c2 and c3 of the four at the
    taps that land inside the image only."""
    rows, mw = b * h * w, ld + tril_size(ld)
    per_level = (2 * rows * mid * 6 * c + 4 * 2 * 2 * b * tap_pixels(h, w, k) * mid * mid
                 + 2 * rows * mid * (2 * ld + mw + 2 * ld + c + c) + 2 * rows * ld * c)
    return float(n_lvl * per_level)


def bwd_flops(flops: float, rows: int, c: int, mid: int, n_lvl: int) -> float:
    """The backward's operations: each forward product twice (data and
    weight gradients) but the masked Block's data gradient on the state."""
    return 2 * flops - 2.0 * n_lvl * rows * c * mid


def _block(w: Weights, tag: str, lvl: int, x: torch.Tensor, k: int) -> torch.Tensor:
    """One Block at level ``lvl``, without a residual."""
    g = lambda n: w[f"{tag}_{n}"][lvl]
    h = gelu(x) @ g("w1") + g("b1")
    h = conv_taps(gelu(h), g("w2"), k) + g("b2")
    h = conv_taps(gelu(h), g("w3"), k) + g("b3")
    return gelu(h) @ g("w4") + g("b4")


def dec_chain_plain(x0: torch.Tensor, acts: torch.Tensor, macts: torch.Tensor,
                    eps: torch.Tensor, weights: Weights, *, ld: int, k: int):
    """L decoder blocks in plain PyTorch: ``x0``, ``acts``, ``macts``
    ``[B, H, W, C]``, ``eps [L, B, H, W, ld]``, ``weights`` stacked as
    :func:`weight_shapes` says. Returns ``(x_final [B, H, W, C], post [L, B,
    H, W, 2 ld], prior [L, B, H, W, 2 ld], masked [L, B, H, W, ld + tril])``
    (``_fwd_kernel_factory``, :233-286)."""
    x, post, prior, masked = x0, [], [], []
    for lvl in range(eps.shape[0]):
        p = _block(weights, "p", lvl, torch.cat([x, acts], -1), k)
        masked.append(_block(weights, "m", lvl, torch.cat([x.detach(), macts], -1), k))
        q = _block(weights, "q", lvl, x, k)
        z = p[..., :ld] + softplus_scale(p[..., ld:]) * eps[lvl]
        u = x + q[..., 2 * ld:] + z @ weights["wz"][lvl] + weights["bz"][lvl]
        x = u + _block(weights, "r", lvl, u, k)
        post.append(p)
        prior.append(q[..., :2 * ld])
    return x, torch.stack(post), torch.stack(prior), torch.stack(masked)


def dec_chain_supported(batch: int, h: int, w: int) -> bool:
    """Whether a run is fused: its rows fill the TPU kernel's 8-row sublane
    tiles (``decoder_chain.py:663-665``, float32), so that the port fuses
    exactly the runs the JAX package fuses."""
    return (batch * h * w) % 8 == 0


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

# Argument order of the C entry points (csrc/decoder_chain_{fwd,bwd}.cu).
_GEOMETRY = ("L", "B", "H", "W", "C", "M", "K", "LD")
_FWD_PTRS = ("x0", "acts", "macts", "eps", *NAMES, "xout", "post", "prior", "masked", "u",
             *SAVES)
_BWD_PTRS = ("g", "gpost", "gprior", "gmask", "x0", "acts", "macts", "eps", "xout", "post",
             "u", *SAVES, *NAMES, "dx0", "dacts", "dmacts", *("d" + n for n in NAMES),
             "dxs", "dus", "dpost", "zs", *("d" + s for s in SAVES), "part")
# what the backward needs of the forward's inputs and outputs
_SAVED = ("x0", "acts", "macts", "eps", "xout", "post", "u", *SAVES)


class DecConfig:
    """Static geometry of one run, shared by its forward and backward."""

    def __init__(self, x0: torch.Tensor, acts: torch.Tensor, n_levels: int, mid: int,
                 ld: int, k: int):
        self.b, self.h, self.w, self.c = x0.shape
        self.n_levels, self.mid, self.ld, self.k = n_levels, mid, ld, k
        if (self.c, mid, ld) not in KERNEL_GEOMETRIES:
            raise ValueError(f"dec_chain kernels take (width, mid, ld) in "
                             f"{KERNEL_GEOMETRIES}, got ({self.c}, {mid}, {ld})")
        if tuple(acts.shape) != tuple(x0.shape):
            raise ValueError(f"dec_chain kernels take activations as wide as the state "
                             f"{tuple(x0.shape)}, got {tuple(acts.shape)}")
        if k not in (1, 3):
            raise ValueError(f"dec_chain kernels take k = 1 or 3, got {k}")

    @property
    def rows(self) -> int:
        return self.b * self.h * self.w

    def ints(self):
        vals = {"L": self.n_levels, "B": self.b, "H": self.h, "W": self.w, "C": self.c,
                "M": self.mid, "K": self.k, "LD": self.ld}
        return (ctypes.c_int * len(_GEOMETRY))(*[vals[n] for n in _GEOMETRY])

    def shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Every tensor of the forward's interface, by its argument name."""
        L, R, c, m, ld = self.n_levels, self.rows, self.c, self.mid, self.ld
        out = {"x0": (R, c), "acts": (R, c), "macts": (R, c), "eps": (L, R, ld),
               "xout": (L, R, c), "post": (L, R, 2 * ld), "prior": (L, R, 2 * ld),
               "masked": (L, R, ld + tril_size(ld)), "u": (L, R, c)}
        out.update({s: (L, R, m) for s in SAVES})
        out.update({n: (L, *s) for n, s in weight_shapes(c, c, m, ld, self.k)})
        return out


def _launch(lib_name: str, fn: str, names: Sequence[str],
            tensors: Dict[str, torch.Tensor], cfg: DecConfig, device):
    ptrs = (ctypes.c_void_p * len(names))(*[tensors[n].data_ptr() for n in names])
    lib = _build.load_fn(lib_name, fn, [_build.P, _build.I, _build.P, _build.I, _build.P])
    stream = torch.cuda.current_stream(device).cuda_stream
    return lib, getattr(lib, fn)(ptrs, len(names), cfg.ints(), len(_GEOMETRY), stream)


def _part_floats(cfg: DecConfig) -> int:
    """Floats of the backward's ``part`` scratch, as the kernel reports it."""
    fn = _build.load("decoder_chain_bwd").pm_decoder_chain_bwd_part_floats
    fn.argtypes, fn.restype = [_build.P, _build.I], ctypes.c_longlong
    n = fn(cfg.ints(), len(_GEOMETRY))
    if n < 0:
        raise ValueError("decoder_chain_bwd refuses this geometry")
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


class _DecFwd:
    """Wrapper of ``csrc/decoder_chain_fwd.cu``: one call runs a whole run
    (9 kernels per level on one stream) and counts as one launch."""

    def __init__(self):
        self.launches = 0

    def __call__(self, cfg: DecConfig, inputs: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        shapes = cfg.shapes()
        _check_all(inputs, {n: shapes[n] for n in ("x0", "acts", "macts", "eps", *NAMES)})
        dev = inputs["x0"].device
        out = {n: torch.empty(shapes[n], device=dev)
               for n in ("xout", "post", "prior", "masked", "u", *SAVES)}
        lib, err = _launch("decoder_chain_fwd", "pm_decoder_chain_fwd", _FWD_PTRS,
                           {**inputs, **out}, cfg, dev)
        self.launches += 1
        _build.raise_on(lib, err, "decoder_chain_fwd")
        return out


class _DecBwd:
    """Wrapper of ``csrc/decoder_chain_bwd.cu``: one call is a whole run's
    VJP and counts as one launch. ``cots`` holds the cotangents ``g``,
    ``gpost``, ``gprior`` and ``gmask``; ``saved`` the tensors of
    ``_SAVED``."""

    def __init__(self):
        self.launches = 0

    def __call__(self, cfg: DecConfig, cots: Dict[str, torch.Tensor],
                 saved: Dict[str, torch.Tensor], w: Weights) -> Dict[str, torch.Tensor]:
        shapes = cfg.shapes()
        L, R, c, m, ld = cfg.n_levels, cfg.rows, cfg.c, cfg.mid, cfg.ld
        cot_shapes = {"g": shapes["x0"], "gpost": shapes["post"],
                      "gprior": shapes["prior"], "gmask": shapes["masked"]}
        t = {**cots, **saved, **w}
        _check_all(t, {**cot_shapes, **{n: shapes[n] for n in (*_SAVED, *NAMES)}})
        dev = cots["g"].device
        empty = lambda *s: torch.empty(s, device=dev)
        grads = {"dx0": empty(R, c), "dacts": empty(R, c), "dmacts": empty(R, c)}
        grads.update({"d" + n: empty(*shapes[n]) for n in NAMES})
        scratch = {"dxs": empty(L, R, c), "dus": empty(L, R, c), "dpost": empty(L, R, 2 * ld),
                   "zs": empty(L, R, ld), "part": empty(_part_floats(cfg))}
        scratch.update({"d" + s: empty(L, R, m) for s in SAVES})
        lib, err = _launch("decoder_chain_bwd", "pm_decoder_chain_bwd", _BWD_PTRS,
                           {**t, **grads, **scratch}, cfg, dev)
        self.launches += 1
        _build.raise_on(lib, err, "decoder_chain_bwd")
        return grads


dec_fwd = _DecFwd()
dec_bwd = _DecBwd()


class DecChain(torch.autograd.Function):
    """A run whose forward and backward are the hand-written kernels, on
    flat ``[rows, cols]`` tensors. Outputs: ``x_final [R, C]``, ``post``,
    ``prior``, ``masked`` ``[L, R, cols]``. The backward takes a cotangent
    of each (zeros for an output no loss used) and gives ``eps`` no
    gradient."""

    @staticmethod
    def forward(ctx, cfg: DecConfig, x0, acts, macts, eps, *ws):
        w = dict(zip(NAMES, ws))
        out = dec_fwd(cfg, {"x0": x0, "acts": acts, "macts": macts, "eps": eps, **w})
        ctx.cfg = cfg
        keep = {"x0": x0, "acts": acts, "macts": macts, "eps": eps, **out}
        ctx.save_for_backward(*(keep[n] for n in _SAVED), *ws)
        return out["xout"][-1], out["post"], out["prior"], out["masked"]

    @staticmethod
    def backward(ctx, gx, gpost, gprior, gmask):
        # an output no loss used arrives as zeros (autograd materialises
        # them: ctx.materialize_grads is on by default)
        saved = ctx.saved_tensors
        keep = dict(zip(_SAVED, saved[:len(_SAVED)]))
        w = dict(zip(NAMES, saved[len(_SAVED):]))
        cots = {"g": gx.contiguous(), "gpost": gpost.contiguous(),
                "gprior": gprior.contiguous(), "gmask": gmask.contiguous()}
        grads = dec_bwd(ctx.cfg, cots, keep, w)
        return (None, grads["dx0"], grads["dacts"], grads["dmacts"], None,
                *(grads["d" + n] for n in NAMES))


def dec_chain(x0: torch.Tensor, acts: torch.Tensor, macts: torch.Tensor, eps: torch.Tensor,
              weights: Weights, *, mid: int, ld: int, k: int):
    """One run of L decoder blocks (the arguments and results of
    :func:`dec_chain_plain`; ``mid`` is c1..c3's width): the plain version
    for CPU tensors, the kernels (:class:`DecChain`) for CUDA tensors."""
    if _build.on_cpu([x0, acts, macts, eps, *weights.values()]):
        if weights["p_w1"].shape[-1] != mid:
            raise ValueError(f"p_w1 has {weights['p_w1'].shape[-1]} columns, mid is {mid}")
        return dec_chain_plain(x0, acts, macts, eps, weights, ld=ld, k=k)
    L, (b, h, w_, c) = eps.shape[0], x0.shape
    cfg = DecConfig(x0, acts, L, mid, ld, k)
    flat = lambda t: t.reshape(b * h * w_, t.shape[-1]).contiguous()
    x_final, post, prior, masked = DecChain.apply(
        cfg, flat(x0), flat(acts), flat(macts), eps.reshape(L, b * h * w_, ld).contiguous(),
        *[weights[n].contiguous() for n in NAMES])
    shape5 = lambda t: t.reshape(L, b, h, w_, t.shape[-1])
    return x_final.reshape(b, h, w_, c), shape5(post), shape5(prior), shape5(masked)

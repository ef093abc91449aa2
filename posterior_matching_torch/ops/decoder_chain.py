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

``compute_dtype=torch.bfloat16`` is the JAX package's bf16 run: the four
Blocks' c1..c3 and their gradients are bf16 products summed in float32
(their weights and the twelve h saves rounded to bf16), every c4, the z
path and the state stay float32, and the backward recomputes u, z and the
posterior's raw scale from the rounded saves (``_recompute_uz``, :196-218)
and gelu's derivative at them. On the GPU it runs on the kernels' bf16
builds; its plain version is one :class:`Bf16DecLevel` a level, whose
backward is the Pallas kernel's (:330-378), on
:func:`~posterior_matching_torch.ops.block_chain.bf16_sub_fwd` /
``bf16_sub_bwd``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from posterior_matching_torch.distributions._math import softplus_scale, tril_size
from posterior_matching_torch.ops import _build
from posterior_matching_torch.ops import block_chain as bc
from posterior_matching_torch.ops.block_chain import (
    bf16_sub_bwd, bf16_sub_fwd, conv_taps, gelu, round_bf16, tap_pixels,
)

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


class Bf16DecLevel(torch.autograd.Function):
    """One decoder level at bf16: ``(x_out, post, prior, masked)`` from
    ``x``, ``acts``, ``macts``, the level's ``eps`` and weights (one level of
    each stack, :data:`NAMES` order). Saved: the inputs and the twelve h
    saves rounded to bf16; the backward is the Pallas kernel's, u, z and the
    raw scale rebuilt from the saves."""

    @staticmethod
    def forward(ctx, ld: int, k: int, x, acts, macts, eps, *ws):
        w = dict(zip(NAMES, ws))
        blk = lambda tag: {n: w[f"{tag}_{n}"] for n in bc.NAMES}
        *ph, post = bf16_sub_fwd(torch.cat([x, acts], -1), blk("p"), k)
        *mh, masked = bf16_sub_fwd(torch.cat([x, macts], -1), blk("m"), k)
        *qh, q = bf16_sub_fwd(x, blk("q"), k)
        z = post[..., :ld] + softplus_scale(post[..., ld:]) * eps
        u = x + q[..., 2 * ld:] + z @ w["wz"] + w["bz"]
        *rh, r4 = bf16_sub_fwd(u, blk("r"), k)
        ctx.ld, ctx.k = ld, k
        ctx.save_for_backward(x, acts, macts, eps,
                              *(round_bf16(t) for t in (*ph, *mh, *qh, *rh)), *ws)
        return u + r4, post, q[..., :2 * ld], masked

    @staticmethod
    def backward(ctx, gx, gpost, gprior, gmask):
        x, acts, macts, eps, *rest = ctx.saved_tensors
        dx, dacts, dmacts, grads = bf16_level_bwd(
            x, acts, macts, eps, rest[:12], dict(zip(NAMES, rest[12:])),
            (gx, gpost, gprior, gmask), ctx.ld, ctx.k)
        return (None, None, dx, dacts, dmacts, None, *(grads[n] for n in NAMES))


def bf16_level_bwd(x, acts, macts, eps, saves, w: Weights, cots, ld: int, k: int):
    """The backward of one bf16 decoder level (``_bwd_kernel_factory``'s
    body, :330-378) from its input ``x``, ``acts``, ``macts``, ``eps``, its
    twelve saves rounded to bf16 (:data:`SAVES` order), one level of each
    weight stack and the cotangents ``(gx, gpost, gprior, gmask)`` of its
    outputs: ``(dx, dacts, dmacts, weight gradients)``."""
    gx, gpost, gprior, gmask = cots
    saves = dict(zip(TAGS, (tuple(saves[3 * i:3 * i + 3]) for i in range(4))))
    blk = lambda tag: {n: w[f"{tag}_{n}"] for n in bc.NAMES}
    c = x.shape[-1]
    # u, z and the raw scale from the rounded saves (_recompute_uz)
    tail = (gelu(saves["q"][2]) @ w["q_w4"] + w["q_b4"])[..., 2 * ld:]
    post = gelu(saves["p"][2]) @ w["p_w4"] + w["p_b4"]
    raw = post[..., ld:]
    z = post[..., :ld] + softplus_scale(raw) * eps
    u = x + tail + z @ w["wz"] + w["bz"]

    din_r, grads_r = bf16_sub_bwd(u, saves["r"], blk("r"), gx, k)
    du = gx + din_r
    dz = du @ w["wz"].T
    draw = dz * eps * torch.sigmoid(raw)
    din_p, grads_p = bf16_sub_bwd(torch.cat([x, acts], -1), saves["p"], blk("p"),
                                  gpost + torch.cat([dz, draw], -1), k)
    din_m, grads_m = bf16_sub_bwd(torch.cat([x, macts], -1), saves["m"], blk("m"), gmask, k)
    din_q, grads_q = bf16_sub_bwd(x, saves["q"], blk("q"), torch.cat([gprior, du], -1), k)
    grads = {f"{tag}_{n}": g[n] for tag, g in zip(TAGS, (grads_p, grads_m, grads_q, grads_r))
             for n in bc.NAMES}
    grads["wz"] = z.reshape(-1, ld).T @ du.reshape(-1, c)
    grads["bz"] = du.reshape(-1, c).sum(0, keepdim=True)
    return du + din_p[..., :c] + din_q, din_p[..., c:], din_m[..., c:], grads


def bf16_dec_chain_bwd(x0, acts, macts, eps, xout, saves, weights: Weights, cots,
                       *, ld: int, k: int):
    """The backward of a bf16 run from given forward saves: ``x0``,
    ``acts``, ``macts`` ``[B, H, W, C]``, ``eps [L, B, H, W, ld]``, every
    level's output ``xout [L, B, H, W, C]``, the twelve saves (each ``[L,
    B, H, W, mid]``, rounded to bf16, :data:`SAVES` order) and the
    cotangents ``(g, gpost, gprior, gmask)`` of :func:`dec_chain_plain`'s
    outputs. Returns ``dx0``, ``dacts``, ``dmacts`` and the stacked weight
    gradients: :class:`Bf16DecLevel`'s backward level by level, which, fed
    the kernel's forward saves, is the plain version of the backward kernel
    alone."""
    g, gpost, gprior, gmask = cots
    d, dacts, dmacts, grads = g, 0.0, 0.0, {n: [] for n in NAMES}
    for lvl in reversed(range(eps.shape[0])):
        x_in = xout[lvl - 1] if lvl else x0
        d, da, dm, gl = bf16_level_bwd(
            x_in, acts, macts, eps[lvl], [s[lvl] for s in saves],
            {n: weights[n][lvl] for n in NAMES}, (d, gpost[lvl], gprior[lvl], gmask[lvl]),
            ld, k)
        dacts, dmacts = dacts + da, dmacts + dm
        for n in NAMES:
            grads[n].insert(0, gl[n])
    return d, dacts, dmacts, {n: torch.stack(v) for n, v in grads.items()}


def dec_chain_plain(x0: torch.Tensor, acts: torch.Tensor, macts: torch.Tensor,
                    eps: torch.Tensor, weights: Weights, *, ld: int, k: int,
                    compute_dtype=torch.float32):
    """L decoder blocks in plain PyTorch: ``x0``, ``acts``, ``macts``
    ``[B, H, W, C]``, ``eps [L, B, H, W, ld]``, ``weights`` stacked as
    :func:`weight_shapes` says. Returns ``(x_final [B, H, W, C], post [L, B,
    H, W, 2 ld], prior [L, B, H, W, 2 ld], masked [L, B, H, W, ld + tril])``
    (``_fwd_kernel_factory``, :233-286). In bf16 one :class:`Bf16DecLevel`
    a level."""
    _build.bf16_build("decoder_chain", compute_dtype)   # float32 or bfloat16 only
    x, post, prior, masked = x0, [], [], []
    for lvl in range(eps.shape[0]):
        if compute_dtype == torch.bfloat16:
            x, p, q, m = Bf16DecLevel.apply(ld, k, x, acts, macts, eps[lvl],
                                            *(weights[n][lvl] for n in NAMES))
            post.append(p)
            prior.append(q)
            masked.append(m)
            continue
        p = _block(weights, "p", lvl, torch.cat([x, acts], -1), k)
        masked.append(_block(weights, "m", lvl, torch.cat([x.detach(), macts], -1), k))
        q = _block(weights, "q", lvl, x, k)
        z = p[..., :ld] + softplus_scale(p[..., ld:]) * eps[lvl]
        u = x + q[..., 2 * ld:] + z @ weights["wz"][lvl] + weights["bz"][lvl]
        x = u + _block(weights, "r", lvl, u, k)
        post.append(p)
        prior.append(q[..., :2 * ld])
    return x, torch.stack(post), torch.stack(prior), torch.stack(masked)


def dec_chain_supported(batch: int, h: int, w: int, compute_dtype=torch.float32) -> bool:
    """Whether a run is fused: its rows fill the TPU kernel's sublane tiles,
    whose saves ride the compute dtype: 8 rows in float32, 16 in bf16
    (``decoder_chain.py:663-665``), so that the port fuses exactly the runs
    the JAX package fuses."""
    return bc.chain_supported(batch, h, w, compute_dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

# Argument order of the C entry points (csrc/decoder_chain_{fwd,bwd}.cu).
_GEOMETRY = ("L", "B", "H", "W", "C", "M", "K", "BF", "LD")
_FWD_PTRS = ("x0", "acts", "macts", "eps", *NAMES, "xout", "post", "prior", "masked", "u",
             *SAVES)
_BWD_PTRS = ("g", "gpost", "gprior", "gmask", "x0", "acts", "macts", "eps", "xout", "post",
             "u", *SAVES, *NAMES, "dx0", "dacts", "dmacts", *("d" + n for n in NAMES),
             "dxs", "dus", "dpost", "zs", *("d" + s for s in SAVES), "part")
# what the backward needs of the forward's inputs and outputs (the bf16
# backward rebuilds u and post from the saves into scratch of its own)
_SAVED = ("x0", "acts", "macts", "eps", "xout", "post", "u", *SAVES)
_SAVED_BF16 = tuple(n for n in _SAVED if n not in ("post", "u"))
# the stacks of the compute dtype: c1..c3's weights
_CDT_WEIGHTS = tuple(f"{t}_w{i}" for t in TAGS for i in (1, 2, 3))


class DecConfig:
    """Static geometry of one run, shared by its forward and backward."""

    def __init__(self, x0: torch.Tensor, acts: torch.Tensor, n_levels: int, mid: int,
                 ld: int, k: int, compute_dtype=torch.float32):
        self.b, self.h, self.w, self.c = x0.shape
        self.n_levels, self.mid, self.ld, self.k = n_levels, mid, ld, k
        self.fwd_lib = _build.bf16_build("decoder_chain_fwd", compute_dtype)
        self.bwd_lib = _build.bf16_build("decoder_chain_bwd", compute_dtype)
        self.bf16 = compute_dtype == torch.bfloat16
        self.cdtype = torch.bfloat16 if self.bf16 else torch.float32
        self.saved = _SAVED_BF16 if self.bf16 else _SAVED
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
                "M": self.mid, "K": self.k, "BF": int(self.bf16), "LD": self.ld}
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

    def dtype_of(self, name: str) -> torch.dtype:
        """The dtype the kernels take for tensor ``name``: c1..c3's weights
        and the h saves are of the compute dtype."""
        return self.cdtype if name in _CDT_WEIGHTS or name in SAVES else torch.float32


def _launch(lib_name: str, fn: str, names: Sequence[str],
            tensors: Dict[str, torch.Tensor], cfg: DecConfig, device):
    if lib_name.endswith("_fwd_bf16"):
        names = (*names, "hs")   # the bf16 build's float32 scratch
    ptrs = (ctypes.c_void_p * len(names))(*[tensors[n].data_ptr() for n in names])
    lib = _build.load_fn(lib_name, fn, [_build.P, _build.I, _build.P, _build.I, _build.P])
    stream = torch.cuda.current_stream(device).cuda_stream
    return lib, getattr(lib, fn)(ptrs, len(names), cfg.ints(), len(_GEOMETRY), stream)


def _part_floats(cfg: DecConfig) -> int:
    """Floats of the backward's ``part`` scratch, as the kernel reports it."""
    fn = _build.load(cfg.bwd_lib).pm_decoder_chain_bwd_part_floats
    fn.argtypes, fn.restype = [_build.P, _build.I], ctypes.c_longlong
    n = fn(cfg.ints(), len(_GEOMETRY))
    if n < 0:
        raise ValueError("decoder_chain_bwd refuses this geometry")
    return n


def _check_all(tensors: Dict[str, torch.Tensor], shapes: Dict[str, Tuple[int, ...]],
               cfg: DecConfig):
    for name, shape in shapes.items():
        t = tensors.get(name)
        if t is None:
            raise ValueError(f"{name}: missing")
        if t.device.type != "cuda":
            raise ValueError(f"{name}: the kernels take CUDA tensors, got {t.device}")
        if _build.check(name, t, shape, cfg.dtype_of(name)) % 16:
            raise ValueError(f"{name}: the kernels need 16-byte aligned tensors")


class _DecFwd:
    """Wrapper of ``csrc/decoder_chain_fwd.cu``: one call runs a whole run
    (9 kernels per level on one stream) and counts as one launch."""

    def __init__(self):
        self.launches = 0

    def __call__(self, cfg: DecConfig, inputs: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        shapes = cfg.shapes()
        _check_all(inputs, {n: shapes[n] for n in ("x0", "acts", "macts", "eps", *NAMES)}, cfg)
        dev = inputs["x0"].device
        out = {n: torch.empty(shapes[n], device=dev, dtype=cfg.dtype_of(n))
               for n in ("xout", "post", "prior", "masked", "u", *SAVES)}
        scratch = ({"hs": torch.empty(12, cfg.rows, cfg.mid, device=dev)}
                   if cfg.fwd_lib.endswith("_bf16") else {})   # the bf16 build's scratch
        lib, err = _launch(cfg.fwd_lib, "pm_decoder_chain_fwd", _FWD_PTRS,
                           {**inputs, **out, **scratch}, cfg, dev)
        self.launches += 1
        _build.raise_on(lib, err, cfg.fwd_lib)
        return out


class _DecBwd:
    """Wrapper of ``csrc/decoder_chain_bwd.cu``: one call is a whole run's
    VJP and counts as one launch. ``cots`` holds the cotangents ``g``,
    ``gpost``, ``gprior`` and ``gmask``; ``saved`` the tensors of
    ``cfg.saved``."""

    def __init__(self):
        self.launches = 0

    def __call__(self, cfg: DecConfig, cots: Dict[str, torch.Tensor],
                 saved: Dict[str, torch.Tensor], w: Weights) -> Dict[str, torch.Tensor]:
        shapes = cfg.shapes()
        L, R, c, m, ld = cfg.n_levels, cfg.rows, cfg.c, cfg.mid, cfg.ld
        cot_shapes = {"g": shapes["x0"], "gpost": shapes["post"],
                      "gprior": shapes["prior"], "gmask": shapes["masked"]}
        dev = cots["g"].device
        empty = lambda *s: torch.empty(s, device=dev)
        t = {**cots, **saved, **w}
        if cfg.bf16:
            # the bf16 build rebuilds each level's post and u here
            t.update(post=empty(*shapes["post"]), u=empty(*shapes["u"]))
        _check_all(t, {**cot_shapes, **{n: shapes[n] for n in (*_SAVED, *NAMES)}}, cfg)
        grads = {"dx0": empty(R, c), "dacts": empty(R, c), "dmacts": empty(R, c)}
        grads.update({"d" + n: empty(*shapes[n]) for n in NAMES})
        scratch = {"dxs": empty(L, R, c), "dus": empty(L, R, c), "dpost": empty(L, R, 2 * ld),
                   "zs": empty(L, R, ld), "part": empty(_part_floats(cfg))}
        scratch.update({"d" + s: empty(L, R, m) for s in SAVES})
        lib, err = _launch(cfg.bwd_lib, "pm_decoder_chain_bwd", _BWD_PTRS,
                           {**t, **grads, **scratch}, cfg, dev)
        self.launches += 1
        _build.raise_on(lib, err, cfg.bwd_lib)
        return grads


# the float32 builds' wrappers and the bf16 builds', each with its count
dec_fwd = _DecFwd()
dec_bwd = _DecBwd()
dec_fwd_bf16 = _DecFwd()
dec_bwd_bf16 = _DecBwd()


class DecChain(torch.autograd.Function):
    """A run whose forward and backward are the hand-written kernels, on
    flat ``[rows, cols]`` tensors. Outputs: ``x_final [R, C]``, ``post``,
    ``prior``, ``masked`` ``[L, R, cols]``. The backward takes a cotangent
    of each (zeros for an output no loss used) and gives ``eps`` no
    gradient."""

    @staticmethod
    def forward(ctx, cfg: DecConfig, x0, acts, macts, eps, *ws):
        # c1..c3's weights cast to the compute dtype here, inside the
        # Function, so that their float32 gradients reach the float32
        # weights unrounded
        ws = [t.to(cfg.dtype_of(n)) for n, t in zip(NAMES, ws)]
        w = dict(zip(NAMES, ws))
        out = (dec_fwd_bf16 if cfg.bf16 else dec_fwd)(
            cfg, {"x0": x0, "acts": acts, "macts": macts, "eps": eps, **w})
        ctx.cfg = cfg
        keep = {"x0": x0, "acts": acts, "macts": macts, "eps": eps, **out}
        ctx.save_for_backward(*(keep[n] for n in cfg.saved), *ws)
        return out["xout"][-1], out["post"], out["prior"], out["masked"]

    @staticmethod
    def backward(ctx, gx, gpost, gprior, gmask):
        # an output no loss used arrives as zeros (autograd materialises
        # them: ctx.materialize_grads is on by default)
        saved, names = ctx.saved_tensors, ctx.cfg.saved
        keep = dict(zip(names, saved[:len(names)]))
        w = dict(zip(NAMES, saved[len(names):]))
        cots = {"g": gx.contiguous(), "gpost": gpost.contiguous(),
                "gprior": gprior.contiguous(), "gmask": gmask.contiguous()}
        grads = (dec_bwd_bf16 if ctx.cfg.bf16 else dec_bwd)(ctx.cfg, cots, keep, w)
        return (None, grads["dx0"], grads["dacts"], grads["dmacts"], None,
                *(grads["d" + n] for n in NAMES))


def dec_chain(x0: torch.Tensor, acts: torch.Tensor, macts: torch.Tensor, eps: torch.Tensor,
              weights: Weights, *, mid: int, ld: int, k: int, compute_dtype=torch.float32):
    """One run of L decoder blocks (the arguments and results of
    :func:`dec_chain_plain`; ``mid`` is c1..c3's width): the plain version
    for CPU tensors, the kernels (:class:`DecChain`) for CUDA tensors. In
    bf16 c1..c3's weights are cast to bf16 as the JAX wrapper does
    (``decoder_chain.py:648-652``); their gradients come back in float32."""
    if _build.on_cpu([x0, acts, macts, eps, *weights.values()]):
        if weights["p_w1"].shape[-1] != mid:
            raise ValueError(f"p_w1 has {weights['p_w1'].shape[-1]} columns, mid is {mid}")
        return dec_chain_plain(x0, acts, macts, eps, weights, ld=ld, k=k,
                               compute_dtype=compute_dtype)
    L, (b, h, w_, c) = eps.shape[0], x0.shape
    cfg = DecConfig(x0, acts, L, mid, ld, k, compute_dtype)
    flat = lambda t: t.reshape(b * h * w_, t.shape[-1]).contiguous()
    x_final, post, prior, masked = DecChain.apply(
        cfg, flat(x0), flat(acts), flat(macts), eps.reshape(L, b * h * w_, ld).contiguous(),
        *[weights[n].contiguous() for n in NAMES])
    shape5 = lambda t: t.reshape(L, b, h, w_, t.shape[-1])
    return x_final.reshape(b, h, w_, c), shape5(post), shape5(prior), shape5(masked)

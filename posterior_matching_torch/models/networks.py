"""Backbone networks: Dense, the conv encoder and decoder, the residual MLP.

Counterpart of ``posterior_matching_tpu/models/networks.py:17-184``.
Parameters keep flax's names and layouts (``Dense_<i>`` / ``Conv_<i>`` /
``ConvTranspose_<i>`` holding ``kernel`` ``[in, out]`` or ``[k, k, in, out]``
and ``bias``), so a state-dict name is the JAX tree path joined by dots.
Flax infers a layer's input width at its first call; here each network is
built from its input shape and reports ``out_shape``.

Conv networks take and return NHWC tensors, as the JAX package does. A
transposed convolution is flax's ``ConvTranspose``
(``transpose_kernel=False``): a correlation of the zero-inserted input with
the kernel as stored, padded as ``lax.conv_transpose`` pads it
(:func:`conv_transpose_padding`, which may differ at the two ends: SAME's
(3, 2) for k = 5, s = 2). Each convolution is an im2col and one float32
GEMM (:func:`correlate`), not cuDNN: for these 5x5 layers cuDNN picks
Winograd and FFT algorithms, whose weight gradients on an H100 were about
1e-3 of their scale off the CPU's (``tests/test_torch_pm_vae_gpu.py``),
where the GEMM's are within a few 1e-6.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _trunc_normal_fan_in(shape: Sequence[int]) -> torch.Tensor:
    """Truncated normal in [-2, 2] scaled by 1/sqrt(fan_in), where fan_in is
    the product of every axis but the last (the haiku default)."""
    fan_in = math.prod(shape[:-1])
    out = torch.empty(tuple(shape))
    nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0)
    return out / math.sqrt(fan_in)


class Dense(nn.Module):
    """``x @ kernel + bias`` with a flax-layout ``[in, out]`` kernel."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(
            _trunc_normal_fan_in((in_features, out_features))
        )
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


# ---------------------------------------------------------------------------
# Convolutions with flax's padding rules
# ---------------------------------------------------------------------------


def same_padding(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA ``SAME`` padding (low, high) of a convolution along one
    axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv_transpose_padding(k: int, s: int, padding: str = "SAME") -> Tuple[int, int]:
    """``lax.conv_transpose``'s padding (low, high) of the zero-inserted
    input (``jax._src.lax.convolution._conv_transpose_padding``)."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else math.ceil(pad_len / 2)
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    else:
        raise ValueError(f"unknown padding {padding!r}")
    return pad_a, pad_len - pad_a


def conv_transpose_size(size: int, k: int, s: int, padding: str) -> int:
    """The output length of a transposed convolution along one axis."""
    lo, hi = conv_transpose_padding(k, s, padding)
    return (size - 1) * s + 1 + lo + hi - k + 1


def correlate(x: torch.Tensor, kernel: torch.Tensor, stride: int,
              pads: Tuple[Tuple[int, int], Tuple[int, int]]) -> torch.Tensor:
    """XLA's convolution (a correlation) of NHWC ``x`` with a flax kernel
    ``[k, k, in, out]``, padded by ``pads`` ((low, high) along H, then W),
    as an im2col of strided views (one copy) and one float32 GEMM."""
    k = kernel.shape[0]
    x = F.pad(x, (0, 0, pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
    cols = x.unfold(1, k, stride).unfold(2, k, stride)          # [B, Ho, Wo, C, k, k]
    b, ho, wo = cols.shape[:3]
    w = kernel.permute(2, 0, 1, 3).reshape(-1, kernel.shape[-1])  # [C k k, out]
    return (cols.reshape(b * ho * wo, -1) @ w).reshape(b, ho, wo, -1)


class Conv(nn.Module):
    """flax ``nn.Conv`` (``"SAME"`` or ``"VALID"``) on NHWC tensors, with
    flax's ``kernel [k, k, in, out]`` and ``bias [out]``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: str = "SAME"):
        super().__init__()
        self.k, self.stride, self.padding = k, stride, padding
        self.kernel = nn.Parameter(_trunc_normal_fan_in((k, k, cin, cout)))
        self.bias = nn.Parameter(torch.zeros(cout))

    def out_size(self, size: int) -> int:
        if self.padding == "SAME":
            return -(-size // self.stride)
        return (size - self.k) // self.stride + 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == "VALID":
            pads = ((0, 0), (0, 0))
        else:
            pads = tuple(same_padding(n, self.k, self.stride) for n in x.shape[1:3])
        return correlate(x, self.kernel, self.stride, pads) + self.bias


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose`` (``transpose_kernel=False``, ``"SAME"`` or
    ``"VALID"``) on NHWC tensors, with flax's ``kernel [k, k, in, out]``:
    the input with ``stride - 1`` zeros between its pixels, padded as
    :func:`conv_transpose_padding` says, correlated with the kernel."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: str = "SAME"):
        super().__init__()
        self.k, self.stride, self.padding = k, stride, padding
        self.pads = conv_transpose_padding(k, stride, padding)
        self.kernel = nn.Parameter(_trunc_normal_fan_in((k, k, cin, cout)))
        self.bias = nn.Parameter(torch.zeros(cout))

    def out_size(self, size: int) -> int:
        return conv_transpose_size(size, self.k, self.stride, self.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.stride
        if s > 1:
            b, h, w, c = x.shape
            spread = x.new_zeros(b, (h - 1) * s + 1, (w - 1) * s + 1, c)
            spread[:, ::s, ::s] = x
            x = spread
        return correlate(x, self.kernel, 1, (self.pads, self.pads)) + self.bias


# ---------------------------------------------------------------------------
# The networks
# ---------------------------------------------------------------------------


def dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout`` while training: each entry kept with probability
    ``1 - rate`` (drawn from ``gen``) and scaled by its inverse."""
    if rate == 0.0:
        return x
    if gen is None:
        raise ValueError("dropout while training needs a generator")
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    kept = torch.rand(x.shape, generator=gen, device=gen.device).to(x.device) < keep
    return torch.where(kept, x / keep, torch.zeros_like(x))


class ConvEncoder(nn.Module):
    """Strided convs, ``SAME`` but the last ``VALID``, leaky ReLU after
    every layer (``networks.py:32-52``). ``in_shape`` is ``(H, W, C)``."""

    def __init__(self, conv_layers: Sequence[Sequence[int]], in_shape: Sequence[int]):
        super().__init__()
        h, w, c = in_shape
        n = len(conv_layers)
        self.names = []
        for i, (filters, kernel, stride) in enumerate(conv_layers):
            conv = Conv(c, filters, kernel, stride, "VALID" if i == n - 1 else "SAME")
            self.add_module(f"Conv_{i}", conv)
            self.names.append(f"Conv_{i}")
            h, w, c = conv.out_size(h), conv.out_size(w), filters
        self.out_shape = (h, w, c)

    def forward(self, x: torch.Tensor, training: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        if x.ndim != 4:
            raise ValueError(f"expected rank-4 input, got {tuple(x.shape)}")
        h = x
        for name in self.names:
            h = F.leaky_relu(getattr(self, name)(h))
        return h


class ConvDecoder(nn.Module):
    """Transposed convs from a ``[B, Z]`` latent taken as a 1x1 image,
    ``VALID`` first and ``SAME`` after, leaky ReLU after every layer, the
    last one too (``networks.py:55-75``)."""

    def __init__(self, conv_layers: Sequence[Sequence[int]], in_shape: Sequence[int]):
        super().__init__()
        (c,) = in_shape
        h = 1
        self.names = []
        for i, (filters, kernel, stride) in enumerate(conv_layers):
            conv = ConvTranspose(c, filters, kernel, stride, "VALID" if i == 0 else "SAME")
            self.add_module(f"ConvTranspose_{i}", conv)
            self.names.append(f"ConvTranspose_{i}")
            h, c = conv.out_size(h), filters
        self.out_shape = (h, h, c)

    def forward(self, x: torch.Tensor, training: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        if x.ndim != 2:
            raise ValueError(f"expected rank-2 input, got {tuple(x.shape)}")
        h = x[:, None, None, :]
        for name in self.names:
            h = F.leaky_relu(getattr(self, name)(h))
        return h


class ResidualMLP(nn.Module):
    """Dense, then residual blocks ``act -> Dense -> act -> dropout ->
    Dense``, LayerNorm (no scale or offset, eps 1e-6) after each Dense when
    asked, and a final activation (``networks.py:78-109``)."""

    def __init__(self, in_shape: Sequence[int], residual_blocks: int = 2,
                 hidden_units: int = 256, activation: Callable = F.relu,
                 activate_final: bool = True, dropout: float = 0.0, layer_norm: bool = False):
        super().__init__()
        (d,) = in_shape
        self.blocks, self.hidden = residual_blocks, hidden_units
        self.activation, self.activate_final = activation, activate_final
        self.rate, self.layer_norm = float(dropout), layer_norm
        self.Dense_0 = Dense(d, hidden_units)
        for i in range(1, 2 * residual_blocks + 1):
            self.add_module(f"Dense_{i}", Dense(hidden_units, hidden_units))
        self.out_shape = (hidden_units,)

    def _ln(self, h: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(h, (self.hidden,), eps=1e-6) if self.layer_norm else h

    def forward(self, x: torch.Tensor, training: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        if x.ndim != 2:
            raise ValueError(f"expected rank-2 input, got {tuple(x.shape)}")
        act = self.activation
        h = self._ln(self.Dense_0(x))
        for i in range(self.blocks):
            res = self._ln(getattr(self, f"Dense_{2 * i + 1}")(act(h)))
            res = act(res)
            if training:
                res = dropout(res, self.rate, gen)
            h = h + self._ln(getattr(self, f"Dense_{2 * i + 2}")(res))
        return act(h) if self.activate_final else h


_NETWORKS = {"ConvEncoder": ConvEncoder, "ConvDecoder": ConvDecoder,
             "ResidualMLP": ResidualMLP}


def get_network(network_type: str, network_config: Optional[Dict[str, Any]],
                in_shape: Sequence[int]) -> nn.Module:
    """A network by the reference's registry name (``networks.py:
    112-132``), built for inputs of shape ``in_shape`` (no batch axis)."""
    if network_type not in _NETWORKS:
        raise NotImplementedError(f"network {network_type!r} is not ported")
    return _NETWORKS[network_type](in_shape=tuple(in_shape), **dict(network_config or {}))


# ---------------------------------------------------------------------------
# The explicit-parameter MLP that the autoregressive GMM carries
# ---------------------------------------------------------------------------


def pure_residual_mlp_params(module: nn.Module, in_dim: int, hidden_units: int,
                             residual_blocks: int, out_dim: int, name: str):
    """Registers a ResidualMLP's and its output Dense's parameters on
    ``module`` as ``<name>_<layer>_w`` / ``_b`` (``networks.py:143-166``)
    and returns them as a tree (``<layer>`` is ``in``, ``block<i>_a``,
    ``block<i>_b`` or ``out``)."""

    def dense(pname, nin, nout):
        w = nn.Parameter(_trunc_normal_fan_in((nin, nout)))
        b = nn.Parameter(torch.zeros(nout))
        module.register_parameter(f"{name}_{pname}_w", w)
        module.register_parameter(f"{name}_{pname}_b", b)
        return {"w": w, "b": b}

    params = {"in": dense("in", in_dim, hidden_units), "blocks": []}
    for i in range(residual_blocks):
        params["blocks"].append({
            "a": dense(f"block{i}_a", hidden_units, hidden_units),
            "b": dense(f"block{i}_b", hidden_units, hidden_units),
        })
    params["out"] = dense("out", hidden_units, out_dim)
    return params


def pure_residual_mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    """The ReLU residual MLP (``activate_final``) and its output Dense
    (``networks.py:169-184``)."""
    dense = lambda p, h: h @ p["w"] + p["b"]
    h = dense(params["in"], x)
    for blk in params["blocks"]:
        h = h + dense(blk["b"], F.relu(dense(blk["a"], F.relu(h))))
    return dense(params["out"], F.relu(h))

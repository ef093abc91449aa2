"""Conditional gated PixelCNN: the parameters and their configuration.

Counterpart of ``posterior_matching_tpu/models/pixelcnn.py::PixelCNN``. The
parameters keep their flax names (``v_init``, ``h_init_up``, ``h_init_left``,
``{up,dn}_0_{r}_{vertical,horizontal}_{conv_a,conv_b,aux,cond_proj}``,
``embed``, ``logits_conv``) and flax layouts (conv kernels HWIO, dense
kernels ``[in, out]``), which are what the sampler's fused weight stacks are
cut from. Only the flat topology (``num_hierarchies == 1``, the setting of
every shipped config) is ported.

:meth:`PixelCNN.forward` and :meth:`PixelCNN.log_prob` are the fused flat
path of the JAX module (``models/pixelcnn.py:559-596, 668-685``): the
embedding, the statically sliced ``v_init`` / ``h_init_up`` /
``h_init_left`` convs (``F.conv2d``, which the JAX package leaves to XLA),
then the up and the down pass of the gated chain (:mod:`posterior_matching_
torch.ops.gated_chain`: the hand-written kernels on the GPU) and the float32
1x1 logits head. ``chain_segment`` chooses the chain's granularity, as
``PM_TPU_CHAIN_SEGMENT`` does in the JAX package (``pixelcnn.py:410-495``):
``"stream"`` (the default) runs each pass as one launch of the stream
kernels, ``1`` each level through the pair kernels, an integer ``L``
segments of ``L`` levels (the last one shorter where ``L`` does not divide
``num_resnet``). All three realise the same dropout masks and, in float32,
the same outputs. It is an execution option, never a key of a config file.
A conv kernel's masked-out taps never enter the graph, so their gradients
are exactly zero. Sampling is :mod:`posterior_matching_torch.ops.
sampler_chain`.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from posterior_matching_torch.models.networks import _trunc_normal_fan_in
from posterior_matching_torch.ops.gated_chain import (
    chain_taps,
    gated_pair,
    gated_segment,
    gated_stream,
    pack_level,
    stack_levels,
)


def _masked_conv(x: torch.Tensor, layer: "KernelBias", kernel_size,
                 valid_rows, valid_cols) -> torch.Tensor:
    """The JAX ``_MaskedConv``'s stride-1 path on NHWC ``x``: the kernel
    sliced to its valid taps, convolved with the SAME padding shifted by
    the slice (negative padding crops)."""
    kh, kw = kernel_size
    (r0, r1), (c0, c1) = valid_rows, valid_cols
    pads = (kw // 2 - c0, (c1 - 1) - kw // 2, kh // 2 - r0, (r1 - 1) - kh // 2)
    w = layer.kernel[r0:r1, c0:c1].permute(3, 2, 0, 1)
    out = F.conv2d(F.pad(x.permute(0, 3, 1, 2), pads), w, layer.bias)
    return out.permute(0, 2, 3, 1)


class KernelBias(nn.Module):
    """A flax ``kernel`` / ``bias`` pair."""

    def __init__(self, kernel_shape: Tuple[int, ...], init_std: Optional[float] = None):
        super().__init__()
        if init_std is None:
            kernel = _trunc_normal_fan_in(kernel_shape)
        else:
            kernel = init_std * torch.randn(kernel_shape)
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(torch.zeros(kernel_shape[-1]))


class PixelCNN(nn.Module):
    def __init__(
        self,
        num_indices: int,
        image_shape: Tuple[int, int],
        dropout: float = 0.5,
        num_resnet: int = 15,
        num_hierarchies: int = 1,
        num_filters: int = 128,
        receptive_field_dims: Tuple[int, int] = (3, 3),
        conditional_dim: Optional[int] = None,
        chain_segment: Union[str, int] = "stream",
    ):
        super().__init__()
        if num_hierarchies != 1:
            raise ValueError("the port supports num_hierarchies == 1 only")
        self.chain_segment = chain_segment
        self.num_indices = num_indices
        self.image_shape = tuple(image_shape)
        self.dropout = dropout
        self.num_resnet = num_resnet
        self.num_hierarchies = num_hierarchies
        self.num_filters = num_filters
        self.receptive_field_dims = tuple(receptive_field_dims)
        self.conditional_dim = conditional_dim

        f = num_filters
        rows, cols = self.receptive_field_dims
        ksizes = {"vertical": (2 * rows - 3, cols), "horizontal": (3, cols)}
        self.embed = nn.Parameter(
            torch.randn(num_indices, f) / f ** 0.5
        )
        layers = {
            "v_init": KernelBias((2 * rows - 1, cols, f, f)),
            "h_init_up": KernelBias((3, cols, f, f)),
            "h_init_left": KernelBias((3, cols, f, f)),
            "logits_conv": KernelBias((1, 1, f, num_indices)),
        }
        for d in ("up", "dn"):
            for r in range(num_resnet):
                for stack in ("vertical", "horizontal"):
                    tag = f"{d}_0_{r}_{stack}"
                    kh, kw = ksizes[stack]
                    layers[f"{tag}_conv_a"] = KernelBias((kh, kw, 2 * f, f))
                    layers[f"{tag}_conv_b"] = KernelBias((kh, kw, 2 * f, 2 * f))
                    if conditional_dim is not None:
                        layers[f"{tag}_cond_proj"] = KernelBias(
                            (conditional_dim, 2 * f), init_std=1.0
                        )
                    # aux cue: up horizontal <- new vertical (F);
                    # down vertical <- skip (F); down horizontal <- (W, skip)
                    aux_in = {
                        ("up", "horizontal"): f,
                        ("dn", "vertical"): f,
                        ("dn", "horizontal"): 2 * f,
                    }.get((d, stack))
                    if aux_in is not None:
                        layers[f"{tag}_aux"] = KernelBias((2 * aux_in, f))
        self.layers = nn.ModuleDict(layers)

    def forward(
        self,
        indices: torch.Tensor,
        conditional_input: torch.Tensor,
        training: bool = False,
        seed: int = 0,
    ) -> torch.Tensor:
        """``[B, H, W]`` codes and ``[B, D]`` conditions -> ``[B, H, W, K]``
        float32 logits. With ``training`` and ``dropout > 0`` the chain's
        dropout masks are the hash masks of ``seed``."""
        if conditional_input is None:
            raise ValueError("the port's PixelCNN chain needs a condition")
        xv, xh = self.init_stacks(indices)
        x_final = self._chain(xv, xh, conditional_input.reshape(indices.shape[0], -1),
                              training, seed)
        lw = self.layers["logits_conv"]
        return (F.elu(x_final) @ lw.kernel[0, 0] + lw.bias).float()

    def init_stacks(self, indices: torch.Tensor):
        """The chain's inputs: ``v_init`` and ``h_init_up + h_init_left`` of
        the codes' embedding, ``[B, H, W, F]`` each."""
        rows, cols = self.receptive_field_dims
        layers = self.layers
        h0 = self.embed[indices.long()]
        v_init = _masked_conv(h0, layers["v_init"], (2 * rows - 1, cols),
                              (0, rows - 1), (0, cols))
        h_up = _masked_conv(h0, layers["h_init_up"], (3, cols), (0, 1), (0, cols))
        h_left = _masked_conv(h0, layers["h_init_left"], (3, cols), (0, 2),
                              (0, cols // 2))
        return v_init, h_up + h_left

    @property
    def chain_segment(self) -> Union[str, int]:
        return self._chain_segment

    @chain_segment.setter
    def chain_segment(self, value: Union[str, int]):
        if value != "stream" and not (isinstance(value, int) and value >= 1):
            raise ValueError(f"chain_segment is 'stream' or an integer >= 1, got {value!r}")
        self._chain_segment = value

    def _chain(self, xv, xh, cond, training: bool, seed: int) -> torch.Tensor:
        """The up pass, then the down pass with the up outputs as skips in
        reverse (``pixelcnn.py:386-495``): with ``xs = [init] + up outputs``
        down level p takes ``xs[n - 1 - p]``, so the last up output is the
        down pass's carry and never a skip, and the init stacks are the
        last skip. Returns the last horizontal output."""
        n, f = self.num_resnet, self.num_filters
        rf = self.receptive_field_dims
        keep = 1.0 - self.dropout if (training and self.dropout > 0) else 1.0
        common = dict(seed=seed, keep=keep, taps=chain_taps(rf))
        levels = {d: [pack_level(self.layers, d, p, f, d == "dn", rf) for p in range(n)]
                  for d in ("up", "dn")}
        if self.chain_segment == "stream":
            up_v, up_h = gated_stream(xv, xh, None, cond, stack_levels(levels["up"]),
                                      base_pair=0, **common)
            xs_v, xs_h = [xv, *up_v], [xh, *up_h]
            skips = (
                torch.stack([xs_v[n - 1 - p] for p in range(n)]),
                torch.stack([xs_h[n - 1 - p] for p in range(n)]),
            )
            _, dn_h = gated_stream(up_v[-1], up_h[-1], skips, cond,
                                   stack_levels(levels["dn"]), base_pair=n, **common)
            return dn_h[-1]
        seg = self.chain_segment
        xs_v, xs_h = [xv], [xh]
        for d, base in (("up", 0), ("dn", n)):
            for p in range(0, n, seg):
                ws = levels[d][p: p + seg]
                sk = None
                if d == "dn":
                    sk = [(xs_v[n - 1 - q], xs_h[n - 1 - q]) for q in range(p, p + len(ws))]
                if seg == 1:
                    outs = [gated_pair(xv, xh, sk and sk[0], cond, ws[0],
                                       pair_index=base + p, **common)]
                else:
                    outs = gated_segment(xv, xh, sk, cond, ws, base_pair=base + p, **common)
                if d == "up":
                    xs_v += [o[0] for o in outs]
                    xs_h += [o[1] for o in outs]
                xv, xh = outs[-1]
        return xh

    def log_prob(
        self,
        value: torch.Tensor,
        conditional_input: torch.Tensor,
        training: bool = False,
        seed: int = 0,
    ) -> torch.Tensor:
        """Teacher-forced log-likelihood of ``value [B, H, W]``, summed over
        the grid: ``[B]``."""
        logits = self(value, conditional_input, training=training, seed=seed)
        logp = torch.log_softmax(logits, dim=-1)
        lls = torch.gather(logp, -1, value.long()[..., None])[..., 0]
        return lls.sum(dim=tuple(range(1, lls.ndim)))

"""Conditional gated PixelCNN: the parameters and their configuration.

Counterpart of ``posterior_matching_tpu/models/pixelcnn.py::PixelCNN``. The
parameters keep their flax names (``v_init``, ``h_init_up``, ``h_init_left``,
``{up,dn}_0_{r}_{vertical,horizontal}_{conv_a,conv_b,aux,cond_proj}``,
``embed``, ``logits_conv``) and flax layouts (conv kernels HWIO, dense
kernels ``[in, out]``), which are what the sampler's fused weight stacks are
cut from. Only the flat topology (``num_hierarchies == 1``, the setting of
every shipped config) is ported. The full-grid forward and ``log_prob`` come
with the training slice; sampling is :mod:`posterior_matching_torch.ops.
sampler_chain`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from posterior_matching_torch.models.networks import _trunc_normal_fan_in


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
    ):
        super().__init__()
        if num_hierarchies != 1:
            raise ValueError("the port supports num_hierarchies == 1 only")
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

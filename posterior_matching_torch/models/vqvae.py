"""VQ-VAE encode and decode paths and the PM partial encoder.

Counterpart of ``posterior_matching_tpu/models/vqvae.py:33-367``: the
residual conv stacks, ``encode`` and ``encoding_indices`` (the codebook
search is :mod:`posterior_matching_torch.ops.vq`), the quantizer's forward
without its EMA codebook update, the decoder mean, the codebook lookup,
``decode_indices`` and ``VQVAEPartialEncoder``. Public functions take and return NHWC tensors,
as the JAX package does; inside, convolutions run NCHW through
``torch.nn.functional`` (the JAX package leaves them to XLA, outside any
Pallas kernel).

Convolution weights are stored in torch layout. ``convert.py`` maps flax's
HWIO kernels onto them, including the transposed convolutions, whose flax
form (``padding="SAME"``, ``transpose_kernel=False``) is a plain correlation
of the zero-inserted input with the unflipped kernel: that is
``conv_transpose2d`` with the kernel flipped in space and the padding of
:func:`_transpose_padding`.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from posterior_matching_torch.models.networks import Dense
from posterior_matching_torch.ops.vq import (
    nearest_codebook_indices,
    vq_straight_through,
)


def _same_pad(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA ``SAME`` padding (low, high) along one axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _transpose_padding(k: int, s: int) -> int:
    """``conv_transpose2d`` padding equal to ``lax.conv_transpose``'s SAME
    padding (``jax._src.lax.convolution._conv_transpose_padding``)."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else math.ceil(pad_len / 2)
    if pad_len - pad_a != pad_a:
        raise ValueError(f"asymmetric transpose padding for k={k}, s={s}")
    return k - 1 - pad_a


class Conv(nn.Module):
    """flax ``nn.Conv`` (``padding="SAME"``) on NCHW tensors."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__()
        self.k, self.stride = k, stride
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ph = _same_pad(x.shape[2], self.k, self.stride)
        pw = _same_pad(x.shape[3], self.k, self.stride)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(
                x, self.weight, self.bias, self.stride, (ph[0], pw[0])
            )
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, self.weight, self.bias, self.stride)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose`` (``padding="SAME"``,
    ``transpose_kernel=False``) on NCHW tensors. ``weight`` is
    ``[in, out, k, k]``, flipped in space relative to the flax kernel."""

    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        self.stride = stride
        self.padding = _transpose_padding(k, stride)
        self.weight = nn.Parameter(torch.empty(cin, cout, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(
            x, self.weight, self.bias, self.stride, self.padding
        )


class ConvResidualStack(nn.Module):
    """relu -> 3x3 conv -> relu -> 1x1 conv residual blocks."""

    def __init__(self, hidden: int, blocks: int, res_hidden: int):
        super().__init__()
        self.res3x3 = nn.ModuleList(
            Conv(hidden, res_hidden, 3) for _ in range(blocks)
        )
        self.res1x1 = nn.ModuleList(
            Conv(res_hidden, hidden, 1) for _ in range(blocks)
        )

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for c3, c1 in zip(self.res3x3, self.res1x1):
            h = h + c1(F.relu(c3(F.relu(h))))
        return F.relu(h)


class ConvResidualEncoder(nn.Module):
    """Two stride-2 4x4 convs + 3x3 conv + residual stack (downsamples 4x)."""

    def __init__(self, cin: int, hidden: int, blocks: int, res_hidden: int):
        super().__init__()
        self.enc_1 = Conv(cin, hidden // 2, 4, 2)
        self.enc_2 = Conv(hidden // 2, hidden, 4, 2)
        self.enc_3 = Conv(hidden, hidden, 3)
        self.stack = ConvResidualStack(hidden, blocks, res_hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.enc_1(x))
        h = F.relu(self.enc_2(h))
        h = F.relu(self.enc_3(h))
        return self.stack(h)


class ConvResidualDecoder(nn.Module):
    """3x3 conv + residual stack + two stride-2 transposed convs; returns the
    decoder Normal's mean (its scale is not needed for imputation)."""

    def __init__(
        self, cin: int, hidden: int, blocks: int, res_hidden: int, cout: int
    ):
        super().__init__()
        # the decoder Normal's scalar log-scale: unused by the mean, kept so
        # that a checkpoint crosses over whole
        self.log_scale = nn.Parameter(torch.zeros(()))
        self.dec_1 = Conv(cin, hidden, 3)
        self.stack = ConvResidualStack(hidden, blocks, res_hidden)
        self.dec_2 = ConvTranspose(hidden, hidden // 2, 4, 2)
        self.dec_3 = ConvTranspose(hidden // 2, cout, 4, 2)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.stack(self.dec_1(z))
        return self.dec_3(F.relu(self.dec_2(h)))


class VectorQuantizer(nn.Module):
    """The codebook. In the JAX package it lives in the ``vq_ema`` state
    collection, not in ``params`` (the EMA quantizer updates it in place),
    beside the EMA statistics, which are kept here as buffers so that a
    checkpoint crosses over whole. The EMA update itself belongs to stage-1
    training and is not ported yet."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 commitment_cost: float = 0.25):
        super().__init__()
        self.commitment_cost = commitment_cost
        self.embeddings = nn.Parameter(
            torch.zeros(num_embeddings, embedding_dim)
        )
        self.register_buffer("ema_cluster_size", torch.zeros(num_embeddings))
        self.register_buffer(
            "ema_dw", torch.zeros(num_embeddings, embedding_dim)
        )

    def forward(self, z: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``z [..., D]`` -> the straight-through quantization, the
        commitment loss, the codebook perplexity and the indices
        (``vqvae.py:75-87,120-135`` with ``use_ema``, outside training)."""
        flat = z.reshape(-1, z.shape[-1]).contiguous()
        indices = nearest_codebook_indices(flat, self.embeddings)
        quantized = self.embeddings[indices.long()].reshape(z.shape)
        e_latent_loss = ((quantized.detach() - z) ** 2).mean()
        counts = torch.bincount(
            indices.long(), minlength=self.embeddings.shape[0]
        )
        avg_probs = counts.float() / indices.numel()
        perplexity = torch.exp(-(avg_probs * torch.log(avg_probs + 1e-10)).sum())
        return {
            "quantize": vq_straight_through(z, quantized),
            "loss": self.commitment_cost * e_latent_loss,
            "perplexity": perplexity,
            "encoding_indices": indices.reshape(z.shape[:-1]),
        }

    def quantize(self, encoding_indices: torch.Tensor) -> torch.Tensor:
        return self.embeddings[encoding_indices.long()]


class VQVAE(nn.Module):
    """The VQ-VAE's encode and decode paths. The training loss (decoder
    likelihood plus the EMA codebook update) belongs to stage 1."""

    def __init__(
        self,
        output_channels: int = 3,
        embedding_dim: int = 64,
        num_embeddings: int = 512,
        hidden_units: int = 128,
        residual_blocks: int = 2,
        residual_hidden_units: int = 128,
        commitment_cost: float = 0.25,
        **_unused,
    ):
        super().__init__()
        self.encoder = ConvResidualEncoder(
            output_channels, hidden_units, residual_blocks,
            residual_hidden_units,
        )
        self.pre_vq_conv = Conv(hidden_units, embedding_dim, 1)
        self.vq = VectorQuantizer(num_embeddings, embedding_dim, commitment_cost)
        self.decoder = ConvResidualDecoder(
            embedding_dim, hidden_units, residual_blocks,
            residual_hidden_units, output_channels,
        )

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] images -> [B, H/4, W/4, D] pre-quantization latents."""
        z = self.pre_vq_conv(self.encoder(x.permute(0, 3, 1, 2)))
        return z.permute(0, 2, 3, 1)

    def encoding_indices(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] images -> [B, H/4, W/4] int32 codes."""
        return self.vq(self.encode(x))["encoding_indices"]

    def decode_indices(self, encoding_indices: torch.Tensor) -> torch.Tensor:
        """[B, h, w] integer codes -> [B, H, W, C] decoder means."""
        q = self.vq.quantize(encoding_indices).permute(0, 3, 1, 2)
        return self.decoder(q).permute(0, 2, 3, 1)


class VQVAEPartialEncoder(nn.Module):
    """Masked image + mask ``[B, H, W, 2C]`` -> conditioning vector."""

    def __init__(
        self,
        in_channels: int,
        image_hw: Tuple[int, int],
        conditional_dim: int,
        hidden_units: int,
        residual_blocks: int,
        residual_hidden_units: int,
    ):
        super().__init__()
        self.encoder = ConvResidualEncoder(
            in_channels, hidden_units, residual_blocks, residual_hidden_units
        )
        h, w = (-(-image_hw[0] // 4), -(-image_hw[1] // 4))
        self.dense = Dense(h * w * hidden_units, conditional_dim)

    def forward(self, x_o_b: torch.Tensor) -> torch.Tensor:
        h = self.encoder(x_o_b.permute(0, 3, 1, 2))
        # flax flattens NHWC: rows, then columns, then channels
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return self.dense(h)

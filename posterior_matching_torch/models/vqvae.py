"""The VQ-VAE (stage-1 training, encode and decode) and the PM partial
encoder.

Counterpart of ``posterior_matching_tpu/models/vqvae.py:33-367``: the
residual conv stacks, ``encode`` and ``encoding_indices`` (the codebook
search is :mod:`posterior_matching_torch.ops.vq`), the EMA quantizer with
its codebook update, the training forward (the decoder Normal's
reconstruction loss plus the commitment loss), the codebook lookup,
``decode_indices`` and ``VQVAEPartialEncoder``. Public functions take and
return NHWC tensors, as the JAX package does; inside, convolutions run NCHW
through ``torch.nn.functional`` (the JAX package leaves them to XLA, outside
any Pallas kernel).

Convolution weights are stored in torch layout. ``convert.py`` maps flax's
HWIO kernels onto them, including the transposed convolutions, whose flax
form (``padding="SAME"``, ``transpose_kernel=False``) is a plain correlation
of the zero-inserted input with the unflipped kernel: that is
``conv_transpose2d`` with the kernel flipped in space and the padding of
:func:`~posterior_matching_torch.models.networks.conv_transpose_padding`
(shared with the PM-VAE decoder, whose padding differs at the two ends;
here both ends must be equal).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from posterior_matching_torch.distributions._math import LOG_2PI
from posterior_matching_torch.models.networks import (
    Dense,
    conv_transpose_padding,
    same_padding,
)
from posterior_matching_torch.ops.vq import (
    nearest_codebook_indices,
    vq_straight_through,
)
from posterior_matching_torch.parallel import mesh
from posterior_matching_torch.runtime import torch_dtype


class Conv(nn.Module):
    """flax ``nn.Conv`` (``padding="SAME"``) on NCHW tensors, at ``dtype``
    as flax's ``dtype`` argument (float32 or bf16)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.k, self.stride, self.dtype = k, stride, dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ph = same_padding(x.shape[2], self.k, self.stride)
        pw = same_padding(x.shape[3], self.k, self.stride)
        if self.dtype == torch.float32:
            w, b = self.weight, self.bias
        else:  # flax: input, kernel and bias cast; the conv, then + bias
            x, w, b = x.to(self.dtype), self.weight.to(self.dtype), None
        if ph[0] == ph[1] and pw[0] == pw[1]:
            out = F.conv2d(x, w, b, self.stride, (ph[0], pw[0]))
        else:
            out = F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, b, self.stride)
        return out if b is not None else out + self.bias.to(self.dtype)[:, None, None]


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose`` (``padding="SAME"``,
    ``transpose_kernel=False``) on NCHW tensors. ``weight`` is
    ``[in, out, k, k]``, flipped in space relative to the flax kernel; at
    ``dtype`` as :class:`Conv`."""

    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        lo, hi = conv_transpose_padding(k, stride)
        if lo != hi:
            raise ValueError(f"asymmetric transpose padding for k={k}, s={stride}")
        self.padding = k - 1 - lo
        self.weight = nn.Parameter(torch.empty(cin, cout, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return F.conv_transpose2d(x, self.weight, self.bias, self.stride, self.padding)
        out = F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype), None,
                                 self.stride, self.padding)
        return out + self.bias.to(self.dtype)[:, None, None]


class ConvResidualStack(nn.Module):
    """relu -> 3x3 conv -> relu -> 1x1 conv residual blocks, at ``dtype``."""

    def __init__(self, hidden: int, blocks: int, res_hidden: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.res3x3 = nn.ModuleList(
            Conv(hidden, res_hidden, 3, dtype=dtype) for _ in range(blocks)
        )
        self.res1x1 = nn.ModuleList(
            Conv(res_hidden, hidden, 1, dtype=dtype) for _ in range(blocks)
        )

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for c3, c1 in zip(self.res3x3, self.res1x1):
            h = h + c1(F.relu(c3(F.relu(h))))
        return F.relu(h)


class ConvResidualEncoder(nn.Module):
    """Two stride-2 4x4 convs + 3x3 conv + residual stack (downsamples 4x),
    all at ``dtype``: in bf16 the output is bf16."""

    def __init__(self, cin: int, hidden: int, blocks: int, res_hidden: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.enc_1 = Conv(cin, hidden // 2, 4, 2, dtype=dtype)
        self.enc_2 = Conv(hidden // 2, hidden, 4, 2, dtype=dtype)
        self.enc_3 = Conv(hidden, hidden, 3, dtype=dtype)
        self.stack = ConvResidualStack(hidden, blocks, res_hidden, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.enc_1(x))
        h = F.relu(self.enc_2(h))
        h = F.relu(self.enc_3(h))
        return self.stack(h)


class ConvResidualDecoder(nn.Module):
    """3x3 conv + residual stack + two stride-2 transposed convs; returns the
    decoder Normal's mean. Its scalar ``log_scale`` gives the scale of the
    training loss (:meth:`VQVAE.forward`). All but the last transposed conv
    run at ``dtype``; the last stays float32 (``vqvae.py:264-267``), so the
    mean is float32."""

    def __init__(
        self, cin: int, hidden: int, blocks: int, res_hidden: int, cout: int,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.log_scale = nn.Parameter(torch.zeros(()))
        self.dec_1 = Conv(cin, hidden, 3, dtype=dtype)
        self.stack = ConvResidualStack(hidden, blocks, res_hidden, dtype=dtype)
        self.dec_2 = ConvTranspose(hidden, hidden // 2, 4, 2, dtype=dtype)
        self.dec_3 = ConvTranspose(hidden // 2, cout, 4, 2)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.stack(self.dec_1(z))
        return self.dec_3(F.relu(self.dec_2(h)).float())


class VectorQuantizer(nn.Module):
    """The codebook quantizer (``vqvae.py:33-140``). With ``use_ema`` (every
    config) the codebook and its EMA statistics are buffers, as they are
    the ``vq_ema`` state collection in the JAX package: no optimizer sees
    them. Only a forward called with ``is_training=True`` moves them, never
    the module's ``training`` flag, so a frozen VQ-VAE inside a model in
    ``train()`` mode keeps its codebook. Without it the codebook is a
    parameter, as JAX's ``self.param("embeddings", ...)`` (:66-67), learned
    by the loss: its gradient comes through the gather of the chosen codes
    alone (``jnp.take``), the search being the same kernel."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 commitment_cost: float = 0.25, decay: float = 0.99,
                 epsilon: float = 1e-5, use_ema: bool = True):
        super().__init__()
        self.commitment_cost, self.decay, self.epsilon = commitment_cost, decay, epsilon
        self.use_ema = use_ema
        # the JAX init: uniform with variance 1 / embedding_dim
        lim = math.sqrt(3.0 / embedding_dim)
        codebook = torch.empty(num_embeddings, embedding_dim).uniform_(-lim, lim)
        if not use_ema:
            self.embeddings = nn.Parameter(codebook)
            return
        self.register_buffer("embeddings", codebook)
        self.register_buffer("ema_cluster_size", torch.zeros(num_embeddings))
        self.register_buffer(
            "ema_dw", torch.zeros(num_embeddings, embedding_dim)
        )

    def forward(self, z: torch.Tensor, is_training: bool = False) -> Dict[str, torch.Tensor]:
        """``z [..., D]`` -> the straight-through quantization, the
        quantizer's loss, the codebook perplexity and the indices
        (``vqvae.py:75-135``): with ``use_ema`` the commitment loss, and
        with ``is_training`` the codebook then takes one EMA step (the
        quantization uses the codebook before it); without it
        ``q_latent + commitment_cost * e_latent`` (:114-118)."""
        flat = z.reshape(-1, z.shape[-1]).contiguous()
        indices = nearest_codebook_indices(flat, self.embeddings)
        quantized = self.embeddings[indices.long()].reshape(z.shape)
        e_latent_loss = ((quantized.detach() - z) ** 2).mean()
        if self.use_ema:
            loss = self.commitment_cost * e_latent_loss
        else:
            loss = ((quantized - z.detach()) ** 2).mean() + self.commitment_cost * e_latent_loss
        counts = torch.bincount(
            indices.long(), minlength=self.embeddings.shape[0]
        )
        total = indices.numel()
        if is_training and self.use_ema:
            counts = self._ema_update(flat.detach(), indices.long(), counts)
            total *= mesh.world_size()
        avg_probs = counts.float() / total
        perplexity = torch.exp(-(avg_probs * torch.log(avg_probs + 1e-10)).sum())
        return {
            "quantize": vq_straight_through(z, quantized),
            "loss": loss,
            "perplexity": perplexity,
            "encoding_indices": indices.reshape(z.shape[:-1]),
        }

    @torch.no_grad()
    def _ema_update(self, flat, indices, counts):
        """Laplace-smoothed EMA of the code counts and of the latents summed
        per code, and the codebook their ratio (``vqvae.py:88-113``).
        Under a process group the counts and sums are the ranks' total
        first, so the codebook follows the global batch, as on the JAX
        package's data mesh. Returns the counts it used."""
        k = self.embeddings.shape[0]
        # the one-hot product of vqvae.py:95-97, not index_add_, whose atomic
        # sums land in another order each call on the GPU
        dw = F.one_hot(indices, k).to(flat.dtype).T @ flat
        counts = counts.to(flat.dtype)
        if mesh.distributed():
            counts, dw = mesh.all_reduce_sum([counts, dw])
        self.ema_cluster_size.mul_(self.decay).add_((1.0 - self.decay) * counts)
        self.ema_dw.mul_(self.decay).add_((1.0 - self.decay) * dw)
        n = self.ema_cluster_size.sum()
        stable = (self.ema_cluster_size + self.epsilon) / (n + k * self.epsilon) * n
        self.embeddings.copy_(self.ema_dw / stable[:, None])
        return counts

    def quantize(self, encoding_indices: torch.Tensor) -> torch.Tensor:
        return self.embeddings[encoding_indices.long()]


class VQVAE(nn.Module):
    """The VQ-VAE (``vqvae.py:252-329``). ``use_ema=False`` learns the
    codebook by the loss (:class:`VectorQuantizer`); no config sets it.
    ``compute_dtype`` (None, "float32" or "bfloat16") is the encoder's and
    decoder's conv stacks' (``vqvae.py:268-295``); the pre-quantization
    1x1 conv, the quantizer and the decoder's last conv stay float32."""

    def __init__(
        self,
        output_channels: int = 3,
        embedding_dim: int = 64,
        num_embeddings: int = 512,
        hidden_units: int = 128,
        residual_blocks: int = 2,
        residual_hidden_units: int = 128,
        decay: float = 0.99,
        commitment_cost: float = 0.25,
        use_ema: bool = True,
        compute_dtype: Optional[str] = None,
        **_unused,
    ):
        super().__init__()
        cd = torch_dtype(compute_dtype)
        self.encoder = ConvResidualEncoder(
            output_channels, hidden_units, residual_blocks,
            residual_hidden_units, dtype=cd,
        )
        self.pre_vq_conv = Conv(hidden_units, embedding_dim, 1)
        self.vq = VectorQuantizer(num_embeddings, embedding_dim, commitment_cost, decay,
                                  use_ema=use_ema)
        self.decoder = ConvResidualDecoder(
            embedding_dim, hidden_units, residual_blocks,
            residual_hidden_units, output_channels, dtype=cd,
        )

    def forward(self, x: torch.Tensor, is_training: bool = False) -> Dict[str, Any]:
        """Stage 1's objective on ``[B, H, W, C]`` images
        (``vqvae.py:301-321``): ``loss`` is the reconstruction loss, the
        decoder Normal's ``-mean(sum log p(x))`` at scale
        ``exp(log_scale) + 1e-5``, plus the quantizer's loss; with
        ``is_training`` an EMA codebook takes its step."""
        z = self.encode(x)
        vq_output = self.vq(z, is_training=is_training)
        loc = self.decoder(vq_output["quantize"].permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        scale = torch.exp(self.decoder.log_scale) + 1e-5
        zs = (x - loc) / scale
        lp = -0.5 * zs * zs - torch.log(scale) - 0.5 * LOG_2PI
        reconstruction_loss = -lp.sum(dim=tuple(range(1, lp.ndim))).mean()
        return {
            "loss": reconstruction_loss + vq_output["loss"],
            "vq_output": vq_output,
            "z": z,
            "reconstruction": loc,
            "reconstruction_loss": reconstruction_loss,
        }

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] images -> [B, H/4, W/4, D] pre-quantization latents."""
        z = self.pre_vq_conv(self.encoder(x.permute(0, 3, 1, 2)).float())
        return z.permute(0, 2, 3, 1)

    def encoding_indices(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] images -> [B, H/4, W/4] int32 codes."""
        return self.vq(self.encode(x))["encoding_indices"]

    def decode_indices(self, encoding_indices: torch.Tensor) -> torch.Tensor:
        """[B, h, w] integer codes -> [B, H, W, C] decoder means."""
        q = self.vq.quantize(encoding_indices).permute(0, 3, 1, 2)
        return self.decoder(q).permute(0, 2, 3, 1)


class VQVAEPartialEncoder(nn.Module):
    """Masked image + mask ``[B, H, W, 2C]`` -> conditioning vector: the
    conv stack at ``compute_dtype`` (``vqvae.py:340-363``), the dense head
    float32."""

    def __init__(
        self,
        in_channels: int,
        image_hw: Tuple[int, int],
        conditional_dim: int,
        hidden_units: int,
        residual_blocks: int,
        residual_hidden_units: int,
        compute_dtype: Optional[str] = None,
    ):
        super().__init__()
        self.encoder = ConvResidualEncoder(
            in_channels, hidden_units, residual_blocks, residual_hidden_units,
            dtype=torch_dtype(compute_dtype),
        )
        h, w = (-(-image_hw[0] // 4), -(-image_hw[1] // 4))
        self.dense = Dense(h * w * hidden_units, conditional_dim)

    def forward(self, x_o_b: torch.Tensor) -> torch.Tensor:
        h = self.encoder(x_o_b.permute(0, 3, 1, 2))
        # flax flattens NHWC: rows, then columns, then channels
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return self.dense(h.float())

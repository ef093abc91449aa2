"""PM-VQVAE: frozen VQ-VAE + partial encoder + conditional PixelCNN.

Counterpart of ``posterior_matching_tpu/models/pm_vqvae.py:24-211``:

- the training objective (:meth:`PMVQVAE.forward`): the frozen VQ-VAE's
  codes (the codebook search kernel on the GPU), the partial encoder's
  condition, the PixelCNN's teacher-forced log-likelihood (the gated chain
  kernels on the GPU);
- the imputation path (:func:`pm_vqvae_impute`): partial encoder -> raster
  sampling of code grids (the row-sampler kernels on the GPU) -> VQ-VAE
  decode -> stitch in the observed pixels -> clip.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch
from torch import nn

from posterior_matching_torch.models.pixelcnn import PixelCNN
from posterior_matching_torch.models.vqvae import VQVAE, VQVAEPartialEncoder
from posterior_matching_torch.ops.sampler_chain import pixelcnn_sample
from posterior_matching_torch.runtime import resolve_device, torch_dtype

_PIXEL_CNN_KEYS = (
    "num_indices", "image_shape", "dropout", "num_resnet", "num_hierarchies",
    "num_filters", "receptive_field_dims", "dtype",
)


def model_dtypes(vqvae_config: Dict[str, Any], pixel_cnn_config: Dict[str, Any],
                 compute_dtype: Optional[str] = None):
    """The configs with the compute dtype placed as the JAX package's
    ``PMVQVAE.from_config`` places it (``pm_vqvae.py:50-57``): an explicit
    ``compute_dtype`` fills a missing ``vqvae_config["compute_dtype"]`` and
    a missing ``pixel_cnn_config["dtype"]``; failing that, the VQ-VAE's
    ``compute_dtype`` fills the PixelCNN's ``dtype``. Returns copies; a
    dtype other than None, "float32" or "bfloat16" is refused by name."""
    vq, pc = dict(vqvae_config), dict(pixel_cnn_config)
    if compute_dtype is not None:
        vq.setdefault("compute_dtype", compute_dtype)
        pc.setdefault("dtype", compute_dtype)
    elif "compute_dtype" in vq:
        pc.setdefault("dtype", vq["compute_dtype"])
    torch_dtype(vq.get("compute_dtype"))
    torch_dtype(pc.get("dtype"))
    return vq, pc


class PMVQVAE(nn.Module):
    """``vqvae_config`` and ``pixel_cnn_config`` are the JSON config dicts a
    run directory holds (``vqvae_config.json``, ``config.json``'s
    ``pixel_cnn``). ``compute_dtype`` (None, "float32" or "bfloat16", the
    run config's key) is the conv stacks' compute dtype, placed as
    :func:`model_dtypes` says: the VQ-VAE's encoder and decoder and the
    partial encoder at the VQ-VAE's ``compute_dtype``, the PixelCNN's
    embedding, initial convs and gated chain at its ``dtype``; parameters,
    the quantizer and every head stay float32. ``chain_segment`` is the
    PixelCNN's chain granularity (:class:`~posterior_matching_torch.models.
    pixelcnn.PixelCNN`), an option of the caller's, never read from a
    config."""

    def __init__(
        self,
        conditional_dim: int,
        vqvae_config: Dict[str, Any],
        pixel_cnn_config: Dict[str, Any],
        chain_segment: Union[str, int] = "stream",
        compute_dtype: Optional[str] = None,
    ):
        super().__init__()
        vq, pc = model_dtypes(vqvae_config, pixel_cnn_config, compute_dtype)
        pc = {k: pc[k] for k in _PIXEL_CNN_KEYS if k in pc}
        self.vqvae = VQVAE(**vq)
        h, w = pc["image_shape"]
        # the VQ-VAE encoder downsamples 4x, so images are 4x the code grid
        self.partial_encoder = VQVAEPartialEncoder(
            in_channels=vq.get("output_channels", 3) + 1,
            image_hw=(4 * h, 4 * w),
            conditional_dim=conditional_dim,
            hidden_units=vq["hidden_units"],
            residual_blocks=vq["residual_blocks"],
            residual_hidden_units=vq["residual_hidden_units"],
            compute_dtype=vq.get("compute_dtype"),
        )
        self.pixel_cnn = PixelCNN(**pc, conditional_dim=conditional_dim,
                                  chain_segment=chain_segment)

    @classmethod
    def from_config(
        cls,
        conditional_dim: int,
        vqvae_config: Dict[str, Any],
        pixel_cnn_config: Dict[str, Any],
        device: Optional[str] = None,
        chain_segment: Union[str, int] = "stream",
        compute_dtype: Optional[str] = None,
    ) -> "PMVQVAE":
        """Builds the model on ``device`` (the GPU unless ``"cpu"``)."""
        dev = resolve_device(device)
        return cls(conditional_dim, vqvae_config, pixel_cnn_config,
                   chain_segment, compute_dtype).to(dev).eval()

    def conditional_latents(self, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.partial_encoder(torch.cat([x * b, b], dim=-1))

    def forward(self, x: torch.Tensor, b: torch.Tensor, training: bool = False,
                seed: int = 0) -> torch.Tensor:
        """Per-example conditional log-likelihood of the VQ codes of ``x``
        given the observed pixels ``x * b`` (``pm_vqvae.py:85-106``):
        ``[B]``. ``seed`` draws the PixelCNN's dropout masks in training."""
        with torch.no_grad():
            codes = self.vqvae.encoding_indices(x)
        cond = self.conditional_latents(x, b)
        return self.pixel_cnn.log_prob(codes, cond, training=training, seed=seed)

    def decode_code_samples(self, code_samples: torch.Tensor) -> torch.Tensor:
        """[S, B, h, w] int codes -> [S, B, H, W, C] decoder means."""
        s, b = code_samples.shape[:2]
        imgs = self.vqvae.decode_indices(
            code_samples.reshape(s * b, *code_samples.shape[2:])
        )
        return imgs.reshape(s, b, *imgs.shape[1:])


@torch.no_grad()
def pm_vqvae_impute(
    model: PMVQVAE,
    x: torch.Tensor,
    b: torch.Tensor,
    num_samples: int = 5,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Imputes ``x [B, H, W, C]`` where ``b [B, H, W, 1]`` is 0: returns
    ``[B, num_samples, H, W, C]`` clipped to [0, 1], observed pixels copied
    through. Sampling noise comes from ``generator`` (drawn on the model's
    device) or is given as ``noise [h, w, num_samples * B, K]``."""
    cond = model.conditional_latents(x, b)
    samples = pixelcnn_sample(
        model.pixel_cnn, num_samples, cond, noise=noise, generator=generator
    )
    imputations = model.decode_code_samples(samples).movedim(0, 1)
    imputations = torch.where(b[:, None] != 0, x[:, None], imputations)
    return imputations.clamp(0.0, 1.0)

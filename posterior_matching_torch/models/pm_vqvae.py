"""PM-VQVAE: frozen VQ-VAE + partial encoder + conditional PixelCNN.

Counterpart of ``posterior_matching_tpu/models/pm_vqvae.py:24-211``:

- the training objective (:meth:`PMVQVAE.forward`): the frozen VQ-VAE's
  codes (the codebook search kernel on the GPU), the partial encoder's
  condition, the PixelCNN's teacher-forced log-likelihood (the gated chain
  kernels on the GPU);
- the imputation path (:func:`pm_vqvae_impute`): partial encoder -> raster
  sampling of code grids (the row-sampler kernels on the GPU, at the dtype
  :func:`impute_sampler` chooses, or the naive full-forward sampler for the
  topologies they do not take) -> VQ-VAE decode -> stitch in the observed
  pixels -> clip.
"""
from __future__ import annotations

import itertools
import os
import warnings
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from posterior_matching_torch import tracing
from posterior_matching_torch.models.pixelcnn import PixelCNN, pixelcnn_sample_naive
from posterior_matching_torch.models.vqvae import VQVAE, VQVAEPartialEncoder
from posterior_matching_torch.ops.sampler_chain import pixelcnn_sample, row_sampler_topology
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


def impute_sampler(pixel_cnn: PixelCNN, device,
                   sampler_dtype=None) -> Tuple[str, Optional[torch.dtype]]:
    """The raster sampler :func:`pm_vqvae_impute` takes on ``device``, chosen
    as the JAX package's ``pm_vqvae_impute`` chooses it (``pm_vqvae.py:
    146-200``), so that a run's environment means the same in both:

    - ``("naive", None)``, the full-forward sampler, for a topology the row
      kernels do not take (more than one hierarchy, or a receptive field
      other than (3, 3));
    - else ``("rowkernel", dtype)``, the row kernels at ``sampler_dtype``
      where the caller names it; on a CUDA device with
      ``PM_TPU_SAMPLER=rowkernel`` at ``PM_TPU_SAMPLER_DTYPE`` (default
      bfloat16), as JAX's TPU branch; otherwise at float32, where JAX's
      default cached sampler computes (and always on the CPU, where JAX
      tests for a TPU backend).
    """
    if not row_sampler_topology(pixel_cnn):
        if sampler_dtype is not None:
            raise ValueError("sampler_dtype names the row kernels' dtype; this "
                             "PixelCNN's topology takes the naive sampler")
        return "naive", None
    if sampler_dtype is not None:
        return "rowkernel", torch_dtype(sampler_dtype)
    if (torch.device(device).type == "cuda"
            and os.environ.get("PM_TPU_SAMPLER", "fast") == "rowkernel"):
        return "rowkernel", torch_dtype(os.environ.get("PM_TPU_SAMPLER_DTYPE", "bfloat16"))
    return "rowkernel", torch.float32


# the unit of each request's spans
_requests = itertools.count()


@torch.no_grad()
def pm_vqvae_impute(
    model: PMVQVAE,
    x: torch.Tensor,
    b: torch.Tensor,
    num_samples: int = 5,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    sampler_dtype=None,
) -> torch.Tensor:
    """Imputes ``x [B, H, W, C]`` where ``b [B, H, W, 1]`` is 0: returns
    ``[B, num_samples, H, W, C]`` clipped to [0, 1], observed pixels copied
    through. Sampling noise comes from ``generator`` (drawn on the model's
    device) or is given as ``noise [h, w, num_samples * B, K]`` (for every
    branch: the naive sampler reads it in raster order). The sampler is
    :func:`impute_sampler`'s choice (``sampler_dtype`` names the row
    kernels' dtype outright); the naive one with JAX's warning
    (``pm_vqvae.py:182-199``)."""
    with tracing.span("impute.request", next(_requests)):
        cond = model.conditional_latents(x, b)
        pixel_cnn = model.pixel_cnn
        branch, dtype = impute_sampler(pixel_cnn, pixel_cnn.embed.device, sampler_dtype)
        if branch == "naive":
            warnings.warn(
                "pm_vqvae_impute: PixelCNN topology (num_hierarchies="
                f"{pixel_cnn.num_hierarchies}, receptive_field_dims="
                f"{tuple(pixel_cnn.receptive_field_dims)}) is not covered by the row "
                "sampler's kernels; falling back to the naive full-forward raster "
                "sampler (one full-grid forward a pixel).",
                stacklevel=2,
            )
            if noise is not None:
                noise = noise.reshape(-1, *noise.shape[2:])
            samples = pixelcnn_sample_naive(pixel_cnn, num_samples, cond, noise=noise,
                                            generator=generator)
        else:
            samples = pixelcnn_sample(pixel_cnn, num_samples, cond, noise=noise,
                                      generator=generator, compute_dtype=dtype)
        imputations = model.decode_code_samples(samples).movedim(0, 1)
        imputations = torch.where(b[:, None] != 0, x[:, None], imputations)
        return imputations.clamp(0.0, 1.0)

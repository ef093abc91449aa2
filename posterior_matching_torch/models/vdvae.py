"""Posterior-Matching Very Deep VAE.

Counterpart of ``posterior_matching_tpu/models/vdvae.py``: a hierarchical
VAE with a second, masked encoder (it reads ``x b`` and ``b``) and, in every
decoder block, a full-covariance (TriL) masked posterior trained with
``pm_kl = KL(stop_grad(posterior) || masked_posterior)``; a discretized
mixture of logistics over the pixels.

Modules are ``nn.Module``s on NHWC tensors. Parameters keep the flax names
and layouts (conv kernels ``[kh, kw, in, out]``), so a state-dict name is
the JAX tree path joined by dots (``convert.pm_vdvae_state_dict``).

- ``fused_chain`` chooses the runs (the JAX package's option of the same
  name, ``vdvae.py:210-236, 623-642``, without its environment variables):
  with ``None`` (the default) every run of two or more non-downsampling
  encoder blocks at one resolution goes through :func:`posterior_matching_
  torch.ops.block_chain.block_chain` (``vdvae.py:260-313``); ``True`` also
  sends the training path's decoder runs (``Decoder.forward_posterior``)
  through :func:`posterior_matching_torch.ops.decoder_chain.dec_chain`
  (``vdvae.py:691-788``); ``False`` runs every block on its own. The chains
  are the hand-written kernels for CUDA tensors and their plain versions
  for CPU tensors. Downsampling blocks, the other decoder paths and the
  output head are plain convolutions (XLA's in the JAX package).
- Sampling takes ``noise`` (:data:`~posterior_matching_torch.distributions.
  Noise`): a ``torch.Generator``, or an iterator of the caller's standard
  normals, consumed in the order in which the JAX package calls
  ``make_rng("sample")``; a fused run draws each block's normals by the
  same call, in the same order.
- ``compute_dtype="bfloat16"`` (``vdvae.py:133-137``): every Block's
  c1..c3 compute in bf16 and c4 in float32, so parameters, block outputs
  and every distribution's parameters stay float32. An unfused Block has
  flax's ``nn.Conv(dtype=bfloat16)`` semantics (bf16 input and kernel,
  a bf16 output with its bias added in bf16, on bf16 tensors, whose
  products cuBLAS and cuDNN sum in float32: ``runtime.py``); a fused run is
  the chains' bf16 form, and a run is fused where the JAX package fuses it
  (``chain_supported``: rows a multiple of 16).
- ``remat=True`` (``nn.remat(Block)``, ``vdvae.py:242``) recomputes the
  encoders' unfused and downsampling Blocks in the backward
  (``torch.utils.checkpoint``); the chains already save only what their
  backward reads.
- ``fused_chain="interpret"`` (the JAX package's CPU test mode) raises.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from posterior_matching_torch.distributions import (
    MultivariateNormalDiag,
    MultivariateNormalTriL,
    Noise,
    QuantizedLogisticMixture,
    fill_scale_tril,
    softplus_scale,
    standard_normal,
    tril_size,
)
from posterior_matching_torch.ops.block_chain import (
    NAMES, block_chain, chain_supported, conv_taps, gelu,
)
from posterior_matching_torch.ops.decoder_chain import dec_chain, dec_chain_supported
from posterior_matching_torch.runtime import resolve_device, torch_dtype
from posterior_matching_torch.utils import logmeanexp

Acts = Dict[int, torch.Tensor]


def parse_layer_string(s: str) -> List[Tuple[int, Optional[int]]]:
    """'28x6,28d2,3m1' -> [(res, None / down rate / mixin), ...]
    (``vdvae.py:51-67``)."""
    layers = []
    for part in s.split(","):
        if "x" in part:
            res, num = part.split("x")
            layers.extend([(int(res), None)] * int(num))
        elif "m" in part:
            res, mixin = part.split("m")
            layers.append((int(res), int(mixin)))
        elif "d" in part:
            res, down = part.split("d")
            layers.append((int(res), int(down)))
        else:
            layers.append((int(part), None))
    return layers


def get_width_settings(width: int, s: Optional[str]):
    mapping = defaultdict(lambda: width)
    if s:
        for part in s.split(","):
            k, v = part.split(":")
            mapping[int(k)] = int(v)
    return mapping


class Conv(nn.Module):
    """flax ``nn.Conv`` (SAME for k > 1, VALID for 1) on NHWC tensors, with
    flax's ``kernel [k, k, in, out]`` and ``bias [out]``. Weights come from a
    tree (``convert.py``); they start at zero."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.k = k
        self.kernel = nn.Parameter(torch.zeros(k, k, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def tap_weight(self) -> torch.Tensor:
        """The kernel as ``[k*k*in, out]`` rows, tap-major."""
        return self.kernel.reshape(-1, self.kernel.shape[-1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_taps(x, self.tap_weight(), self.k) + self.bias


class Block(nn.Module):
    """Bottleneck block: gelu -> 1x1 -> gelu -> kxk -> gelu -> kxk -> gelu ->
    1x1, with an optional residual and avg-pool downsampling
    (``vdvae.py:121-196``); c1..c3 at ``compute_dtype``, c4 in float32."""

    def __init__(self, cin: int, middle_width: int, out_width: int,
                 down_rate: Optional[int] = None, residual: bool = False,
                 use_3x3: bool = True, compute_dtype=torch.float32):
        super().__init__()
        self.mid, self.k = middle_width, 3 if use_3x3 else 1
        self.down_rate, self.residual = down_rate, residual
        self.cdtype = compute_dtype
        self.c1 = Conv(cin, middle_width, 1)
        self.c2 = Conv(middle_width, middle_width, self.k)
        self.c3 = Conv(middle_width, middle_width, self.k)
        self.c4 = Conv(middle_width, out_width, 1)

    def chain_weights(self) -> Dict[str, torch.Tensor]:
        """c1-c4 in the block chain's kernel-native layout
        (``vdvae.py:299-308``); differentiable views of the parameters."""
        out = {}
        for i, conv in enumerate((self.c1, self.c2, self.c3, self.c4), 1):
            out[f"w{i}"] = conv.tap_weight()
            out[f"b{i}"] = conv.bias.reshape(1, -1)
        return out

    def _inner(self, conv: Conv, a: torch.Tensor) -> torch.Tensor:
        """c1..c3 on ``a`` at the compute dtype: in bf16 flax's
        ``nn.Conv(dtype=bfloat16)``, input, kernel and bias cast to bf16 and
        the output bf16."""
        if self.cdtype == torch.float32:
            return conv(a)
        cd = self.cdtype
        return conv_taps(a.to(cd), conv.tap_weight().to(cd), conv.k) + conv.bias.to(cd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self._inner(self.c1, gelu(x))
        h = self._inner(self.c2, gelu(h))
        h = self._inner(self.c3, gelu(h))
        h = self.c4(gelu(h).float())
        out = x + h if self.residual else h
        if self.down_rate is not None:
            d = self.down_rate
            out = F.avg_pool2d(out.permute(0, 3, 1, 2), d, d).permute(0, 2, 3, 1)
        return out


def _pad_channels(t: torch.Tensor, width: int) -> torch.Tensor:
    d = width - t.shape[-1]
    return F.pad(t, (0, d)) if d > 0 else t


class Encoder(nn.Module):
    """Stack of bottleneck blocks recording the activations of each
    resolution, the last block's at each (``vdvae.py:206-325``); with
    ``chain`` the runs go through the block chain."""

    def __init__(self, in_channels: int, width: int, blocks: str,
                 bottleneck_multiple: float, custom_width_string: Optional[str] = None,
                 chain: bool = True, compute_dtype=torch.float32, remat: bool = False):
        super().__init__()
        self.widths = get_width_settings(width, custom_width_string)
        self.specs = parse_layer_string(blocks)
        self.bm = bottleneck_multiple
        self.chain, self.cdtype, self.remat = chain, compute_dtype, remat
        self.in_conv = Conv(in_channels, width, 3)
        c = width
        for i, (res, down) in enumerate(self.specs):
            w = self.widths[res]
            setattr(self, f"block_{i}", Block(c, int(w * bottleneck_multiple), w,
                                              down_rate=down, residual=True,
                                              use_3x3=res > 2, compute_dtype=compute_dtype))
            new_res = res // down if down else res
            c = max(w, self.widths[new_res])

    def block(self, i: int) -> Block:
        return getattr(self, f"block_{i}")

    def _fused(self, h: torch.Tensor, res: int, run: int) -> bool:
        """Whether a run of ``run`` blocks at ``res`` goes through the block
        chain. In float32 every run of two or more (the kernels take any row
        count, and fused and unfused sums agree to rounding); in bf16 those
        the JAX package fuses (``vdvae.py:280-288``), as the unfused Blocks
        round each conv output to bf16 and the chain does not."""
        return (self.chain and run >= 2 and h.shape[-1] == self.widths[res]
                and (self.cdtype == torch.float32
                     or chain_supported(h.shape[0], res, res, self.cdtype)))

    def _block(self, i: int, h: torch.Tensor) -> torch.Tensor:
        """Block ``i`` on ``h``, recomputed in the backward with ``remat``."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(self.block(i), h, use_reentrant=False)
        return self.block(i)(h)

    def forward(self, x: torch.Tensor) -> Acts:
        h = self.in_conv(x)
        acts = {h.shape[1]: h}
        specs, i = self.specs, 0
        while i < len(specs):
            res, _ = specs[i]
            # the run of non-downsampling blocks at this resolution, or one
            # downsampling block
            j = i
            while j < len(specs) and specs[j][0] == res and specs[j][1] is None:
                j += 1
            j = max(j, i + 1)
            if self._fused(h, res, j - i):
                per_level = [self.block(b).chain_weights() for b in range(i, j)]
                stacked = {n: torch.stack([lv[n] for lv in per_level]) for n in NAMES}
                h = block_chain(h, stacked, mid=int(self.widths[res] * self.bm),
                                k=3 if res > 2 else 1, compute_dtype=self.cdtype)
            else:
                for b in range(i, j):
                    h = self._block(b, h)
            h = _pad_channels(h, self.widths[h.shape[1]])
            acts[h.shape[1]] = h
            i = j
        return acts


class LogisticMixtureHead(nn.Module):
    """1x1 conv -> DMoL parameters (``vdvae.py:328-368``)."""

    def __init__(self, cin: int, num_channels: int, num_mixtures: int,
                 low: float = 0.0, high: float = 255.0):
        super().__init__()
        c = num_channels
        self.c, self.m, self.low, self.high = c, num_mixtures, low, high
        self.num_coeffs = c * (c - 1) // 2
        self.num_out = 2 * c + self.num_coeffs + 1
        self.params_conv = Conv(cin, num_mixtures * self.num_out, 1)

    def forward(self, x: torch.Tensor) -> QuantizedLogisticMixture:
        c = self.c
        p = self.params_conv(x).reshape(*x.shape[:-1], self.m, self.num_out)
        if c == 1:
            logits, locs, scales, coeffs = p[..., 0], p[..., 1:2], p[..., 2:3], None
        else:
            logits, locs = p[..., 0], p[..., 1:c + 1]
            scales, coeffs = p[..., c + 1:2 * c + 1], p[..., -self.num_coeffs:]
        scales = F.softplus(scales) + float(np.exp(-7.0))
        return QuantizedLogisticMixture(logits, locs, scales, coeffs, self.low,
                                        self.high, c)


def _resize_nearest(t: torch.Tensor, size: int) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")`` of NHWC ``t`` to ``size`` x
    ``size``: half-pixel centres, which is ``nearest-exact``."""
    y = F.interpolate(t.permute(0, 3, 1, 2), size=(size, size), mode="nearest-exact")
    return y.permute(0, 2, 3, 1)


class DecoderBlock(nn.Module):
    """One PM decoder block (``vdvae.py:371-605``): a diag posterior, a TriL
    masked posterior fed a stop-gradient of the decoder state, a diag prior
    that also updates the state, the z projection and a residual resnet."""

    def __init__(self, latent_dim: int, res: int, mixin: Optional[int], num_blocks: int,
                 width: int, bottleneck_multiple: float,
                 custom_width_string: Optional[str] = None, compute_dtype=torch.float32):
        super().__init__()
        w = get_width_settings(width, custom_width_string)[res]
        self.res, self.mixin, self.ld, self.w = res, mixin, latent_dim, w
        mid, ld, use_3x3 = int(w * bottleneck_multiple), latent_dim, res > 2
        kw = {"use_3x3": use_3x3, "compute_dtype": compute_dtype}
        self.posterior = Block(2 * w, mid, 2 * ld, **kw)
        self.masked_posterior = Block(2 * w, mid, ld + tril_size(ld), **kw)
        self.prior = Block(w, mid, 2 * ld + w, **kw)
        self.z_proj = Conv(ld, w, 1)
        self.resnet = Block(w, mid, w, residual=True, **kw)

    def _posterior(self, x, acts):
        out = self.posterior(torch.cat([x, acts], -1))
        return out[..., :self.ld], softplus_scale(out[..., self.ld:])

    def _masked_posterior(self, x, masked_acts) -> MultivariateNormalTriL:
        params = self.masked_posterior(torch.cat([x, masked_acts], -1))
        return MultivariateNormalTriL(params[..., :self.ld],
                                      fill_scale_tril(params[..., self.ld:], self.ld))

    def _prior(self, x):
        out = self.prior(x)
        ld = self.ld
        prior = MultivariateNormalDiag(out[..., :ld], softplus_scale(out[..., ld:2 * ld]))
        return prior, out[..., -self.w:]

    def _get_x(self, xs: Acts, batch: int, like: Optional[torch.Tensor] = None,
               device=None) -> torch.Tensor:
        if self.res in xs:
            x = xs[self.res]
        elif like is not None:
            x = torch.zeros_like(like)
        else:
            x = torch.zeros(batch, self.res, self.res, self.w, device=device)
        if x.shape[0] != batch:
            x = x.expand(batch, *x.shape[1:])
        if self.mixin is not None:
            x = x + _resize_nearest(xs[self.mixin][..., :x.shape[-1]], self.res)
        return x

    def _finish(self, xs: Acts, x: torch.Tensor, z: torch.Tensor) -> Acts:
        x = x + self.z_proj(z)
        out = dict(xs)
        out[self.res] = self.resnet(x)
        return out

    def chain_weights(self) -> Dict[str, torch.Tensor]:
        """This block as one level of a decoder chain, in its kernel-native
        layout (``vdvae.py:488-515``); differentiable views of the
        parameters."""
        out = {}
        for tag, block in (("p", self.posterior), ("m", self.masked_posterior),
                           ("q", self.prior), ("r", self.resnet)):
            out.update({f"{tag}_{n}": t for n, t in block.chain_weights().items()})
        out["wz"] = self.z_proj.tap_weight()
        out["bz"] = self.z_proj.bias.reshape(1, -1)
        return out

    def forward_posterior(self, xs: Acts, acts: Acts, masked_acts: Acts, noise: Noise):
        a, ma = acts[self.res], masked_acts[self.res]
        x = self._get_x(xs, a.shape[0], like=a)
        loc, scale = self._posterior(x, a)
        posterior = MultivariateNormalDiag(loc, scale)
        masked_params = self.masked_posterior(torch.cat([x.detach(), ma], -1))
        prior, h = self._prior(x)
        x = x + h
        z = posterior.sample(noise)
        kl = posterior.kl_divergence(prior).sum((1, 2))
        flat = lambda t: t.reshape(t.shape[0], -1, t.shape[-1])
        pm = {"raw": flat(masked_params), "loc": flat(loc.detach()),
              "scale": flat(scale.detach())}
        return self._finish(xs, x, z), {"z": z, "kl": kl, "pm": pm}

    def forward_partial_posterior(self, xs: Acts, masked_acts: Acts, noise: Noise) -> Acts:
        ma = masked_acts[self.res]
        x = self._get_x(xs, ma.shape[0], like=ma)
        masked_posterior = self._masked_posterior(x, ma)
        _, h = self._prior(x)
        z = masked_posterior.sample(noise)
        return self._finish(xs, x + h, z)

    def forward_prior(self, xs: Acts, batch: int, noise: Noise, device) -> Acts:
        x = self._get_x(xs, batch, device=device)
        prior, h = self._prior(x)
        z = prior.sample(noise)
        return self._finish(xs, x + h, z)

    def forward_lls(self, xs: Acts, masked_xs: Acts, acts: Acts, masked_acts: Acts,
                    noise: Noise):
        a, ma = acts[self.res], masked_acts[self.res]
        x = self._get_x(xs, a.shape[0], like=a)
        masked_x = self._get_x(masked_xs, a.shape[0], like=a)
        posterior = MultivariateNormalDiag(*self._posterior(x, a))
        masked_posterior = self._masked_posterior(masked_x, ma)
        prior, h = self._prior(x)
        masked_prior, masked_h = self._prior(masked_x)
        x, masked_x = x + h, masked_x + masked_h
        z = posterior.sample(noise)
        masked_z = masked_posterior.sample(noise)
        stats = {
            "pz": prior.log_prob(z).sum((1, 2)),
            "qzx": posterior.log_prob(z).sum((1, 2)),
            "masked_pz": masked_prior.log_prob(masked_z).sum((1, 2)),
            "masked_qzx": masked_posterior.log_prob(masked_z).sum((1, 2)),
        }
        return (self._finish(xs, x, z), self._finish(masked_xs, masked_x, masked_z), stats)


class Decoder(nn.Module):
    """The PM decoder: the per-resolution bias inputs, the blocks, the gain
    and bias and the DMoL head (``vdvae.py:608-842``)."""

    def __init__(self, latent_dim: int, image_size: int, num_channels: int, width: int,
                 blocks: str, bottleneck_multiple: float, no_bias_above: int,
                 num_mixtures: int, custom_width_string: Optional[str] = None,
                 fused: bool = False, compute_dtype=torch.float32):
        super().__init__()
        widths = get_width_settings(width, custom_width_string)
        specs = parse_layer_string(blocks)
        self.specs, self.fused, self.bm = specs, fused, bottleneck_multiple
        self.cdtype = compute_dtype
        self.latent_dim, self.image_size = latent_dim, image_size
        self.n_blocks = len(specs)
        for i, (res, mixin) in enumerate(specs):
            setattr(self, f"block_{i}", DecoderBlock(
                latent_dim, res, mixin, len(specs), width, bottleneck_multiple,
                custom_width_string, compute_dtype))
        self.bias_resolutions = [r for r in sorted({r for r, _ in specs}) if r <= no_bias_above]
        for r in self.bias_resolutions:
            self.register_parameter(f"x_bias_{r}", nn.Parameter(torch.zeros(1, r, r, widths[r])))
        self.out_net = LogisticMixtureHead(width, num_channels, num_mixtures)
        self.gain = nn.Parameter(torch.ones(1, 1, 1, width))
        self.bias = nn.Parameter(torch.zeros(1, 1, 1, width))

    def blocks(self) -> List[DecoderBlock]:
        return [getattr(self, f"block_{i}") for i in range(self.n_blocks)]

    def _bias_state(self) -> Acts:
        return {r: getattr(self, f"x_bias_{r}") for r in self.bias_resolutions}

    def _final(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gain + self.bias

    def _fused_run(self, idxs: List[int], xs: Acts, acts: Acts, masked_acts: Acts,
                   noise: Noise):
        """Blocks ``idxs``, one resolution's run, as one decoder chain
        (``vdvae.py:691-745``); the updated state and the blocks' stats as
        :meth:`DecoderBlock.forward_posterior` gives them, without ``z``."""
        blocks = [self.blocks()[i] for i in idxs]
        first, ld = blocks[0], self.latent_dim
        a, ma = acts[first.res], masked_acts[first.res]
        batch = a.shape[0]
        x0 = first._get_x(xs, batch, like=a)
        # each block's normals by the unfused sample's own call, in order
        eps = torch.stack([standard_normal(noise, (batch, b.res, b.res, ld), a.device)
                           for b in blocks])
        per_level = [b.chain_weights() for b in blocks]
        weights = {n: torch.stack([lv[n] for lv in per_level]) for n in per_level[0]}
        x_final, post, prior, masked = dec_chain(
            x0, a, ma, eps, weights, mid=int(first.w * self.bm), ld=ld,
            k=3 if first.res > 2 else 1, compute_dtype=self.cdtype)
        out = dict(xs)
        out[first.res] = x_final
        flat = lambda t: t.reshape(batch, -1, t.shape[-1])
        stats = []
        for off in range(len(blocks)):
            loc, scale = post[off][..., :ld], softplus_scale(post[off][..., ld:])
            pr = MultivariateNormalDiag(prior[off][..., :ld],
                                        softplus_scale(prior[off][..., ld:]))
            kl = MultivariateNormalDiag(loc, scale).kl_divergence(pr).sum((1, 2))
            pm = {"raw": flat(masked[off]), "loc": flat(loc.detach()),
                  "scale": flat(scale.detach())}
            stats.append({"kl": kl, "pm": pm})
        return out, stats

    def forward_posterior(self, acts: Acts, masked_acts: Acts, noise: Noise):
        xs, stats = self._bias_state(), []
        specs, i = self.specs, 0
        while i < len(specs):
            # the run at this resolution, a mixin only at its first block
            # (vdvae.py:760-788)
            res, j = specs[i][0], i + 1
            while j < len(specs) and specs[j][0] == res and specs[j][1] is None:
                j += 1
            if (self.fused and j - i >= 2
                    and dec_chain_supported(acts[res].shape[0], res, res, self.cdtype)):
                xs, run_stats = self._fused_run(list(range(i, j)), xs, acts, masked_acts,
                                                noise)
                stats.extend(run_stats)
            else:
                for blk in self.blocks()[i:j]:
                    xs, s = blk.forward_posterior(xs, acts, masked_acts, noise)
                    stats.append(s)
            i = j
        # one batched pm_kl over every block's positions (vdvae.py:790-812)
        ld = self.latent_dim
        raw = torch.cat([s["pm"]["raw"] for s in stats], 1)
        p = MultivariateNormalDiag(torch.cat([s["pm"]["loc"] for s in stats], 1),
                                   torch.cat([s["pm"]["scale"] for s in stats], 1))
        q = MultivariateNormalTriL(raw[..., :ld], fill_scale_tril(raw[..., ld:], ld))
        pm_flat = p.kl_divergence(q)
        start = 0
        for s in stats:
            n = s["pm"]["raw"].shape[1]
            s["pm_kl"] = pm_flat[:, start:start + n].sum(1)
            start += n
            del s["pm"]
        return self._final(xs[self.image_size]), stats

    def forward_partial_posterior(self, masked_acts: Acts, noise: Noise) -> torch.Tensor:
        xs = self._bias_state()
        for blk in self.blocks():
            xs = blk.forward_partial_posterior(xs, masked_acts, noise)
        return self._final(xs[self.image_size])

    def forward_prior(self, num_samples: int, noise: Noise) -> torch.Tensor:
        device = self.gain.device
        xs = {r: b.expand(num_samples, *b.shape[1:]) for r, b in self._bias_state().items()}
        for blk in self.blocks():
            xs = blk.forward_prior(xs, num_samples, noise, device)
        return self._final(xs[self.image_size])

    def forward_lls(self, acts: Acts, masked_acts: Acts, noise: Noise):
        xs, masked_xs, stats = self._bias_state(), self._bias_state(), []
        for blk in self.blocks():
            xs, masked_xs, s = blk.forward_lls(xs, masked_xs, acts, masked_acts, noise)
            stats.append(s)
        return self._final(xs[self.image_size]), self._final(masked_xs[self.image_size]), stats


class PosteriorMatchingVDVAE(nn.Module):
    """Full PM-VDVAE (``vdvae.py:845-965``) on [0, 255] images; the encoders
    see ``x / 127.5 - 1``. ``fused_chain``: ``None``, ``True`` or ``False``,
    as the module docstring says."""

    def __init__(self, image_shape: Tuple[int, int, int], encoder_blocks: str,
                 decoder_blocks: str, latent_dim: int = 16, width: int = 128,
                 bottleneck_multiple: float = 0.25, no_bias_above: int = 64,
                 num_mixtures: int = 10, custom_width_string: Optional[str] = None,
                 fused_chain: Optional[bool] = None, compute_dtype: Optional[str] = None,
                 remat: bool = False):
        super().__init__()
        if fused_chain not in (None, True, False):
            raise NotImplementedError(f"fused_chain={fused_chain!r} is not ported")
        self.image_shape = tuple(image_shape)
        self.compute_dtype, self.remat = compute_dtype, bool(remat)
        cd = torch_dtype(compute_dtype)
        c = self.image_shape[-1]
        chain = fused_chain is not False
        enc = {"chain": chain, "compute_dtype": cd, "remat": self.remat}
        self.encoder = Encoder(c, width, encoder_blocks, bottleneck_multiple,
                               custom_width_string, **enc)
        self.masked_encoder = Encoder(c + 1, width, encoder_blocks, bottleneck_multiple,
                                      custom_width_string, **enc)
        self.decoder = Decoder(latent_dim, self.image_shape[0], c, width, decoder_blocks,
                               bottleneck_multiple, no_bias_above, num_mixtures,
                               custom_width_string, fused=fused_chain is True,
                               compute_dtype=cd)

    @classmethod
    def from_config(cls, config: Dict[str, Any], device=None) -> "PosteriorMatchingVDVAE":
        """From a ``model_config.json`` dict, on ``device`` (the GPU unless
        ``"cpu"``; raises without a GPU)."""
        return cls(**config).to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.decoder.gain.device

    def encode_pair(self, x: torch.Tensor, b: torch.Tensor) -> Tuple[Acts, Acts]:
        scaled = x / 127.5 - 1.0
        return self.encoder(scaled), self.masked_encoder(torch.cat([scaled * b, b], -1))

    def encode_masked(self, x: torch.Tensor, b: torch.Tensor) -> Acts:
        scaled = x / 127.5 - 1.0
        return self.masked_encoder(torch.cat([scaled * b, b], -1))

    def forward(self, x: torch.Tensor, b: torch.Tensor, noise: Noise) -> Dict[str, torch.Tensor]:
        acts, masked_acts = self.encode_pair(x, b)
        px_z, stats = self.decoder.forward_posterior(acts, masked_acts, noise)
        dist = self.decoder.out_net(px_z)
        return {
            "reconstruction_ll": dist.log_prob(x),
            "kl": sum(s["kl"] for s in stats),
            "pm_kl": sum(s["pm_kl"] for s in stats),
            "reconstruction": dist.mean(),
        }

    def decode_lls_once(self, x, b, acts: Acts, masked_acts: Acts, noise: Noise):
        """One importance sample of (log p(x), log p(x_o)) (``vdvae.py:933-953``)."""
        px_z, pxo_z, stats = self.decoder.forward_lls(acts, masked_acts, noise)
        px_dist, pxo_dist = self.decoder.out_net(px_z), self.decoder.out_net(pxo_z)
        pxz_ll = px_dist.log_prob(x)
        per_pixel = pxo_dist.log_prob(x, independent=False)
        pxoz_ll = (per_pixel[..., None] * b).sum(tuple(range(1, b.ndim)))
        total = lambda k: sum(s[k] for s in stats)
        return (pxz_ll + total("pz") - total("qzx"),
                pxoz_ll + total("masked_pz") - total("masked_qzx"))

    def impute_once(self, x, b, masked_acts: Acts, noise: Noise) -> torch.Tensor:
        """One stitched imputation (``vdvae.py:955-960``)."""
        px_z = self.decoder.forward_partial_posterior(masked_acts, noise)
        return torch.where(b == 1, x, self.decoder.out_net(px_z).mean())

    def sample(self, num_samples: int, noise: Noise) -> torch.Tensor:
        """Unconditional samples (``vdvae.py:962-965``)."""
        return self.decoder.out_net(self.decoder.forward_prior(num_samples, noise)).mean()


# ---------------------------------------------------------------------------
# Multi-sample entry points
# ---------------------------------------------------------------------------


def _noise(generator: Optional[torch.Generator], noise: Optional[Noise]) -> Noise:
    if noise is not None:
        return noise
    if generator is None:
        raise ValueError("pass a generator or the noise")
    return generator


@torch.no_grad()
def _is_log_probs_full(model, x, b, num_samples: int, noise: Noise):
    acts, masked_acts = model.encode_pair(x, b)
    px, pxo = zip(*[model.decode_lls_once(x, b, acts, masked_acts, noise)
                    for _ in range(num_samples)])
    px, pxo = logmeanexp(torch.stack(px)), logmeanexp(torch.stack(pxo))
    return px, px - pxo


def vdvae_is_log_probs(model: PosteriorMatchingVDVAE, x: torch.Tensor, b: torch.Tensor,
                       num_samples: int = 100, batch_chunk: Optional[int] = None,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[Noise] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Importance-sampled log p(x) and log p(x_u | x_o) (``vdvae.py:995-1034``).
    With ``batch_chunk`` the batch runs in chunks of that many instances,
    the last padded with the batch's first instances; the chunks draw their
    noise one after another."""
    noise = _noise(generator, noise)
    n = x.shape[0]
    if batch_chunk is None or n <= batch_chunk:
        return _is_log_probs_full(model, x, b, num_samples, noise)
    pad = (-n) % batch_chunk
    if pad:
        x, b = torch.cat([x, x[:pad]]), torch.cat([b, b[:pad]])
    px, ac = zip(*[_is_log_probs_full(model, xc, bc, num_samples, noise)
                   for xc, bc in zip(x.split(batch_chunk), b.split(batch_chunk))])
    return torch.cat(px)[:n], torch.cat(ac)[:n]


@torch.no_grad()
def vdvae_impute(model: PosteriorMatchingVDVAE, x: torch.Tensor, b: torch.Tensor,
                 num_samples: int = 100, generator: Optional[torch.Generator] = None,
                 noise: Optional[Noise] = None) -> torch.Tensor:
    """``[B, num_samples, H, W, C]`` stitched imputations
    (``vdvae.py:1037-1059``): the masked encoder once, the decoder
    ``num_samples`` times."""
    noise = _noise(generator, noise)
    masked_acts = model.encode_masked(x, b)
    return torch.stack([model.impute_once(x, b, masked_acts, noise)
                        for _ in range(num_samples)], 1)

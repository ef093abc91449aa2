"""Plain PyTorch reference of the PM-VQVAE: the frozen VQ-VAE (encoder, codebook
search, decoder), the partial encoder and the conditional gated PixelCNN with one
hierarchy and the (3, 3) receptive field, float32 throughout.

It follows the paper's model as the program states it, layer by layer, with
nothing fused: every gated block is its masked convolutions, dense layers,
concat_elu, hash dropout and sigmoid gate. Parameter names and layouts are the
program's state dict's (torch-layout VQ-VAE convs, flax-layout PixelCNN kernels
``[kh, kw, in, out]`` and dense kernels ``[in, out]``), so one weight dict loads
into both. It imports nothing of the program. TF32 is the caller's to switch off
(:func:`pmbench.reference.precision`).

Departures from a straight reading of the JAX model: none in the arithmetic; the
codebook search takes ``argmax(2 z.e - |e|^2)`` in float64, the exact answer that
a float32 search approximates.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pmbench.reference.dropout import keep_mask


def same_padding(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding (low, high) along one axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """A SAME-padded convolution on NCHW tensors, weight ``[out, in, k, k]``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__()
        self.k, self.stride = k, stride
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ph = same_padding(x.shape[2], self.k, self.stride)
        pw = same_padding(x.shape[3], self.k, self.stride)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, self.weight, self.bias, self.stride)


class ConvTranspose(nn.Module):
    """flax's SAME transposed convolution (``transpose_kernel=False``) as
    ``conv_transpose2d`` with weight ``[in, out, k, k]`` (the flax kernel flipped
    in space)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        pad_len = k + stride - 2
        lo = k - 1 if stride > k - 1 else math.ceil(pad_len / 2)
        if lo != pad_len - lo:
            raise ValueError(f"asymmetric transpose padding for k={k}, s={stride}")
        self.stride, self.padding = stride, k - 1 - lo
        self.weight = nn.Parameter(torch.empty(cin, cout, k, k))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight, self.bias, self.stride, self.padding)


class ResidualStack(nn.Module):
    def __init__(self, hidden: int, blocks: int, res_hidden: int):
        super().__init__()
        self.res3x3 = nn.ModuleList(Conv(hidden, res_hidden, 3) for _ in range(blocks))
        self.res1x1 = nn.ModuleList(Conv(res_hidden, hidden, 1) for _ in range(blocks))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for c3, c1 in zip(self.res3x3, self.res1x1):
            h = h + c1(F.relu(c3(F.relu(h))))
        return F.relu(h)


class Encoder(nn.Module):
    """Two stride-2 4x4 convs, a 3x3 conv and the residual stack: 4x down."""

    def __init__(self, cin: int, hidden: int, blocks: int, res_hidden: int):
        super().__init__()
        self.enc_1 = Conv(cin, hidden // 2, 4, 2)
        self.enc_2 = Conv(hidden // 2, hidden, 4, 2)
        self.enc_3 = Conv(hidden, hidden, 3)
        self.stack = ResidualStack(hidden, blocks, res_hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.enc_1(x))
        h = F.relu(self.enc_2(h))
        return self.stack(F.relu(self.enc_3(h)))


class Decoder(nn.Module):
    def __init__(self, cin: int, hidden: int, blocks: int, res_hidden: int, cout: int):
        super().__init__()
        self.log_scale = nn.Parameter(torch.empty(()))
        self.dec_1 = Conv(cin, hidden, 3)
        self.stack = ResidualStack(hidden, blocks, res_hidden)
        self.dec_2 = ConvTranspose(hidden, hidden // 2, 4, 2)
        self.dec_3 = ConvTranspose(hidden // 2, cout, 4, 2)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.dec_3(F.relu(self.dec_2(self.stack(self.dec_1(z)))))


class Quantizer(nn.Module):
    """The codebook and the EMA statistics a trained VQ-VAE carries."""

    def __init__(self, num_embeddings: int, dim: int):
        super().__init__()
        self.register_buffer("embeddings", torch.empty(num_embeddings, dim))
        self.register_buffer("ema_cluster_size", torch.empty(num_embeddings))
        self.register_buffer("ema_dw", torch.empty(num_embeddings, dim))


class VQVAE(nn.Module):
    def __init__(self, vq: Dict):
        super().__init__()
        hid, blocks, res = vq["hidden_units"], vq["residual_blocks"], vq["residual_hidden_units"]
        self.encoder = Encoder(vq["output_channels"], hid, blocks, res)
        self.pre_vq_conv = Conv(hid, vq["embedding_dim"], 1)
        self.vq = Quantizer(vq["num_embeddings"], vq["embedding_dim"])
        self.decoder = Decoder(vq["embedding_dim"], hid, blocks, res, vq["output_channels"])

    def codes(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, H, W, C]`` images -> ``[B, H/4, W/4]`` nearest codebook entries,
        the distances taken in float64: a float32 search can flip a near tie
        (one of 24,576 codes, a float64 margin of 7e-9, was seen to)."""
        z = self.pre_vq_conv(self.encoder(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        flat = z.reshape(-1, z.shape[-1]).double()
        cb = self.vq.embeddings.double()
        scores = 2.0 * (flat @ cb.T) - (cb * cb).sum(-1)[None, :]
        return scores.argmax(-1).reshape(z.shape[:-1])

    def decode_indices(self, codes: torch.Tensor) -> torch.Tensor:
        """``[B, h, w]`` codes -> ``[B, 4h, 4w, C]`` decoder means."""
        q = self.vq.embeddings[codes.long()].permute(0, 3, 1, 2)
        return self.decoder(q).permute(0, 2, 3, 1)


class Dense(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(cin, cout))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class PartialEncoder(nn.Module):
    """``[x * b, b]`` -> the condition vector: the conv encoder, then a dense
    layer over the NHWC-flattened features."""

    def __init__(self, vq: Dict, image_hw: Tuple[int, int], cond_dim: int):
        super().__init__()
        hid = vq["hidden_units"]
        self.encoder = Encoder(vq["output_channels"] + 1, hid, vq["residual_blocks"],
                               vq["residual_hidden_units"])
        h, w = -(-image_hw[0] // 4), -(-image_hw[1] // 4)
        self.dense = Dense(h * w * hid, cond_dim)

    def forward(self, x_o_b: torch.Tensor) -> torch.Tensor:
        h = self.encoder(x_o_b.permute(0, 3, 1, 2))
        return self.dense(h.permute(0, 2, 3, 1).reshape(h.shape[0], -1))


class KernelBias(nn.Module):
    def __init__(self, *shape: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(shape[-1]))


def elu(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z > 0, z, torch.exp(torch.clamp(z, max=0.0)) - 1.0)


def concat_elu(z: torch.Tensor) -> torch.Tensor:
    return torch.cat([elu(z), elu(-z)], dim=-1)


def masked_conv(x: torch.Tensor, layer: KernelBias, kernel_size, rows, cols) -> torch.Tensor:
    """The stride-1 masked conv on NHWC ``x``: the kernel cut to its causal
    taps ``rows x cols``, SAME padding shifted by the cut (negative crops)."""
    kh, kw = kernel_size
    (r0, r1), (c0, c1) = rows, cols
    pads = (kw // 2 - c0, (c1 - 1) - kw // 2, kh // 2 - r0, (r1 - 1) - kh // 2)
    w = layer.kernel[r0:r1, c0:c1].permute(3, 2, 0, 1)
    out = F.conv2d(F.pad(x.permute(0, 3, 1, 2), pads), w, layer.bias)
    return out.permute(0, 2, 3, 1)


# causal taps of a gated block's convs (rows, cols) and the kernel they are cut from
_BLOCK_TAPS = {"vertical": ((3, 3), (0, 2), (0, 3)), "horizontal": ((3, 3), (0, 2), (0, 2))}


class PixelCNN(nn.Module):
    """The conditional gated PixelCNN, one hierarchy: an up pass of
    ``num_resnet`` gated block pairs, a down pass of as many taking the up
    pass's outputs as skips in reverse, a 1x1 logits head over ``num_indices``."""

    def __init__(self, num_indices: int, num_resnet: int, num_filters: int, cond_dim: int,
                 dropout: float):
        super().__init__()
        f = num_filters
        self.n, self.f, self.dropout = num_resnet, f, dropout
        self.embed = nn.Parameter(torch.empty(num_indices, f))
        layers = {"v_init": KernelBias(5, 3, f, f), "h_init_up": KernelBias(3, 3, f, f),
                  "h_init_left": KernelBias(3, 3, f, f),
                  "logits_conv": KernelBias(1, 1, f, num_indices)}
        for d in ("up", "dn"):
            for r in range(num_resnet):
                for stack in ("vertical", "horizontal"):
                    tag = f"{d}_0_{r}_{stack}"
                    layers[f"{tag}_conv_a"] = KernelBias(3, 3, 2 * f, f)
                    layers[f"{tag}_conv_b"] = KernelBias(3, 3, 2 * f, 2 * f)
                    layers[f"{tag}_cond_proj"] = KernelBias(cond_dim, 2 * f)
                    aux = {("up", "horizontal"): f, ("dn", "vertical"): f,
                           ("dn", "horizontal"): 2 * f}.get((d, stack))
                    if aux is not None:
                        layers[f"{tag}_aux"] = KernelBias(2 * aux, f)
        self.layers = nn.ModuleDict(layers)

    def _block(self, tag: str, stack: str, x, aux, cond, keep: float, seed: int, block_id: int):
        ks, rows, cols = _BLOCK_TAPS[stack]
        a = masked_conv(concat_elu(x), self.layers[f"{tag}_conv_a"], ks, rows, cols)
        if aux is not None:
            lay = self.layers[f"{tag}_aux"]
            a = a + concat_elu(aux) @ lay.kernel + lay.bias
        a = concat_elu(a)
        if keep < 1.0:
            b, h, w, c2 = a.shape
            m = keep_mask(seed, block_id, b, h, w, c2, keep, a.device) != 0
            a = torch.where(m, a / keep, torch.zeros_like(a))
        out = masked_conv(a, self.layers[f"{tag}_conv_b"], ks, rows, cols)
        lay = self.layers[f"{tag}_cond_proj"]
        out = out + (cond @ lay.kernel + lay.bias)[:, None, None, :]
        act, gate = out.split(self.f, -1)
        return x + torch.sigmoid(gate) * act

    def forward(self, codes: torch.Tensor, cond: torch.Tensor, keep: float = 1.0,
                seed: int = 0) -> torch.Tensor:
        """``[B, H, W]`` codes and ``[B, D]`` conditions -> ``[B, H, W, K]`` logits."""
        lay = self.layers
        h0 = self.embed[codes.long()]
        vs = [masked_conv(h0, lay["v_init"], (5, 3), (0, 2), (0, 3))]
        hs = [masked_conv(h0, lay["h_init_up"], (3, 3), (0, 1), (0, 3))
              + masked_conv(h0, lay["h_init_left"], (3, 3), (0, 2), (0, 1))]
        block = 0
        for r in range(self.n):
            vs.append(self._block(f"up_0_{r}_vertical", "vertical", vs[-1], None, cond, keep,
                                  seed, block))
            hs.append(self._block(f"up_0_{r}_horizontal", "horizontal", hs[-1], vs[-1], cond,
                                  keep, seed, block + 1))
            block += 2
        v, h = vs.pop(), hs.pop()
        for r in range(self.n):
            v = self._block(f"dn_0_{r}_vertical", "vertical", v, vs.pop(), cond, keep, seed,
                            block)
            h = self._block(f"dn_0_{r}_horizontal", "horizontal", h,
                            torch.cat([v, hs.pop()], -1), cond, keep, seed, block + 1)
            block += 2
        head = lay["logits_conv"]
        return F.elu(h) @ head.kernel[0, 0] + head.bias


class PMVQVAE(nn.Module):
    def __init__(self, config: Dict):
        super().__init__()
        vq, pc = config["vqvae"], config["pixel_cnn"]
        h, w = pc["image_shape"]
        self.vqvae = VQVAE(vq)
        self.partial_encoder = PartialEncoder(vq, (4 * h, 4 * w), config["conditional_dim"])
        self.pixel_cnn = PixelCNN(vq["num_embeddings"], pc["num_resnet"], pc["num_filters"],
                                  config["conditional_dim"], pc["dropout"])

    def condition(self, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.partial_encoder(torch.cat([x * b, b], -1))

    def log_prob(self, x: torch.Tensor, b: torch.Tensor, training: bool,
                 seed: int) -> torch.Tensor:
        """Per-image log-likelihood of the codes of ``x`` given ``x * b``: ``[B]``."""
        with torch.no_grad():
            codes = self.vqvae.codes(x)
        keep = 1.0 - self.pixel_cnn.dropout if training else 1.0
        logits = self.pixel_cnn(codes, self.condition(x, b), keep, seed)
        lls = torch.log_softmax(logits, -1).gather(-1, codes.long()[..., None])[..., 0]
        return lls.sum((1, 2))


def build(config: Dict, device) -> PMVQVAE:
    """The reference with uninitialised weights on ``device`` (``"meta"`` for
    shapes alone)."""
    with torch.device("meta"):
        model = PMVQVAE(config)
    return model if torch.device(device).type == "meta" else model.to_empty(device=device)


def trainable(name: str) -> bool:
    """Stage 2 trains everything but the frozen VQ-VAE."""
    return not name.startswith("vqvae.")


def init_scales(config: Dict, model: PMVQVAE) -> Dict[str, Tuple[str, float]]:
    """How each tensor of ``model`` is drawn: ``(kind, scale)`` with kind
    ``normal`` (scale times a standard normal), ``uniform`` (on [-scale, scale])
    or ``zero``. Kernels at 1/sqrt(fan-in), the partial encoder's condition
    projections at 1, biases at 0.01, the embedding at 1/sqrt(F), the codebook
    as the VQ-VAE inits it."""
    out = {}
    for name, t in model.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if name == "vqvae.vq.embeddings":
            out[name] = ("uniform", math.sqrt(3.0 / t.shape[1]))
        elif name in ("vqvae.vq.ema_cluster_size", "vqvae.vq.ema_dw", "vqvae.decoder.log_scale"):
            out[name] = ("zero", 0.0)
        elif name == "pixel_cnn.embed":
            out[name] = ("normal", 1.0 / math.sqrt(t.shape[1]))
        elif leaf == "bias":
            out[name] = ("normal", 0.01)
        elif name.endswith("cond_proj.kernel"):
            out[name] = ("normal", 1.0 / math.sqrt(t.shape[0]))
        elif leaf == "kernel":
            out[name] = ("normal", 1.0 / math.sqrt(math.prod(t.shape[:-1])))
        elif leaf == "weight" and ".dec_" in name and name.endswith(("dec_2.weight",
                                                                     "dec_3.weight")):
            out[name] = ("normal", 1.0 / math.sqrt(t.shape[0] * t.shape[2] * t.shape[3] / 4))
        elif leaf == "weight":
            out[name] = ("normal", 1.0 / math.sqrt(math.prod(t.shape[1:])))
        else:
            raise KeyError(f"no init rule for {name}")
    return out

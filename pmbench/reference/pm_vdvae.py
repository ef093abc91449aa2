"""Plain PyTorch reference of the PM-VDVAE's training objective, float32: two
bottleneck-block encoders (the image, and the masked image with its mask), the
top-down decoder whose every block has a diagonal posterior, a diagonal prior that
also updates the state, a full-covariance (TriL) masked posterior fed a
stop-gradient of the state, the z projection and a residual block; a discretized
mixture of logistics over the pixels. Every block runs on its own, in order:
nothing is fused.

The loss is ``-mean(reconstruction_ll - kl) + mean(pm_kl)`` with
``pm_kl = KL(stop_grad(posterior) || masked_posterior)``. A block's standard
normals are drawn from the loss's generator when the block samples, in decoder
order. Parameter names and flax layouts (kernels ``[k, k, in, out]``) are the
program's, so one weight dict loads into both. It imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

LOG_2PI = math.log(2.0 * math.pi)


def parse_layers(s: str) -> List[Tuple[int, Optional[int]]]:
    """'28x6,28d2,3m1' -> [(resolution, down rate or mixin or None), ...]."""
    out = []
    for part in s.split(","):
        if "x" in part:
            res, num = part.split("x")
            out += [(int(res), None)] * int(num)
        elif "m" in part or "d" in part:
            res, other = part.replace("m", "d").split("d")
            out.append((int(res), int(other)))
        else:
            out.append((int(part), None))
    return out


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class Conv(nn.Module):
    """A SAME k x k convolution (VALID 1 x 1) on NHWC tensors, flax layout."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.k = k
        self.kernel = nn.Parameter(torch.empty(k, k, cin, cout))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.k == 1:
            return x @ self.kernel[0, 0] + self.bias
        y = F.conv2d(x.permute(0, 3, 1, 2), self.kernel.permute(3, 2, 0, 1), self.bias,
                     padding=self.k // 2)
        return y.permute(0, 2, 3, 1)


class Block(nn.Module):
    """gelu -> 1x1 -> gelu -> kxk -> gelu -> kxk -> gelu -> 1x1, an optional
    residual, an optional average-pool down."""

    def __init__(self, cin, mid, cout, down=None, residual=False, k=3):
        super().__init__()
        self.down, self.residual = down, residual
        self.c1, self.c2 = Conv(cin, mid, 1), Conv(mid, mid, k)
        self.c3, self.c4 = Conv(mid, mid, k), Conv(mid, cout, 1)

    def forward(self, x):
        h = self.c4(gelu(self.c3(gelu(self.c2(gelu(self.c1(gelu(x))))))))
        out = x + h if self.residual else h
        if self.down:
            out = F.avg_pool2d(out.permute(0, 3, 1, 2), self.down, self.down).permute(0, 2, 3, 1)
        return out


class Encoder(nn.Module):
    def __init__(self, cin: int, width: int, blocks: str, bm: float):
        super().__init__()
        self.specs = parse_layers(blocks)
        self.width = width
        self.in_conv = Conv(cin, width, 3)
        for i, (res, down) in enumerate(self.specs):
            setattr(self, f"block_{i}", Block(width, int(width * bm), width, down, True,
                                              3 if res > 2 else 1))

    def forward(self, x) -> Dict[int, torch.Tensor]:
        h = self.in_conv(x)
        acts = {h.shape[1]: h}
        for i in range(len(self.specs)):
            h = getattr(self, f"block_{i}")(h)
            acts[h.shape[1]] = h
        return acts


def softplus_scale(x):
    return F.softplus(x) + 1e-5


def scale_tril(raw: torch.Tensor, k: int) -> torch.Tensor:
    """Row-major lower triangle from ``raw``, its diagonal ``softplus + 1e-5``."""
    rows, cols = torch.tril_indices(k, k, device=raw.device)
    t = raw.new_zeros((*raw.shape[:-1], k, k))
    t[..., rows, cols] = raw
    d = torch.diagonal(t, dim1=-2, dim2=-1)
    return t - torch.diag_embed(d) + torch.diag_embed(F.softplus(d) + 1e-5)


def kl_diag(loc_p, scale_p, loc_q, scale_q):
    """KL(N(loc_p, scale_p^2) || N(loc_q, scale_q^2)), summed over the last axis."""
    ratio = (scale_p / scale_q) ** 2
    return 0.5 * (ratio + ((loc_p - loc_q) / scale_q) ** 2 - 1.0 - torch.log(ratio)).sum(-1)


def kl_diag_tril(loc_p, scale_p, loc_q, tril_q):
    """KL(N(loc_p, diag(scale_p)^2) || N(loc_q, L L^T)) by one triangular solve."""
    k = tril_q.shape[-1]
    rhs = torch.cat([torch.diag_embed(scale_p), (loc_q - loc_p)[..., None]], -1)
    m = torch.linalg.solve_triangular(tril_q, rhs, upper=False)
    log_det_q = torch.log(torch.diagonal(tril_q, dim1=-2, dim2=-1)).sum(-1)
    return 0.5 * ((m * m).sum((-2, -1)) - k) + log_det_q - torch.log(scale_p).sum(-1)


class DecoderBlock(nn.Module):
    def __init__(self, ld: int, res: int, mixin: Optional[int], width: int, bm: float):
        super().__init__()
        self.res, self.mixin, self.ld, self.w = res, mixin, ld, width
        mid, k = int(width * bm), 3 if res > 2 else 1
        self.posterior = Block(2 * width, mid, 2 * ld, k=k)
        self.masked_posterior = Block(2 * width, mid, ld + ld * (ld + 1) // 2, k=k)
        self.prior = Block(width, mid, 2 * ld + width, k=k)
        self.z_proj = Conv(ld, width, 1)
        self.resnet = Block(width, mid, width, residual=True, k=k)

    def forward(self, xs, acts, masked_acts, gen):
        a, ma = acts[self.res], masked_acts[self.res]
        x = xs[self.res] if self.res in xs else torch.zeros_like(a)
        if x.shape[0] != a.shape[0]:
            x = x.expand(a.shape[0], *x.shape[1:])
        if self.mixin is not None:
            up = xs[self.mixin][..., :x.shape[-1]].permute(0, 3, 1, 2)
            x = x + F.interpolate(up, size=(self.res, self.res),
                                  mode="nearest-exact").permute(0, 2, 3, 1)
        ld = self.ld
        post = self.posterior(torch.cat([x, a], -1))
        loc, scale = post[..., :ld], softplus_scale(post[..., ld:])
        masked = self.masked_posterior(torch.cat([x.detach(), ma], -1))
        pri = self.prior(x)
        x = x + pri[..., -self.w:]
        eps = (torch.randn(loc.shape, generator=gen, device=gen.device) if gen is not None
               else torch.zeros_like(loc))
        z = loc + scale * eps
        kl = kl_diag(loc, scale, pri[..., :ld], softplus_scale(pri[..., ld:2 * ld])).sum((1, 2))
        out = dict(xs)
        out[self.res] = self.resnet(x + self.z_proj(z))
        flat = lambda t: t.reshape(t.shape[0], -1, t.shape[-1])  # noqa: E731
        return out, kl, (flat(masked), flat(loc.detach()), flat(scale.detach()))


class Decoder(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        width, ld = cfg["width"], cfg["latent_dim"]
        self.specs = parse_layers(cfg["decoder_blocks"])
        self.image_size, self.ld = cfg["image_shape"][0], ld
        for i, (res, mixin) in enumerate(self.specs):
            setattr(self, f"block_{i}", DecoderBlock(ld, res, mixin, width,
                                                     cfg["bottleneck_multiple"]))
        self.bias_res = [r for r in sorted({r for r, _ in self.specs})
                         if r <= cfg["no_bias_above"]]
        for r in self.bias_res:
            self.register_parameter(f"x_bias_{r}", nn.Parameter(torch.empty(1, r, r, width)))
        self.out_net = nn.Module()
        c, m = cfg["image_shape"][-1], cfg["num_mixtures"]
        self.out_net.params_conv = Conv(width, m * (2 * c + c * (c - 1) // 2 + 1), 1)
        self.gain = nn.Parameter(torch.empty(1, 1, 1, width))
        self.bias = nn.Parameter(torch.empty(1, 1, 1, width))

    def forward(self, acts, masked_acts, gen):
        xs = {r: getattr(self, f"x_bias_{r}") for r in self.bias_res}
        kls, pms = [], []
        for i in range(len(self.specs)):
            xs, kl, pm = getattr(self, f"block_{i}")(xs, acts, masked_acts, gen)
            kls.append(kl)
            pms.append(pm)
        raw, loc, scale = (torch.cat([p[j] for p in pms], 1) for j in range(3))
        ld = self.ld
        pm_kl = kl_diag_tril(loc, scale, raw[..., :ld], scale_tril(raw[..., ld:], ld))
        return xs[self.image_size] * self.gain + self.bias, sum(kls), pm_kl.sum(1)


def dmol_log_prob(params: torch.Tensor, x: torch.Tensor, m: int) -> torch.Tensor:
    """Log-likelihood of one-channel integer pixels ``x [B, H, W, 1]`` in [0, 255]
    under the discretized mixture of ``m`` logistics ``params [B, H, W, 3m]``,
    summed over the image."""
    p = params.reshape(*params.shape[:-1], m, 3)
    logits, locs, scales = p[..., 0], p[..., 1], F.softplus(p[..., 2]) + math.exp(-7.0)
    locs, scales = 127.5 * (locs + 1.0), scales * 127.5
    v = x
    plus, minus = (v + 0.5 - locs) / scales, (v - 0.5 - locs) / scales
    mid = torch.log(torch.clamp(torch.sigmoid(plus) - torch.sigmoid(minus), min=1e-12))
    lp = torch.where(v <= 0.0, F.logsigmoid(plus), torch.where(v >= 255.0, F.logsigmoid(-minus),
                                                               mid))
    return torch.logsumexp(lp + F.log_softmax(logits, -1), -1).sum((-2, -1))


class PMVDVAE(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        m = cfg["model"]
        c = m["image_shape"][-1]
        if c != 1:
            raise ValueError("the reference's likelihood head takes one channel")
        self.m = m
        self.encoder = Encoder(c, m["width"], m["encoder_blocks"], m["bottleneck_multiple"])
        self.masked_encoder = Encoder(c + 1, m["width"], m["encoder_blocks"],
                                      m["bottleneck_multiple"])
        self.decoder = Decoder(m)

    def loss(self, x: torch.Tensor, b: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        """The training loss on ``[0, 255]`` images ``x`` and masks ``b``, its
        normals from ``gen`` (zeros without one: for counting work)."""
        s = x / 127.5 - 1.0
        acts, masked_acts = self.encoder(s), self.masked_encoder(torch.cat([s * b, b], -1))
        h, kl, pm_kl = self.decoder(acts, masked_acts, gen)
        rec = dmol_log_prob(self.decoder.out_net.params_conv(h), x, self.m["num_mixtures"])
        return -(rec - kl).mean() + pm_kl.mean()


def build(cfg: Dict, device) -> PMVDVAE:
    with torch.device("meta"):
        model = PMVDVAE(cfg)
    return model if torch.device(device).type == "meta" else model.to_empty(device=device)


def init_scales(cfg: Dict, model: PMVDVAE) -> Dict[str, Tuple[str, float]]:
    """Kernels 1/sqrt(fan-in), the encoders' last convs times sqrt(1 / blocks),
    the decoder's residual last convs and z projections times sqrt(1 / blocks),
    the other heads' last convs times 0.3; biases and bias inputs 0.02 N(0, 1); the
    gain 1 (no noise: a constant fills it)."""
    m = cfg["model"]
    enc = math.sqrt(1.0 / len(parse_layers(m["encoder_blocks"])))
    dec = math.sqrt(1.0 / len(parse_layers(m["decoder_blocks"])))
    out = {}
    for name, t in model.state_dict().items():
        parts = name.split(".")
        if parts[-1] == "kernel":
            s = 1.0 / math.sqrt(math.prod(t.shape[:-1]))
            if parts[-2] == "c4" and "encoder" in parts[0]:
                s *= enc
            elif (parts[-2] == "c4" and parts[-3] == "resnet") or parts[-2] == "z_proj":
                s *= dec
            elif parts[-2] == "c4":
                s *= 0.3
            out[name] = ("normal", s)
        elif parts[-1] == "gain":
            out[name] = ("one", 1.0)
        else:
            out[name] = ("normal", 0.02)
    return out

"""Work of the PM-VDVAE's chain kernels in one training step, from the cell's
shapes, copied from the port's wrappers (``block_chain.chain_flops``,
``decoder_chain.chain_flops`` and ``bwd_flops``): each multiply-add counted once
(2 FLOPs), a k x k conv only at the taps that land inside the image, a backward
each product twice (the decoder chain's masked Block without its data gradient on
the state). Bytes: each input read once and each output written once, float32.
The runs are those the model fuses: every run of two or more non-downsampling
blocks at one resolution, in both encoders (the block chain) and, with
``fused_chain``, in the decoder (the decoder chain)."""
from __future__ import annotations

from pmbench.reference.pm_vdvae import parse_layers
from pmbench.work.peaks import bound_s


def tap_pixels(h: int, w: int, k: int) -> int:
    pad = k // 2
    return sum(max(h - abs(dy), 0) * max(w - abs(dx), 0)
               for dy in range(-pad, pad + 1) for dx in range(-pad, pad + 1))


def block_run(b, res, c, mid, k, n):
    """(forward FLOPs, forward bytes, backward FLOPs, backward bytes) of a run."""
    flops = 2.0 * n * b * (2 * res * res * c * mid + 2 * tap_pixels(res, res, k) * mid * mid)
    act = b * res * res * c
    wts = n * (2 * c * mid + 2 * k * k * mid * mid + 2 * mid + c)
    return flops, 4.0 * (2 * act + wts), 2 * flops, 4.0 * (3 * act + 2 * wts)


def decoder_run(b, res, c, mid, ld, k, n):
    rows, mw = b * res * res, ld + ld * (ld + 1) // 2
    per = (2 * rows * mid * 6 * c + 4 * 2 * 2 * b * tap_pixels(res, res, k) * mid * mid
           + 2 * rows * mid * (2 * ld + mw + 2 * ld + c + c) + 2 * rows * ld * c)
    flops = float(n * per)
    bwd = 2 * flops - 2.0 * n * rows * c * mid
    outs = n * rows * (2 * ld + mw + 2 * ld + c)
    wts = n * (mid * (6 * c + 2 * ld + mw + 2 * ld + 2 * c) + 8 * k * k * mid * mid + ld * c)
    ins = 3 * rows * c + n * rows * ld
    return flops, 4.0 * (ins + outs + rows * c + wts), bwd, 4.0 * (2 * (ins + outs) + 2 * wts)


def runs(spec: str, decoder: bool):
    """(resolution, blocks) of each fused run of a block string."""
    layers, out, i = parse_layers(spec), [], 0
    while i < len(layers):
        res, j = layers[i][0], i + 1
        if decoder or layers[i][1] is None:
            while j < len(layers) and layers[j][0] == res and layers[j][1] is None:
                j += 1
        if j - i >= 2:
            out.append((res, j - i))
        i = j
    return out


def train_step_bound_s(cfg) -> float:
    """The least seconds of one step's chain launches, forward and backward."""
    m, b = cfg["model"], cfg["data"]["train_batch_size"]
    c, mid, ld = m["width"], int(m["width"] * m["bottleneck_multiple"]), m["latent_dim"]
    total = 0.0
    for res, n in runs(m["encoder_blocks"], False):
        f, fb, g, gb = block_run(b, res, c, mid, 3 if res > 2 else 1, n)
        total += 2 * (bound_s(f, fb) + bound_s(g, gb))     # two encoders
    if cfg.get("fused_chain"):
        for res, n in runs(m["decoder_blocks"], True):
            f, fb, g, gb = decoder_run(b, res, c, mid, ld, 3 if res > 2 else 1, n)
            total += bound_s(f, fb) + bound_s(g, gb)
    return total

"""Work of the PixelCNN's gated chain kernels (the stream forward and backward,
one launch a pass), from the cell's shapes. Each useful multiply-add is counted
once (2 FLOPs), at the conv taps that land inside the image; a backward does
each product twice (data and weight gradients). Bytes: each input read once and
each output written once, float32. Copied from the shape arithmetic of the
port's chip smoke (``stream_work``), without its TF32 pass count."""
from __future__ import annotations

from pmbench.work.peaks import bound_s

# (taps high, taps wide, pad top, pad left) of the vertical and horizontal
# stacks' causal 3x3 convs: 2 x 3 and 2 x 2 taps
VERTICAL, HORIZONTAL = (2, 3, 1, 1), (2, 2, 1, 1)


def in_image_taps(tp, h: int, w: int) -> int:
    """(position, tap) pairs of an ``h x w`` image whose tap reads inside it."""
    skh, skw, top, left = tp
    return sum(max(h - abs(i - top), 0) * max(w - abs(j - left), 0)
               for i in range(skh) for j in range(skw))


def stream_flops(b, h, w, f, levels, cond_dim, down):
    """(forward, backward) FLOPs of one pass of ``levels`` gated levels: each
    block's conv_a ([2F, F]) and conv_b ([2F, 2F]) at its in-image taps, the
    aux products ([2F, F] up; [2F, F] and [4F, F] down) at every position, the
    condition projections ([D, 2F] per block)."""
    taps = in_image_taps(VERTICAL, h, w) + in_image_taps(HORIZONTAL, h, w)
    per_image = taps * 6 * f * f + h * w * 2 * f * f
    if down:
        per_image += h * w * 2 * (2 * f * f)
    fwd = 2.0 * b * levels * per_image + 2.0 * 2 * levels * b * cond_dim * 2 * f
    return fwd, 2.0 * fwd


def weight_floats(f, levels, cond_dim, down):
    per_level = (6 + 4) * (2 * f * f + 4 * f * f) + 2 * cond_dim * 2 * f + 2 * (3 * f)
    per_level += (2 * f * f + 4 * f * f + 2 * f) if down else (2 * f * f + f)
    return levels * per_level


def stream_bytes(b, h, w, f, levels, cond_dim, down):
    """(forward, backward) bytes: the forward reads the two init stacks, the
    skips (down), the condition and the weights, and writes every level's two
    outputs; the backward reads those, the outputs' gradients and the weights,
    and writes the inputs', the skips', the condition's and the weights'
    gradients."""
    act = b * h * w * f
    skips = 2 * levels * act if down else 0
    wts = weight_floats(f, levels, cond_dim, down)
    fwd = 2 * act + skips + b * cond_dim + wts + 2 * levels * act
    bwd = (2 * levels * act) * 2 + 2 * act + skips + b * cond_dim + wts \
        + 2 * act + skips + b * cond_dim + wts
    return 4.0 * fwd, 4.0 * bwd


def train_step_bound_s(cfg) -> float:
    """The least seconds of one training step's chain launches: the up and the
    down pass, forward and backward."""
    pc = cfg["pixel_cnn"]
    b = cfg["data"]["train_batch_size"]
    (h, w), f, n, d = pc["image_shape"], pc["num_filters"], pc["num_resnet"], cfg["conditional_dim"]
    total = 0.0
    for down in (False, True):
        flops = stream_flops(b, h, w, f, n, d, down)
        nbytes = stream_bytes(b, h, w, f, n, d, down)
        total += bound_s(flops[0], nbytes[0]) + bound_s(flops[1], nbytes[1])
    return total

"""Work of the raster sampler's kernels at one image row (``sampler_vrow``, the
vertical stack's row; ``sampler_row``, the horizontal stack's row with the logits
and the Gumbel-max draw), from the cell's shapes, copied from the port's chip
smoke: each useful float32 multiply-add counted once (2 FLOPs), at the conv taps
that land inside the image, as ``gated_chain.py`` counts them: not the column taps
off a row's ends, nor the taps of rows above the first. The up levels' second aux
input, always zero, is not counted. Bytes: the carried state of every level read
and written once, the weights read once, float32."""
from __future__ import annotations

from pmbench.work.gated_chain import HORIZONTAL, VERTICAL
from pmbench.work.peaks import bound_s

# (taps high, taps wide, pad top, pad left) of the row kernels' other convs: the
# vertical stack's input conv over the codes of rows r-2 and r-1, the horizontal
# stack's up input over row r-1, and its left input at (r-1, c-1) and (r, c-1)
V_INPUT, H_UP, H_LEFT = (2, 3, 2, 1), (1, 3, 1, 1), (2, 1, 1, 1)


def row_taps(tp, r: int, w: int) -> int:
    """(position, tap) pairs of image row ``r`` (``w`` wide) whose tap reads
    inside the image; summed over the rows, ``gated_chain.in_image_taps``."""
    skh, skw, top, left = tp
    return sum(max(w - abs(j - left), 0)
               for i in range(skh) if r + i - top >= 0 for j in range(skw))


def vrow_flops(n, r, w, f, levels):
    """Image row ``r``: the input convs ([F, F] a tap), each level's conv_a
    ([2F, F] a tap) and conv_b ([2F, 2F] a tap), the down levels' aux ([2F, F])."""
    taps = row_taps(V_INPUT, r, w) + row_taps(H_UP, r, w)
    return 2.0 * n * (taps * f * f + levels * row_taps(VERTICAL, r, w) * 6 * f * f
                      + levels // 2 * w * 2 * f * f)


def row_flops(n, r, w, f, levels, k):
    """Image row ``r``: the left input ([F, F] a tap), each level's conv_a ([2F, F]
    a tap) and conv_b ([2F, 2F] a tap), its aux ([2F, F]; the down levels' skip
    another [2F, F]), the logits ([F, K])."""
    return 2.0 * n * (row_taps(H_LEFT, r, w) * f * f
                      + levels * row_taps(HORIZONTAL, r, w) * 6 * f * f
                      + (levels + levels // 2) * w * 2 * f * f + w * f * k)


def vrow_bytes(n, w, f, levels, cond_dim):
    state = levels * w * n * (f + 2 * f)
    wts = levels * (6 * 2 * f * f + 6 * 4 * f * f + 2 * f * f + cond_dim * 2 * f) + 9 * f * f
    return 4.0 * (2 * state + 3 * w * n * f + wts)


def row_bytes(n, w, f, levels, cond_dim, k):
    state = levels * w * n * (f + 2 * f)
    wts = levels * (4 * 2 * f * f + 4 * 4 * f * f + 6 * f * f + cond_dim * 2 * f) + f * k
    return 4.0 * (2 * state + w * n * (2 * f + k) + wts)


def request_bound_s(cfg, traffic) -> float:
    """The least seconds of one request's sampler launches: one vrow and one
    row launch an image row."""
    pc = cfg["pixel_cnn"]
    (h, w), f = pc["image_shape"], pc["num_filters"]
    levels, k, d = 2 * pc["num_resnet"], cfg["vqvae"]["num_embeddings"], cfg["conditional_dim"]
    n = traffic["batch"] * traffic["samples"]
    return sum(bound_s(vrow_flops(n, r, w, f, levels), vrow_bytes(n, w, f, levels, d))
               + bound_s(row_flops(n, r, w, f, levels, k), row_bytes(n, w, f, levels, d, k))
               for r in range(h))

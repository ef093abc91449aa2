"""The widths the PixelCNN kernels are built for, on the CPU.

The gated chain's and the samplers' CUDA sources are compiled for the
num_filters of their dispatch macros (``GSK_DISPATCH_WIDTHS`` in
``csrc/gated_common.cuh``, ``PMK_DISPATCH_WIDTHS`` in
``csrc/sampler_common.cuh``): the wrappers' ``KERNEL_WIDTHS`` must name the
same widths. A wrapper given CUDA tensors of another width (or, for the row
kernel, a codebook that is not a multiple of its 128-column logits chunk)
raises an error that names what is built, before it loads or launches
anything: it never runs the plain version instead. The CUDA path is taken
here on CPU tensors by telling the wrappers the tensors are on the card; the
refusal comes before any use of the device.
"""
import re

import pytest
import torch

from posterior_matching_torch.ops import _build, gated_chain as gc, sampler_chain as sc
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

UNBUILT = 96
BUILT = re.escape(str(gc.KERNEL_WIDTHS))


def _dispatched(header: str, macro: str):
    text = (_build.CSRC / header).read_text()
    body = text[text.index(f"#define {macro}"):]
    body = body[: body.index("while (0)")]
    return tuple(sorted(int(f) for f in re.findall(r"constexpr int F = (\d+);", body)))


def test_wrappers_name_the_widths_the_sources_dispatch():
    assert gc.KERNEL_WIDTHS == sc.KERNEL_WIDTHS == (64, 128)
    assert _dispatched("gated_common.cuh", "GSK_DISPATCH_WIDTHS") == gc.KERNEL_WIDTHS
    assert _dispatched("sampler_common.cuh", "PMK_DISPATCH_WIDTHS") == sc.KERNEL_WIDTHS
    gated = (_build.CSRC / "gated_common.cuh").read_text()
    built = re.search(r"bool width_built\(int f\) \{ return (.*?); \}", gated).group(1)
    assert tuple(sorted(int(f) for f in re.findall(r"f == (\d+)", built))) == gc.KERNEL_WIDTHS


@pytest.mark.parametrize("f", gc.KERNEL_WIDTHS)
def test_gated_geometry_ints_end_with_the_width(f):
    xv0, cond = torch.zeros(2, 4, 4, f), torch.zeros(2, 16)
    cfg = gc.StreamConfig(xv0, cond, 3, True, 0.5, 7, 3, gc.chain_taps())
    ints = cfg.ints()
    assert len(ints) == len(gc._GEOMETRY) and gc._GEOMETRY[-1] == "F" and ints[-1] == f


@pytest.fixture
def on_card(monkeypatch):
    """The wrappers' device test answers "all on the card"."""
    monkeypatch.setattr(_build, "on_cpu", lambda tensors: False)
    monkeypatch.setattr(sc, "_on_cpu", lambda tensors: False)


def _level_case(f, n_lvl, down, cd=16):
    shapes = gc.weight_shapes(f, cd, *gc.chain_taps(), down)
    ws = [{n: torch.zeros(s) for n, s in shapes} for _ in range(n_lvl)]
    act = lambda: torch.zeros(2, 4, 4, f)
    sk = [(act(), act()) for _ in range(n_lvl)] if down else None
    return act(), act(), sk, torch.zeros(2, cd), ws


@pytest.mark.parametrize("mode", ["stream", "pair", "segment"])
def test_gated_wrappers_refuse_an_unbuilt_width(on_card, mode):
    xv, xh, sk, cond, ws = _level_case(UNBUILT, 2, True)
    counters = (gc.stream_fwd, gc.pair_fwd, gc.seg_fwd)
    before = [c.launches for c in counters]
    with pytest.raises(ValueError, match=rf"num_filters in {BUILT}, got {UNBUILT}"):
        if mode == "stream":
            w = gc.stack_levels(ws)
            skips = (torch.stack([s[0] for s in sk]), torch.stack([s[1] for s in sk]))
            gc.gated_stream(xv, xh, skips, cond, w, seed=0, base_pair=0, keep=0.5)
        elif mode == "pair":
            gc.gated_pair(xv, xh, sk[0], cond, ws[0], seed=0, pair_index=0, keep=0.5)
        else:
            gc.gated_segment(xv, xh, sk, cond, ws, seed=0, base_pair=0, keep=0.5)
    assert [c.launches for c in counters] == before


def _vrow_args(f, n_lvl=4, wid=4, n=5):
    z = torch.zeros
    return (z(wid, n, f), z(wid, n, f), z(wid, n, f), z(n_lvl, wid, n, f),
            z(n_lvl, wid, n, 2 * f), z(n_lvl, n, 2 * f), z(6 * f, f), z(f), z(3 * f, f), z(f),
            z(n_lvl, 12 * f, f), z(n_lvl, f), z(n_lvl, 12 * f, 2 * f), z(n_lvl, 2 * f),
            z(n_lvl, 2 * f, f))


def _row_args(f, k, n_lvl=4, wid=4, n=5):
    z = torch.zeros
    return (z(n_lvl, 12 * f, f), z(n_lvl, f), z(n_lvl, 8 * f, 2 * f), z(n_lvl, 2 * f),
            z(n_lvl, n, 2 * f), z(n_lvl, wid, n, f), z(n_lvl, wid, n, 2 * f),
            z(n_lvl, wid, n, f), z(wid, n, f), z(wid, n, f), z(wid, n, k), z(k, f), z(f, k),
            z(k), z(2 * f, f), z(f))


def test_sampler_wrappers_refuse_an_unbuilt_width(on_card):
    before = (sc.vrow.launches, sc.row.launches)
    with pytest.raises(ValueError, match=rf"vrow kernel is built for num_filters in {BUILT}"):
        sc.vrow(*_vrow_args(UNBUILT))
    with pytest.raises(ValueError, match=rf"row kernel is built for num_filters in {BUILT}"):
        sc.row(*_row_args(UNBUILT, 128))
    assert (sc.vrow.launches, sc.row.launches) == before


@pytest.mark.parametrize("k", [64, 192])
def test_row_wrapper_refuses_a_codebook_off_its_logits_chunk(on_card, k):
    with pytest.raises(ValueError, match=rf"num_indices % 128 == 0, got {k}"):
        sc.row(*_row_args(64, k))


@pytest.mark.parametrize("f", [8, UNBUILT])
def test_cpu_tensors_of_an_unbuilt_width_take_the_plain_path(f):
    """Without the fixture the same calls run the plain versions: the
    refusal is the kernel path's."""
    before = (sc.row.launches, gc.pair_fwd.launches)
    out = sc.row(*_row_args(f, 128, n_lvl=2, wid=2, n=3))
    assert out[2].shape == (2, 3)
    xv, xh, _, cond, ws = _level_case(f, 1, False)
    assert gc.gated_pair(xv, xh, None, cond, ws[0], seed=0, pair_index=0,
                         keep=1.0)[0].shape == xv.shape
    assert (sc.row.launches, gc.pair_fwd.launches) == before

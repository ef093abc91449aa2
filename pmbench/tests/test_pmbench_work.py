"""The work counts against hand arithmetic at small shapes, and at the cell's
shapes against the kernel table's figures."""
from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from pmbench import harness
from pmbench.work import gated_chain as gc
from pmbench.work import peaks
from pmbench.work import sampler as sm


def test_in_image_taps_by_hand():
    # a 2x3 causal tap plan (pad top 1, left 1) on a 2x2 image: row offsets
    # -1, 0 reach 1 and 2 rows; column offsets -1, 0, 1 reach 1, 2, 1 columns
    assert gc.in_image_taps(gc.VERTICAL, 2, 2) == (1 + 2) * (1 + 2 + 1)
    assert gc.in_image_taps(gc.HORIZONTAL, 2, 2) == (1 + 2) * (1 + 2)
    assert gc.in_image_taps(gc.VERTICAL, 1, 1) == 1


def test_stream_flops_by_hand():
    # 1 image of 1x1, F 1, one level, D 1: taps v 1 + h 1 = 2; per image
    # 2 * 6 + 1 * 2 = 14 multiply-adds (+ 4 more down); projections 2 * 1 * 2
    fwd, bwd = gc.stream_flops(1, 1, 1, 1, 1, 1, False)
    assert fwd == 2 * 14 + 2 * 2 * 1 * 2 and bwd == 2 * fwd
    fwd_dn, _ = gc.stream_flops(1, 1, 1, 1, 1, 1, True)
    assert fwd_dn == 2 * 18 + 2 * 2 * 1 * 2


def test_stream_flops_at_the_cell_match_the_kernel_table():
    up, dn = gc.stream_flops(32, 16, 16, 128, 12, 512, False), \
        gc.stream_flops(32, 16, 16, 128, 12, 512, True)
    assert [round(v / 1e9, 2) for v in up + dn] == [186.86, 373.71, 199.74, 399.48]


def test_row_taps_sum_to_the_chains_in_image_taps():
    for tp in (sm.V_INPUT, sm.H_UP, sm.H_LEFT, gc.VERTICAL, gc.HORIZONTAL):
        for h, w in ((1, 1), (2, 3), (16, 16)):
            assert sum(sm.row_taps(tp, r, w) for r in range(h)) == gc.in_image_taps(tp, h, w)


def test_sampler_flops_by_hand_and_at_the_cell():
    # 1 sample, a 1-wide row, F 1, two levels (one down), K 3. vrow at row 0:
    # no input tap lands (rows -2, -1); conv_a and conv_b read row 0's middle
    # tap alone: 2 levels * 6; the down level's aux 2
    assert sm.vrow_flops(1, 0, 1, 1, 2) == 2 * (2 * 6 + 2)
    # at row 2: input taps rows 0 and 1 (2) and the up input row 1 (1); conv
    # taps rows 1 and 2: 2 levels * 6 * 2
    assert sm.vrow_flops(1, 2, 1, 1, 2) == 2 * (2 + 1 + 2 * 6 * 2 + 2)
    # row at row 0, column 0: no left tap; conv taps (0, 0): 2 levels * 6; aux
    # 2 levels * 2 and the down level's skip 2; logits 3
    assert sm.row_flops(1, 0, 1, 1, 2, 3) == 2 * (2 * 6 + 2 * 2 + 2 + 3)
    # at the cell, under the kernel table's counts (150.5 and 113.7 GFLOP a
    # launch, every tap of every row counted)
    vrow = sum(sm.vrow_flops(320, r, 16, 128, 24) for r in range(16))
    row = sum(sm.row_flops(320, r, 16, 128, 24, 512) for r in range(16))
    assert round(vrow / 1e9, 1) == 2238.8 and round(row / 1e9, 1) == 1659.9
    assert vrow < 16 * 150.5e9 and row < 16 * 113.7e9


def test_bound_takes_the_longer_of_operations_and_bytes():
    assert peaks.bound_s(495e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(495e12, 6.7e12) == pytest.approx(2.0)


def test_cell_bounds_are_compute_bound():
    cell = harness.find_cell(harness.benchmark(), "pm_vqvae_celeb_a.impute")
    per_req = sm.request_bound_s(cell.config, cell.traffic)
    flops = sum(sm.vrow_flops(320, r, 16, 128, 24) + sm.row_flops(320, r, 16, 128, 24, 512)
                for r in range(16))
    # every launch is bound by its operations but row 0's row launch, whose
    # few in-image taps leave it bound by its bytes
    first = sm.row_flops(320, 0, 16, 128, 24, 512)
    first_bytes = sm.row_bytes(320, 16, 128, 24, 512, 512)
    assert first / peaks.FLOAT32_FLOPS < first_bytes / peaks.HBM_BYTES
    assert per_req == pytest.approx((flops - first) / peaks.FLOAT32_FLOPS
                                    + first_bytes / peaks.HBM_BYTES)
    step = gc.train_step_bound_s(cell.config)
    assert step == pytest.approx((186.86 + 373.71 + 199.74 + 399.48) * 1e9 / 495e12, rel=1e-4)


def test_model_flops_count_a_conv_once():
    """FlopCounterMode, which the model counts rest on, counts a conv as 2
    FLOPs a multiply-add."""
    x = torch.empty(2, 3, 8, 8, device="meta")
    w = torch.empty(4, 3, 3, 3, device="meta")
    with FlopCounterMode(display=False) as fc:
        torch.nn.functional.conv2d(x, w, padding=1)
    assert fc.get_total_flops() == 2 * 2 * 8 * 8 * 4 * 3 * 9


def test_model_flops_of_the_cells():
    from pmbench.work import pm_vqvae

    bench = harness.benchmark()
    train = harness.find_cell(bench, "pm_vqvae_celeb_a.train")
    imp = harness.find_cell(bench, "pm_vqvae_celeb_a.impute")
    step = pm_vqvae.train_step_flops(train.config)
    # the chain's products are most of a step: more than the stream count
    # (which skips padded taps), within 1.3x of it
    chain = sum(gc.stream_flops(32, 16, 16, 128, 12, 512, d)[k] for d in (0, 1) for k in (0, 1))
    assert chain < step < 1.3 * chain
    req = pm_vqvae.request_flops(imp.config, imp.traffic)
    assert 3.5e12 < req < 5e12
    json.dumps([step, req])

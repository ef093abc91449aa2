"""Model FLOPs of a PM-VDVAE training step, counted once from the cell's shapes
by ``FlopCounterMode`` over the plain reference on the meta device: both encoders,
the decoder and the head, forward and backward, without recomputation."""
from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from pmbench.reference import pm_vdvae as ref


@functools.lru_cache(maxsize=8)
def _train(cfg_json: str) -> float:
    cfg = json.loads(cfg_json)
    model = ref.build(cfg, "meta")
    b = cfg["data"]["train_batch_size"]
    h, w, c = cfg["data"]["image_shape"]
    with FlopCounterMode(display=False) as fc:
        model.loss(torch.empty(b, h, w, c, device="meta"),
                   torch.empty(b, h, w, 1, device="meta"), None).backward()
    return float(fc.get_total_flops())


def train_step_flops(cfg) -> float:
    return _train(json.dumps(cfg, sort_keys=True))

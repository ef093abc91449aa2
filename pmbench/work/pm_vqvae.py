"""Model FLOPs of the PM-VQVAE's work, counted once from the cell's shapes by
``FlopCounterMode`` over the plain reference on the meta device (no data, no
recomputation): a training step is the frozen VQ-VAE's encode, the partial
encoder and the PixelCNN forward and backward at the training batch; a request
is the partial encoder at the batch, one teacher-forced PixelCNN forward over
every sample's grid (what a cached raster sampler computes, each position once)
and the decode of every sample."""
from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from pmbench.reference import pm_vqvae as ref


@functools.lru_cache(maxsize=8)
def _train(cfg_json: str) -> float:
    cfg = json.loads(cfg_json)
    model = ref.build(cfg, "meta")
    b = cfg["data"]["train_batch_size"]
    h, w, c = cfg["data"]["image_shape"]
    x = torch.empty(b, h, w, c, device="meta")
    m = torch.empty(b, h, w, 1, device="meta")
    for n, p in model.named_parameters():
        p.requires_grad_(ref.trainable(n))
    with FlopCounterMode(display=False) as fc:
        loss = -model.log_prob(x, m, True, 0).mean()
        loss.backward()
    return float(fc.get_total_flops())


@functools.lru_cache(maxsize=8)
def _request(cfg_json: str, batch: int, samples: int) -> float:
    cfg = json.loads(cfg_json)
    model = ref.build(cfg, "meta")
    h, w, c = cfg["data"]["image_shape"]
    gh, gw = cfg["pixel_cnn"]["image_shape"]
    n = batch * samples
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        cond = model.condition(torch.empty(batch, h, w, c, device="meta"),
                               torch.empty(batch, h, w, 1, device="meta"))
        codes = torch.empty(n, gh, gw, dtype=torch.long, device="meta")
        model.pixel_cnn(codes, cond.repeat(samples, 1))
        model.vqvae.decode_indices(codes)
    return float(fc.get_total_flops())


def train_step_flops(cfg) -> float:
    return _train(json.dumps(cfg, sort_keys=True))


def request_flops(cfg, traffic) -> float:
    return _request(json.dumps(cfg, sort_keys=True), traffic["batch"], traffic["samples"])

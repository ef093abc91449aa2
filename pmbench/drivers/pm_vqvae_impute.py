"""PM-VQVAE imputation requests as ``eval_pm_vqvae`` sends them: one client,
one request at a time, each ``batch`` images of the seeded split with masks of
the traffic's mask generator and the whole request's Gumbel noise drawn from the
request's seed, through ``pm_vqvae_impute`` (the float32 row samplers, the
VQ-VAE decode, the observed pixels stitched back).

A request's time runs from drawing its inputs to a synchronise after
``pm_vqvae_impute`` returns. The check, after the window and with the program
freed, takes ``check_requests`` finished requests drawn from the seed. For each it
runs the reference once over the sampled code grids, teacher-forced: every
sampled code must be the best of the reference's logits plus the request's
Gumbel noise, and the widest gap by which one falls below the best is compared;
the reference's decode of the same codes, stitched, must give the imputations."""
from __future__ import annotations

import gc
import random
import time

import numpy as np
import torch

from pmbench.drivers import _pm_vqvae as pmv
from pmbench.harness import Outcome, Stamps, sub_seed, sync
from pmbench.masks import mask_fn
from pmbench.profiling import profile_window
from pmbench.reference import precision

WARMUP_BASE = 1 << 40   # request numbers of the warm-up requests


def gumbel(gen, shape, dev) -> torch.Tensor:
    """Standard Gumbel noise, ``-log(-log(u))`` with ``u`` in [tiny, 1)."""
    u = torch.rand(shape, generator=gen, device=dev).clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


class Requests:
    """The traffic: request ``i``'s images, masks and noise, from the seed."""

    def __init__(self, cfg, traffic, seed, dev):
        self.cfg, self.seed, self.dev = cfg, seed, dev
        self.batch, self.samples = traffic["batch"], traffic["samples"]
        self.split = pmv.split(cfg, seed, cfg["eval_examples"], 4, dev)
        self.masks = mask_fn(traffic["mask_generator"], dev)
        h, w = cfg["pixel_cnn"]["image_shape"]
        self.noise_shape = (h, w, self.samples * self.batch, cfg["vqvae"]["num_embeddings"])

    def inputs(self, i: int):
        rows = (i * self.batch + np.arange(self.batch)) % len(self.split)
        x = pmv.images(self.split, rows, self.dev)
        gen = torch.Generator(device=self.dev).manual_seed(sub_seed(self.seed, 5, i))
        b = self.masks(gen, x.shape).reshape(*x.shape[:-1], 1)
        return x, b, gumbel(gen, self.noise_shape, self.dev)


def run(cell, *, seed, seconds, trace, device, t_start, control=False) -> Outcome:
    from posterior_matching_torch.models.pm_vqvae import pm_vqvae_impute

    cfg, traffic, dev = cell.config, cell.traffic, torch.device(device)
    stamp = Stamps(t_start)
    stamp("start and imports")
    state = pmv.draw_weights(cfg, seed, dev)
    stamp("CUDA context and weights")
    model = pmv.program_model(cfg, state, dev)
    del state
    stamp("model")
    reqs = Requests(cfg, traffic, seed, dev)
    stamp("split and masks")
    codes, current = {}, [None]
    decode = model.decode_code_samples

    def recording(samples):
        codes[current[0]] = samples
        return decode(samples)

    model.decode_code_samples = recording

    def request(i):
        x, b, noise = reqs.inputs(i)
        current[0] = i
        return pm_vqvae_impute(model, x, b, reqs.samples, noise=noise)

    for k in range(traffic["warmup_requests"]):
        request(WARMUP_BASE + k)
    sync(dev)
    codes.clear()
    stamp("warm-up requests")
    setup_s = time.time() - t_start

    outs, lat = {}, []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        a = time.perf_counter()
        outs[len(lat)] = request(len(lat))
        sync(dev)
        lat.append(time.perf_counter() - a)
    window_s = time.perf_counter() - t0
    done = len(lat)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    tw = None
    if trace and dev.type == "cuda":
        k = traffic["profile_requests"]
        tw = profile_window(lambda: [request(WARMUP_BASE + 100 + j) for j in range(k)], k)
    failed = sum(1 for i in range(done) if i not in codes or not torch.isfinite(outs[i]).all())
    picked = sorted(random.Random(sub_seed(seed, 6)).sample(range(done),
                                                            min(traffic["check_requests"], done)))
    got = {i: (codes[i], outs[i]) for i in picked}
    del model, request, recording, decode, outs, codes
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    checks = {k: (v, float(cell.limits[k]))
              for k, v in reference_gaps(cfg, seed, reqs, got, dev, tf32=control).items()}
    e2e = {"setup_s": setup_s, "impute_imgs_per_s": done * reqs.batch / window_s,
           "impute_p90_ms": p90([v * 1e3 for v in lat])}
    facts = {"requests": done, "window_s": window_s}
    return Outcome(done, failed, e2e, checks, peak, tw, facts, stamp.line())


def p90(values) -> float:
    """The 90th percentile, interpolated between order statistics."""
    return float(np.percentile(np.asarray(values), 90))


@torch.no_grad()
def reference_gaps(cfg, seed, reqs, got, dev, tf32=False):
    """For each checked request: the widest gap by which a sampled code's
    reference score (logit plus the request's noise) falls below the best
    score at its position, and the widest gap between the imputations and the
    reference's decode of the same codes, stitched and clipped. With ``tf32``
    the control: the code that TF32's scores put first is judged instead, and
    TF32's decode against float32's."""
    model = pmv.reference_model(cfg, seed, dev)
    token, image = 0.0, 0.0
    for i, (codes, out) in got.items():
        x, b, noise = reqs.inputs(i)
        s, bsz, h, w = codes.shape
        flat = codes.reshape(s * bsz, h, w)
        g = noise.permute(2, 0, 1, 3)
        with precision(False):
            cond = model.condition(x, b)
            rep = cond[None].expand(s, *cond.shape).reshape(s * bsz, -1)
            score = model.pixel_cnn(flat, rep) + g
            dec = model.vqvae.decode_indices(flat)
        pick, imgs = flat, out
        if tf32:
            with precision(True):
                cond_t = model.condition(x, b)
                rep_t = cond_t[None].expand(s, *cond_t.shape).reshape(s * bsz, -1)
                pick = (model.pixel_cnn(flat, rep_t) + g).argmax(-1)
                dec_t = model.vqvae.decode_indices(flat)
            imgs = torch.where(b[:, None] != 0, x[:, None],
                               dec_t.reshape(s, bsz, *dec_t.shape[1:]).movedim(0, 1)).clamp(0, 1)
        chosen = score.gather(-1, pick.long()[..., None])[..., 0]
        token = max(token, float((score.max(-1).values - chosen).max()))
        want = torch.where(b[:, None] != 0, x[:, None],
                           dec.reshape(s, bsz, *dec.shape[1:]).movedim(0, 1)).clamp(0, 1)
        image = max(image, float((imgs - want).abs().max()))
    return {"token_gap": token, "image_gap": image}

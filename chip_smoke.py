"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

Runs the port's PM-VQVAE paths at the flagship CelebA width (imputation and
stage-2 training through each of the PixelCNN chain's three kernel
granularities), the PM-VQVAE MNIST training pipeline from the command line
(stage 1, then stage 2), then PM-VDVAE MNIST's three paths at the full
width of ``configs/pm_vdvae_mnist.py`` (imputation, likelihood, training),
and checks them, in these phases:

1. header: torch and CUDA versions, the card's name and power limit;
2. all thirteen kernels (``posterior_matching_torch/ops/csrc``; the pair
   and segment kernels share a source per direction) are built from this
   checkout's sources, one ``nvcc`` per source, in parallel; both
   row-sampler kernels are launched at the imputation path's shapes (n = 32
   images x 10 samples, F = 128, L = 24, 16 x 16 codes, K = 512) and held
   against their plain PyTorch versions on the same inputs; each is timed
   with CUDA events beside its bound, the row kernel also with its weight
   stream per busy SM and its GFLOP/s;
3. imputation: three requests of 32 seeded 64x64x3 images with CelebA
   masks, 10 samples each, through ``pm_vqvae_impute`` with weights from
   ``--seed`` (a JAX-layout tree sent through ``convert.py``) or from
   ``--run_dir``; the sampler kernels' launch counters must show the
   requests went through them; a small request is also checked against the
   plain path on the CPU with the same noise;
4. the codebook search kernel against its plain version at the stage-2
   training path's shapes (8192 latents of 64, 512 codes) and at stage 1's
   (16,384: 64 images), relaunched bit for bit and on exact ties; each
   timed back to back, by its device time and kernels a call
   (``torch.profiler``: one kernel a call) and by its host us, beside its
   bound and the library's two calls (``addmm``, ``argmax``);
5. the gated chain kernels (forward and backward) against autograd through
   the plain chain at full width (B = 32, 16 x 16, F = 128, cond 512,
   keep 0.5, masks from the in-kernel hash): the stream's for the up and the
   down pass (L = 12), the pair's for an up and a down level, the
   segment's for an up and a down segment of 4 levels; each timed beside
   its bound;
6. the first training step at full width with ``chain_segment`` "stream",
   1, 4 and 5: equal losses and gradients, each mode's launches as
   expected;
7. training, once per mode ("stream", 1, 4) from the same weights: 8 steps
   of the stage-2 ``Trainer`` (``fit``, with a checkpoint callback) on the
   same seeded batches with dropout 0.5, then one profiled step (device
   time by kernel group, the device's idle share); each step's launches
   exactly the mode's (2 + 2 stream, 24 + 24 pair, 6 + 6 segment, 1 search;
   none of the other modes'); the VQ-VAE bit for bit frozen, every
   trainable tensor moved, the eval loss of a fixed batch lowered; a small
   model's step through the mode's kernels equal to the plain path's on
   the CPU; the checkpoint loaded back through ``load_pm_vqvae`` to serve an
   imputation request;
8. the PM-VQVAE training CLIs in this process on small synthetic MNIST
   files (512 training and 64 test images), at the full widths of
   ``configs/vqvae_mnist.py`` and ``configs/pm_vqvae_mnist.py``:
   ``train_vqvae``, then ``train_pm_vqvae --chain_segment 4`` reading its run
   directory, 4 steps and two validations each; the run directories, the
   segment launches, stage 1's VQ-VAE unchanged in stage 2's checkpoint,
   which serves an imputation;
9. PM-VDVAE (width 192, latent 16, 20 encoder and 20 decoder blocks,
   weights from ``--seed`` through ``convert.random_pm_vdvae_tree`` or from
   ``--vdvae_run_dir``): the block-chain kernels (forward and backward)
   against autograd through the plain chain at the five encoder run shapes
   of a training batch of 16, each timed beside its bound (3 TF32 products
   at the tensor cores' rate, the float32 FMA bound beside it), relaunched
   bit for bit, its CUDA kernels a level counted; three imputation
   requests of 32 images x 10 samples with MNIST masks through
   ``vdvae_impute`` (5 chain launches each); one likelihood chunk of 125
   through ``vdvae_is_log_probs`` at 16 importance samples (10 chain
   launches); 8 steps of ``pm_vdvae_trainer`` at batch 16 (10 forward and
   10 backward chain launches each), the eval loss of a fixed batch
   lowered, every tensor moved, a small step on the GPU equal to the plain
   path's on the CPU, the checkpoint reloaded through ``load_pm_vdvae``,
   then one profiled step;
10. PM-VDVAE training through the fused decoder chain (``fused_chain=True``,
   the same weights): the decoder-chain kernels (forward and backward)
   against autograd through the plain chain at the five decoder run shapes
   of a training batch of 16, with a random cotangent on each of the four
   outputs, each timed beside its bound (3 TF32 products at the tensor
   cores' rate, the float32 FMA bound beside it), relaunched bit for bit,
   its CUDA kernels a level counted and its float32 work rate logged; the
   first step's loss and every
   gradient equal to the unfused model's on the same batch and normals; 8
   steps of ``pm_vdvae_trainer`` on the same batches (5 forward and 5
   backward decoder-chain launches each, and the block chain's 10 + 10),
   the eval loss lowered, every tensor moved, a small digits16-width fused
   step on the GPU equal to the plain path's on the CPU, one profiled step;
11. the training CLI, ``posterior_matching_torch.train_pm_vdvae``, at full
   width with ``fused_chain=True`` on small synthetic MNIST files (512
   training and 64 test images): 4 steps, two validations of 4 batches; its
   run directory, its ``model_config.json`` (the config file's model keys
   only), its ``val_loss`` lines, its decoder-chain launches and its
   checkpoint, reloaded through ``load_pm_vdvae`` to serve an imputation;
12. one JSON line of per-kernel numbers, the card's name and power limit,
   and the result line.

Usage: ``python3 chip_smoke.py [--seed 0] [--run_dir RUN] [--vdvae_run_dir
RUN] [--out DIR]``.
It needs one CUDA device and exits non-zero without one, and in a directory
that holds this script and nothing else of the repository.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# Tolerances of the kernel-vs-plain comparisons. Both versions compute in
# float32 with float32 accumulation; they sum in different orders, so
# values agree to rounding, relative to the tensor's scale.
VROW_TOL = 1e-4     # max |kernel - plain| / max(1, max |plain|)
LOGITS_TOL = 1e-4   # same, on the row kernel's logits
SAMPLE_AGREEMENT = 0.999
# The training kernels: outputs 1e-4 relative to scale as above. Gradients
# the same: the weight gradients sum 8192 rows per entry (float32 rounding
# of such a sum is ~1e-6 relative) and every gradient passes back through
# up to 24 levels, so 1e-4 of the tensor's scale leaves a wide margin over
# rounding while any wrong tap, mask or transpose shows as O(1).
STREAM_TOL = 1e-4
GRAD_TOL = 1e-4
KEEP_RATE_TOL = 0.005
SEARCH_AGREEMENT = 0.999
NEAR_TIE = 1e-5     # score gap of a tolerated search disagreement / scale
STEP_LOSS_TOL = 1e-5
# Published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores, dense TF32 on the tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# TF32 products per float32 product in the gated chain's GEMM core
# (gated_common.cuh: the 3xTF32 split).
TF32_PASSES = 3

# The block chain: outputs and every gradient within 1e-4 of the tensor's
# scale (float32 sums in another order; a wrong tap, bound or transpose
# shows as O(1)).
CHAIN_TOL = 1e-4

BATCH, NUM_SAMPLES, REQUESTS = 32, 10, 3
TRAIN_STEPS = 8
# PM-VDVAE: imputation requests as eval_pm_vdvae_imputation.py serves them
# (batch 32, 10 samples here); one likelihood chunk of the eval's
# batch_chunk 125 at 16 importance samples (the eval's default is 10,000:
# cut for the time limit); training at the config's batch of 16.
LL_BATCH, LL_SAMPLES = 125, 16
VDVAE_TRAIN_BATCH = 16
DEVICE = "cuda"


def log(*args):
    print(*args, flush=True)


_START = time.perf_counter()


def stamp(what: str):
    """Logs the seconds since the script started, at a phase's start."""
    log(f"[{time.perf_counter() - _START:.1f} s] {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def rel_err(got: torch.Tensor, want: torch.Tensor):
    err = (got - want).abs().max().item()
    return err, err / max(1.0, want.abs().max().item())

def bound(flops, byts, peak=PEAK_F32_FLOPS):
    """The least time (ms) for the work on this card, and what sets it:
    ``flops`` at ``peak`` against the bytes at the memory rate."""
    t_op, t_by = flops / peak * 1e3, byts / PEAK_BYTES * 1e3
    return max(t_op, t_by), ("operations" if t_op >= t_by else "bytes")


def bound_tc(flops, byts):
    """:func:`bound` for the gated chain's kernels as their GEMM core does
    the work: TF32_PASSES tensor-core products per float32 product."""
    return bound(TF32_PASSES * flops, byts, PEAK_TF32_FLOPS)


# How the decoder chain's kernels (TPU rows 12-13) do their products.
DECODER_DESIGN = ("GEMM core on tensor cores (vdvae_gemm.cuh): mma.sync m16n8k8 TF32 with the "
                  "3xTF32 split; p, m and q grouped into one launch a phase (9 launches a level "
                  "each way); row tiles of 64, 32 or 16 sized to the run, column tiles of 48; "
                  "conv operands staged once a tile with their halo, taps read shifted under "
                  "the image mask; B by cp.async through 3 stages (6 on 16-row tiles); weight "
                  "gradients in 3 grouped launches over fixed row splits (the 3x3 stacks all "
                  "nine taps a block, the source gathered once), one split-sum and one bias-sum "
                  "launch")

# How the block chain's kernels (TPU rows 10-11) do their products.
BLOCK_DESIGN = ("GEMM core on tensor cores (vdvae_gemm.cuh, namespace bck): mma.sync m16n8k8 "
                "TF32 with the 3xTF32 split; 4 launches a level each way (c1-c4; wide K in slabs "
                "of 48, N = 192 as column tiles of 48); row tiles of 64, 32 or 16 sized to the "
                "run; conv operands staged once a tile with their halo, taps read shifted under "
                "the image mask; B by cp.async through 3 stages; weight gradients in 2 grouped "
                "launches over fixed row splits (the 3x3 stacks all nine taps a block), one "
                "split-sum and one bias-sum launch")

# How the gated chain's kernels (TPU rows 4-9) do their GEMMs.
GATED_DESIGN = ("GEMM core on tensor cores: mma.sync m16n8k8 TF32 with the 3xTF32 split; "
                "64-row (or 64-channel) block tiles of 16 warps, 32 x N/8 a warp; 64-deep "
                "chunks, B by cp.async a chunk ahead into 2 stages, A gathered a chunk ahead "
                "and stored split in fragment order")


def check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Phase 4: the codebook search
# ---------------------------------------------------------------------------


def vq_check(vq, flat, cb, what):
    """The search kernel against its plain version on ``flat``: indices
    agree on SEARCH_AGREEMENT of the latents, every disagreement a near-tie
    of the two scores, a relaunch bit for bit, and exact ties (codes k and
    k + K/2 equal) to the lower index, as in the plain version. Returns the
    largest score gap."""
    got = vq.nearest_codebook_indices(flat, cb)
    again = vq.nearest_codebook_indices(flat, cb)
    want = vq.nearest_codebook_indices_plain(flat, cb)
    torch.cuda.synchronize()
    scores = 2.0 * (flat @ cb.T) - (cb * cb).sum(-1)
    gap = (scores.gather(1, want[:, None].long())
           - scores.gather(1, got[:, None].long())).abs()[:, 0]
    diff = got != want
    agree = 1.0 - diff.float().mean().item()
    scale = scores.abs().max().item()
    err = gap.max().item()
    log(f"vq_search {what}: indices agree on {agree:.6f} of {got.numel()} latents; "
        f"max score gap {err:.3e} (scale {scale:.3e})")
    check(agree >= SEARCH_AGREEMENT, f"vq_search agrees on {agree} < {SEARCH_AGREEMENT}")
    check(bool((gap[diff] <= NEAR_TIE * scale).all()),
          "vq_search disagrees beyond a near-tie")
    check(torch.equal(got, again), "vq_search: a relaunch changed the indices")
    half = cb.shape[0] // 2
    tied = torch.cat([cb[:half], cb[:half]]).contiguous()   # code k == k + half
    got_t = vq.nearest_codebook_indices(flat, tied)
    want_t = vq.nearest_codebook_indices_plain(flat, tied)
    torch.cuda.synchronize()
    check(bool((got_t < half).all()), "vq_search broke a tie to the higher index")
    check(torch.equal(got_t, want_t), "vq_search disagrees on exact ties")
    log(f"vq_search {what}: relaunched bit for bit; exact ties go to the lower index, "
        "as in the plain version")
    return err


# How the search kernel (TPU row 3) computes.
VQ_DESIGN = ("one launch a call, norms fused: a block owns 128, 64, 32 or 16 rows (the "
             "largest filling 7/8 of a wave: 64 at 8192 latents, 128 at 16,384), warps of two "
             "m16 tiles x 16 codes in 8 code groups (4 at 128 rows); z staged once split in "
             "fragment order; codes through a 3-stage cp.async ring; scores by mma.sync "
             "m16n8k8 TF32 with the 3xTF32 split, 16-deep partial sums; |e|^2 from the B "
             "fragments; argmax in registers, merged by quad shuffles and across code groups "
             "in shared memory, ties to the lower index")


def vq_phase(model, x):
    """The search kernel against its plain version on the latents of ``x``
    (the stage-2 training path's shapes) and of 64 seeded images (stage 1's
    CelebA batch), and on exact ties; at each, the ms a call back to back,
    the device ms and kernels a call, the host us a call, and the library's
    two calls (``addmm`` of the negative norms, then ``argmax``) beside."""
    from posterior_matching_torch.ops import vq
    from posterior_matching_torch.ops.profiling import host_ms, profile_calls, time_ms
    from posterior_matching_torch.ops.vq_breakdown import library_fn

    gen = torch.Generator(device=x.device).manual_seed(64)
    x64 = torch.rand((64, *x.shape[1:]), generator=gen, device=x.device)
    cb = model.vqvae.vq.embeddings.detach().contiguous()
    log(f"vq_search: TF32 matmuls {torch.backends.cuda.matmul.allow_tf32} (the library's "
        "GEMM runs in float32)")
    per_shape, err = [], 0.0
    for what, images in (("stage 2", x), ("stage 1", x64)):
        with torch.no_grad():
            z = model.vqvae.encode(images)
        flat = z.reshape(-1, z.shape[-1]).contiguous()
        n, d = flat.shape
        k = cb.shape[0]
        err = max(err, vq_check(vq, flat, cb, f"{what} ({n} x {k} x {d})"))
        fn = lambda: vq.nearest_codebook_indices(flat, cb)   # noqa: E731
        lib = library_fn(flat, cb)
        ms = time_ms(fn, reps=50, warmup=3)
        plain_ms = time_ms(lambda: vq.nearest_codebook_indices_plain(flat, cb), reps=50,
                           warmup=3)
        library_ms = time_ms(lib, reps=50, warmup=3)
        prof, lib_prof = profile_calls(fn, 20), profile_calls(lib, 20)
        check(prof is not None, "vq_search: the profiler lost part of three windows")
        dev_ms, per_call, names = prof
        check(per_call == 1 and all("vq_search" in name for name in names),
              f"vq_search: a call launched {per_call} kernels: {names}")
        flops, byts = 2.0 * n * k * d, nbytes(flat, cb) + 4 * n
        b_ms, b_by = bound_tc(flops, byts)
        row = {"shape": [n, k, d], "ms": ms, "device_ms": dev_ms, "kernels_per_call": per_call,
               "host_us": host_ms(fn) * 1e3, "plain_ms": plain_ms, "library_ms": library_ms,
               "library_device_ms": lib_prof and lib_prof[0],
               "library_kernels_per_call": lib_prof and lib_prof[1],
               "library_host_us": host_ms(lib) * 1e3, "bound_ms": b_ms, "bound_by": b_by,
               "bound_f32_ms": bound(flops, byts)[0], "gflop": flops / 1e9, "mb": byts / 1e6}
        per_shape.append(row)
        log(f"vq_search {what}: {ms:.5f} ms/call back to back, device {dev_ms:.5f} ms in "
            f"{per_call:g} kernel, host {row['host_us']:.2f} us/call; library (addmm + "
            f"argmax, two calls) {library_ms:.5f} ms/call, device "
            f"{row['library_device_ms'] or float('nan'):.5f} ms in "
            f"{row['library_kernels_per_call']} kernels, host {row['library_host_us']:.2f} "
            f"us; plain {plain_ms:.5f}; bound {b_ms:.5f} ms by {b_by} on the tensor cores "
            f"(float32 FMAs {row['bound_f32_ms']:.5f}; {flops / 1e9:.3f} GFLOP, "
            f"{byts / 1e6:.2f} MB)")
    main = per_shape[0]
    return {"name": "vq_search", "route": "cuda",
            "source": "posterior_matching_torch/ops/csrc/vq_search.cu",
            "replaces": "posterior_matching_tpu/ops/vq.py:35",
            "max_abs_err": err, "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "bound_f32_ms": main["bound_f32_ms"],
            "design": VQ_DESIGN, "per_shape": per_shape}


# ---------------------------------------------------------------------------
# Phase 5: the gated chain, forward and backward
# ---------------------------------------------------------------------------


def in_image_taps(tp, h, w):
    """The (position, tap) pairs of an ``h x w`` image whose tap lands inside
    the image (a tap outside reads the zero padding and adds nothing)."""
    return sum(max(h - abs(i - tp.pad_top), 0) * max(w - abs(j - tp.pad_left), 0)
               for i in range(tp.skh) for j in range(tp.skw))


def stream_work(cfg, fwd_bytes, bwd_bytes):
    """Operations of one forward and one backward launch of ``cfg``'s levels
    (the backward does each product twice: data and weight gradients): each
    block's conv_a ([2F, F]) and conv_b ([2F, 2F]) at its in-image taps, the
    aux products ([2F, F]) at every row, the cond projections."""
    f, hw = cfg.f, cfg.h * cfg.w
    taps = in_image_taps(cfg.taps_v, cfg.h, cfg.w) + in_image_taps(cfg.taps_h, cfg.h, cfg.w)
    per_image = taps * (2 * f * f + 4 * f * f) + hw * (2 * f * f)
    if cfg.down:
        per_image += hw * 2 * (2 * f * f)
    mm = 2.0 * cfg.b * cfg.n_levels * per_image
    proj = 2.0 * 2 * cfg.n_levels * cfg.b * cfg.cd * 2 * f
    return (mm + proj, fwd_bytes), (2 * mm + 2 * proj, bwd_bytes)


def stream_phase(model, x, b, seed):
    """Both gated chain kernels against autograd through the plain chain at
    full width, up pass then down pass, with in-kernel hash dropout."""
    from posterior_matching_torch.ops import gated_chain as gc
    from posterior_matching_torch.ops.profiling import time_ms

    pc = model.pixel_cnn
    n, f = pc.num_resnet, pc.num_filters
    keep = 1.0 - pc.dropout
    taps = gc.chain_taps(pc.receptive_field_dims)
    with torch.no_grad():
        codes = model.vqvae.encoding_indices(x)
        cond = model.conditional_latents(x, b).contiguous()
        xv0, xh0 = (t.contiguous() for t in pc.init_stacks(codes))
    gen = torch.Generator(device=x.device).manual_seed(seed + 17)
    results = {}
    for direction in ("up", "dn"):
        down = direction == "dn"
        with torch.no_grad():
            w = {k: v.detach().contiguous() for k, v in gc.stack_levels(
                [gc.pack_level(pc.layers, direction, p, f, down, pc.receptive_field_dims)
                 for p in range(n)]).items()}
        base = n if down else 0
        skips = None
        if down:
            xs_v, xs_h = [xv0_up, *up_v], [xh0_up, *up_h]
            skips = (torch.stack([xs_v[n - 1 - p] for p in range(n)]).contiguous(),
                     torch.stack([xs_h[n - 1 - p] for p in range(n)]).contiguous())
            xv0, xh0 = up_v[-1].contiguous(), up_h[-1].contiguous()
        leaves = [xv0, xh0, cond, *w.values()] + (list(skips) if down else [])
        leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
        lx0, lh0, lcond = leaves[:3]
        lw = dict(zip(w, leaves[3: 3 + len(w)]))
        lsk = tuple(leaves[3 + len(w):]) if down else None
        kw = dict(seed=seed, base_pair=base, keep=keep, taps=taps)
        got = gc.gated_stream(lx0, lh0, lsk, lcond, lw, **kw)
        want = gc.gated_stream_plain(lx0, lh0, lsk, lcond, lw, **kw)
        torch.cuda.synchronize()
        fwd_err = 0.0
        for name, g_, w_ in zip(("xv", "xh"), got, want):
            err, rel = rel_err(g_, w_)
            fwd_err = max(fwd_err, err)
            log(f"gated_stream_fwd {direction} {name} outputs: max abs err {err:.3e}, "
                f"relative to scale {rel:.3e}")
            check(rel <= STREAM_TOL, f"gated_stream_fwd {direction} {name}: {rel:.3e}")
        cot = [torch.randn(t.shape, generator=gen, device=t.device) for t in want]
        gk = torch.autograd.grad(got, leaves, cot)
        gp = torch.autograd.grad(want, leaves, cot, retain_graph=True)
        torch.cuda.synchronize()
        names = ["dxv0", "dxh0", "dcond", *("d" + k for k in w)] + (
            ["dskv", "dskh"] if down else [])
        bwd_err, worst = 0.0, ("", 0.0)
        for name, a, c in zip(names, gk, gp):
            err, rel = rel_err(a, c)
            bwd_err = max(bwd_err, err)
            worst = max(worst, (name, rel), key=lambda t: t[1])
            check(rel <= GRAD_TOL, f"gated_stream_bwd {direction} {name}: {rel:.3e} > {GRAD_TOL}")
        log(f"gated_stream_bwd {direction}: {len(names)} gradients, max abs err "
            f"{bwd_err:.3e}, worst relative to scale {worst[1]:.3e} ({worst[0]})")
        mv, mh = gc.step_masks(seed, base, n, xv0.shape, keep, x.device)
        rate = torch.cat([mv.flatten(), mh.flatten()]).mean().item()
        log(f"gated_stream {direction}: realised keep rate {rate:.6f} (keep {keep})")
        check(abs(rate - keep) <= KEEP_RATE_TOL, f"keep rate {rate} is not {keep}")
        if not down:
            xv0_up, xh0_up = xv0, xh0
            up_v, up_h = (t.detach() for t in want)

        # times of the kernels (wrapper calls) and of the plain versions
        cfg = gc.StreamConfig(xv0, cond, n, down, keep, seed, base, taps)
        sk = skips if down else None
        with torch.no_grad():
            saves = gc.stream_fwd(cfg, xv0, xh0, sk, cond, w)
            saved = {"xv0": xv0, "xh0": xh0, "cond": cond, **saves}
            if down:
                saved["skv"], saved["skh"] = skips
            w_nb = {k: v for k, v in w.items() if not k.startswith("b")}
            gv, gh = (c.reshape(n, -1, f).contiguous() for c in cot)
            fwd_ms = time_ms(lambda: gc.stream_fwd(cfg, xv0, xh0, sk, cond, w), reps=3)
            bwd_ms = time_ms(lambda: gc.stream_bwd(cfg, gv, gh, saved, w_nb), reps=3)
            fwd_plain = time_ms(lambda: gc.gated_stream_plain(xv0, xh0, sk, cond, w, **kw), reps=3)
        bwd_plain = time_ms(lambda: torch.autograd.grad(want, leaves, cot, retain_graph=True),
                            reps=3)
        grads = gc.stream_bwd(cfg, gv, gh, saved, w_nb)
        fwd_bytes = nbytes(xv0, xh0, cond, *w.values(), *(sk or ()),
                           *(saves[k] for k in ("xvo", "xho", "a1v", "a1h", "b1v", "b1h")))
        bwd_bytes = nbytes(gv, gh, *saved.values(), *w_nb.values(), *grads.values())
        (ff, fb), (bf, bb) = stream_work(cfg, fwd_bytes, bwd_bytes)
        results[direction] = {
            "fwd": (fwd_err, fwd_ms, fwd_plain, ff, fb),
            "bwd": (bwd_err, bwd_ms, bwd_plain, bf, bb),
            "splits": gc.wgrad_splits("gated_stream_bwd", cfg),
        }
        log(f"gated_stream_bwd {direction}: wgrad row splits {results[direction]['splits']}")
        for kind in ("fwd", "bwd"):
            _, ms, pms, fl, by = results[direction][kind]
            b_ms, b_by = bound_tc(fl, by)
            log(f"gated_stream_{kind} {direction}: {ms:.4f} ms/launch (plain {pms:.3f}), "
                f"bound {b_ms:.4f} ms by {b_by} (float32 FMAs {bound(fl, by)[0]:.4f}; "
                f"{fl / 1e9:.1f} GFLOP, {by / 1e6:.1f} MB)")
        del got, want, gk, gp, saves, saved, grads
    out = []
    for kind, line in (("fwd", 1337), ("bwd", 1407)):
        per = [results[d][kind] for d in ("up", "dn")]
        work = (sum(p[3] for p in per) / 2, sum(p[4] for p in per) / 2)
        b_ms, b_by = bound_tc(*work)
        out.append({
            "name": f"gated_stream_{kind}", "route": "cuda", "design": GATED_DESIGN,
            "bound_f32_ms": bound(*work)[0],
            "source": f"posterior_matching_torch/ops/csrc/gated_stream_{kind}.cu",
            "replaces": f"posterior_matching_tpu/ops/gated_chain.py:{line}",
            "max_abs_err": max(p[0] for p in per),
            # per launch: the mean of the up and the down pass
            "ms": sum(p[1] for p in per) / 2, "plain_ms": sum(p[2] for p in per) / 2,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "per_pass": {d: {"ms": results[d][kind][1], "plain_ms": results[d][kind][2],
                             "gflop": results[d][kind][3] / 1e9,
                             "mb": results[d][kind][4] / 1e6,
                             **({"wgrad_splits": results[d]["splits"]} if kind == "bwd"
                                else {})} for d in ("up", "dn")},
        })
    return out


# ---------------------------------------------------------------------------
# Phase 6: the pair and segment kernels, the chain modes' first step
# ---------------------------------------------------------------------------

SEGMENT = 4   # the segment length of the kernel comparisons and training


def level_phase(model, x, b, seed):
    """The pair and segment kernels (forward and backward) against autograd
    through their plain versions at full width: an up and a down pair
    (levels 0 of each pass), an up and a down segment of SEGMENT levels, with
    in-kernel hash dropout and a random cotangent on every output; each
    timed beside its bound."""
    from posterior_matching_torch.ops import gated_chain as gc
    from posterior_matching_torch.ops.profiling import time_ms

    pc = model.pixel_cnn
    n, f, rf = pc.num_resnet, pc.num_filters, pc.receptive_field_dims
    keep = 1.0 - pc.dropout
    taps = gc.chain_taps(rf)
    with torch.no_grad():
        codes = model.vqvae.encoding_indices(x)
        cond = model.conditional_latents(x, b).contiguous()
        xv0, xh0 = (t.contiguous() for t in pc.init_stacks(codes))
        up_w = gc.stack_levels([gc.pack_level(pc.layers, "up", p, f, False, rf)
                                for p in range(n)])
        up_v, up_h = gc.gated_stream(xv0, xh0, None, cond, up_w, seed=seed, base_pair=0,
                                     keep=keep, taps=taps)
    xs_v, xs_h = [xv0, *up_v], [xh0, *up_h]
    gen = torch.Generator(device=x.device).manual_seed(seed + 31)
    kinds = {"pair": ((gc.pair_fwd, gc.pair_bwd), 1), "segment": ((gc.seg_fwd, gc.seg_bwd), SEGMENT)}
    results = {k: {} for k in kinds}
    for kind, ((fwd, bwd), n_lvl) in kinds.items():
        for direction in ("up", "dn"):
            down = direction == "dn"
            base = n if down else 0
            with torch.no_grad():
                ws = [{k: v.detach().contiguous() for k, v in
                       gc.pack_level(pc.layers, direction, p, f, down, rf).items()}
                      for p in range(n_lvl)]
            xv, xh = (xs_v[n], xs_h[n]) if down else (xv0, xh0)
            sk = [(xs_v[n - 1 - p].contiguous(), xs_h[n - 1 - p].contiguous())
                  for p in range(n_lvl)] if down else None
            leaves = [t.detach().clone().requires_grad_(True) for t in
                      (xv, xh, cond, *(t for w in ws for t in w.values()),
                       *(t for pair in (sk or ()) for t in pair))]
            lxv, lxh, lcond = leaves[:3]
            it = iter(leaves[3:])
            lws = [{k: next(it) for k in w} for w in ws]
            lsk = [(next(it), next(it)) for _ in range(n_lvl)] if down else None
            kw = dict(seed=seed, base_pair=base, keep=keep, taps=taps)
            if kind == "pair":
                pk = dict(seed=seed, pair_index=base, keep=keep, taps=taps)
                got = [gc.gated_pair(lxv, lxh, lsk and lsk[0], lcond, lws[0], **pk)]
                want = [gc.gated_pair_plain(lxv, lxh, lsk and lsk[0], lcond, lws[0], **pk)]
            else:
                got = gc.gated_segment(lxv, lxh, lsk, lcond, lws, **kw)
                want = gc.gated_segment_plain(lxv, lxh, lsk, lcond, lws, **kw)
            got = [t for pair in got for t in pair]
            want = [t for pair in want for t in pair]
            torch.cuda.synchronize()
            fwd_err = 0.0
            for i, (g_, w_) in enumerate(zip(got, want)):
                err, rel = rel_err(g_, w_)
                fwd_err = max(fwd_err, err)
                check(rel <= STREAM_TOL, f"gated_{kind}_fwd {direction} output {i}: {rel:.3e}")
            cot = [torch.randn(t.shape, generator=gen, device=t.device) for t in want]
            gk = torch.autograd.grad(got, leaves, cot)
            gp = torch.autograd.grad(want, leaves, cot, retain_graph=True)
            torch.cuda.synchronize()
            bwd_err, worst = 0.0, (0.0, -1)
            for i, (a, c) in enumerate(zip(gk, gp)):
                err, rel = rel_err(a, c)
                bwd_err = max(bwd_err, err)
                worst = max(worst, (rel, i))
                check(rel <= GRAD_TOL, f"gated_{kind}_bwd {direction} gradient {i}: {rel:.3e}")
            log(f"gated_{kind} {direction} (L = {n_lvl}): {len(got)} outputs max abs err "
                f"{fwd_err:.3e}; {len(gk)} gradients max abs err {bwd_err:.3e}, worst "
                f"relative to scale {worst[0]:.3e}")

            # times of the wrappers (one launch each) and of the plain versions
            cfg = gc.StreamConfig(xv, cond, n_lvl, down, keep, seed, base, taps)
            gs = [(c1.contiguous(), c2.contiguous()) for c1, c2 in zip(cot[::2], cot[1::2])]
            with torch.no_grad():
                saves = fwd(cfg, xv, xh, sk, cond, ws)
                fwd_ms = time_ms(lambda: fwd(cfg, xv, xh, sk, cond, ws), reps=10, warmup=2)
                bwd_ms = time_ms(lambda: bwd(cfg, gs, xv, xh, cond, sk, saves, ws), reps=10,
                                 warmup=2)
                plain = lambda: gc.gated_segment_plain(xv, xh, sk, cond, ws, **kw)
                fwd_plain = time_ms(plain, reps=3)
            bwd_plain = time_ms(lambda: torch.autograd.grad(want, leaves, cot, retain_graph=True),
                                reps=3)
            head, grads = bwd(cfg, gs, xv, xh, cond, sk, saves, ws)
            ins = (xv, xh, cond, *(t for w in ws for t in w.values()),
                   *(t for pair in (sk or ()) for t in pair))
            fwd_bytes = nbytes(*ins, *(t for s_ in saves for t in s_.values()))
            bwd_bytes = nbytes(*(t for pair in gs for t in pair), *ins,
                               *(t for s_ in saves for t in s_.values()),
                               *head.values(), *(t for g_ in grads for t in g_.values()))
            (ff, fb), (bf, bb) = stream_work(cfg, fwd_bytes, bwd_bytes)
            results[kind][direction] = {"fwd": (fwd_err, fwd_ms, fwd_plain, ff, fb),
                                        "bwd": (bwd_err, bwd_ms, bwd_plain, bf, bb),
                                        "splits": gc.wgrad_splits("gated_levels_bwd", cfg)}
            log(f"gated_{kind}_bwd {direction}: wgrad row splits "
                f"{results[kind][direction]['splits']}")
            for k2 in ("fwd", "bwd"):
                _, ms, pms, fl, by = results[kind][direction][k2]
                b_ms, b_by = bound_tc(fl, by)
                log(f"gated_{kind}_{k2} {direction}: {ms:.4f} ms/launch (plain {pms:.3f}), bound "
                    f"{b_ms:.4f} ms by {b_by} (float32 FMAs {bound(fl, by)[0]:.4f}; "
                    f"{fl / 1e9:.2f} GFLOP, {by / 1e6:.1f} MB)")
            del got, want, gk, gp, saves, grads, head
    out = []
    for kind, lines in (("pair", (("fwd", 305), ("bwd", 368))),
                        ("segment", (("fwd", 801), ("bwd", 861)))):
        for k2, line in lines:
            per = [results[kind][d][k2] for d in ("up", "dn")]
            work = (sum(p[3] for p in per) / 2, sum(p[4] for p in per) / 2)
            b_ms, b_by = bound_tc(*work)
            out.append({
                "name": f"gated_{kind}_{k2}", "route": "cuda", "design": GATED_DESIGN,
                "bound_f32_ms": bound(*work)[0],
                "source": f"posterior_matching_torch/ops/csrc/gated_levels_{k2}.cu",
                "replaces": f"posterior_matching_tpu/ops/gated_chain.py:{line}",
                "max_abs_err": max(p[0] for p in per),
                # per launch: the mean of the up and the down call
                "ms": sum(p[1] for p in per) / 2, "plain_ms": sum(p[2] for p in per) / 2,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "per_pass": {d: {"levels": kinds[kind][1], "ms": results[kind][d][k2][1],
                                 "plain_ms": results[kind][d][k2][2],
                                 "gflop": results[kind][d][k2][3] / 1e9,
                                 "mb": results[kind][d][k2][4] / 1e6,
                                 **({"wgrad_splits": results[kind][d]["splits"]}
                                    if k2 == "bwd" else {})} for d in ("up", "dn")},
            })
    return out


def chain_counters():
    """The PM-VQVAE training kernels' wrappers, whose ``launches`` count
    them."""
    from posterior_matching_torch.ops import gated_chain as gc
    from posterior_matching_torch.ops import vq

    return {"vq_search": vq.nearest_codebook_indices,
            "gated_stream_fwd": gc.stream_fwd, "gated_stream_bwd": gc.stream_bwd,
            "gated_pair_fwd": gc.pair_fwd, "gated_pair_bwd": gc.pair_bwd,
            "gated_segment_fwd": gc.seg_fwd, "gated_segment_bwd": gc.seg_bwd}


def mode_launches(chain_segment, n):
    """The chain kernels' launches of one training step (a forward and a
    backward of the up and the down pass) with ``chain_segment``."""
    if chain_segment == "stream":
        kind, per_pass = "stream", 1
    else:
        kind = "pair" if chain_segment == 1 else "segment"
        per_pass = -(-n // chain_segment)
    return {"vq_search": 1, f"gated_{kind}_fwd": 2 * per_pass, f"gated_{kind}_bwd": 2 * per_pass}


def modes_step_check(model, batch, seed, modes=("stream", 1, SEGMENT, 5)):
    """The first training step at full width with each chain mode on the
    same batch and dropout seed: the loss within 1e-5 relative and every
    trainable gradient within GRAD_TOL of its scale of the stream's, each
    mode's chain launches as expected."""
    from posterior_matching_torch.train.trainer import pm_vqvae_loss

    pc = model.pixel_cnn
    counters = chain_counters()
    names, params = zip(*[(n_, p) for n_, p in model.named_parameters()
                          if not n_.startswith("vqvae.")])
    out = {}
    for mode in modes:
        pc.chain_segment = mode
        before = {k: c.launches for k, c in counters.items()}
        loss = pm_vqvae_loss(model, batch, seed, True)
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        launched = {k: c.launches - before[k] for k, c in counters.items()}
        want = mode_launches(mode, pc.num_resnet)
        check(all(launched[k] == want.get(k, 0) for k in launched),
              f"chain_segment={mode} launched {launched}, not {want}")
        out[mode] = (loss.item(), dict(zip(names, grads)))
    pc.chain_segment = "stream"
    ls, gs = out["stream"]
    summary = {}
    for mode in modes[1:]:
        lm, gm = out[mode]
        loss_rel = abs(lm - ls) / abs(ls)
        worst = max(((n_, rel_err(gm[n_], gs[n_])[1]) for n_ in gs), key=lambda t: t[1])
        log(f"first step, chain_segment={mode} vs stream: loss {lm:.6f} vs {ls:.6f} (relative "
            f"{loss_rel:.3e}), worst gradient relative to scale {worst[1]:.3e} ({worst[0]}) "
            f"over {len(gs)} tensors; launches {mode_launches(mode, pc.num_resnet)}")
        check(loss_rel <= STEP_LOSS_TOL, f"chain_segment={mode}: the loss disagrees")
        check(worst[1] <= GRAD_TOL, f"chain_segment={mode}: a gradient disagrees")
        summary[str(mode)] = {"loss": lm, "loss_rel": loss_rel, "worst_grad": worst}
    return summary


# ---------------------------------------------------------------------------
# Phase 7: training
# ---------------------------------------------------------------------------


def training_phase(model, args, mask_fn, gen, batches, fixed, pm_cfg, vq_cfg, pc_cfg,
                   chain_segment="stream"):
    """8 full-width steps of the stage-2 trainer on ``batches`` with the
    PixelCNN chain's ``chain_segment``, then the checks."""
    import tempfile

    from posterior_matching_torch import config, convert
    from posterior_matching_torch.masking import add_mask
    from posterior_matching_torch.models.pm_vqvae import pm_vqvae_impute
    from posterior_matching_torch.train.trainer import pm_vqvae_loss, pm_vqvae_trainer

    model.pixel_cnn.chain_segment = chain_segment
    image_shape = tuple(batches[0]["image"].shape)
    counters = chain_counters()
    expected = mode_launches(chain_segment, model.pixel_cnn.num_resnet)

    def eval_loss():
        with torch.no_grad():
            return pm_vqvae_loss(model, fixed, 0, False).item()

    trainer = pm_vqvae_trainer(model, config.PM_VQVAE_CELEB_A_TRAIN, seed=args.seed,
                               mask_fn=mask_fn)
    trainer.init()
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    loss_before = eval_loss()
    run_dir = tempfile.TemporaryDirectory()
    steps_per_s, step_s, losses, launches = fit_steps(
        trainer, batches, counters, lambda name, count: count == expected.get(name, 0),
        f"{run_dir.name}/train_state.pkl")
    loss_after = eval_loss()
    log(f"training (chain_segment={chain_segment}): {steps_per_s:.4f} steps/s over steps "
        f"3-{TRAIN_STEPS} (batch {image_shape[0]}); eval loss of a fixed batch "
        f"{loss_before:.4f} -> {loss_after:.4f}; chain launches a step {expected}")
    check(loss_after < loss_before, "the eval loss did not drop")
    after = model.state_dict()
    for name, t in before.items():
        if name.startswith("vqvae."):
            check(torch.equal(after[name], t), f"{name} changed: the VQ-VAE is not frozen")
    for name in trainer.optimizer.params:
        check(not torch.equal(after[name], before[name]), f"{name} did not move")
    log(f"training: {sum(n.startswith('vqvae.') for n in before)} VQ-VAE tensors "
        f"unchanged, all {len(trainer.optimizer.params)} trainable tensors moved")

    small_step_check(vq_cfg, pm_cfg, args.seed, chain_segment)

    with run_dir:
        with open(f"{run_dir.name}/vqvae_config.json", "w") as fp:
            json.dump(vq_cfg, fp)
        with open(f"{run_dir.name}/config.json", "w") as fp:
            json.dump({"conditional_dim": pm_cfg["conditional_dim"], "pixel_cnn": pc_cfg}, fp)
        loaded = convert.load_pm_vqvae(run_dir.name, device=DEVICE,
                                       chain_segment=chain_segment)
    for name, t in loaded.state_dict().items():
        check(torch.equal(t, after[name]), f"{name} did not survive the checkpoint")
    batch = add_mask({"image": torch.rand(image_shape, generator=gen, device=DEVICE)},
                     gen, mask_fn)
    imp = pm_vqvae_impute(loaded, batch["image"], batch["mask"], NUM_SAMPLES, generator=gen)
    torch.cuda.synchronize()
    check(imp.shape == (image_shape[0], NUM_SAMPLES, *image_shape[1:]),
          f"imputations from the checkpoint have shape {tuple(imp.shape)}")
    check(bool(torch.isfinite(imp).all()), "imputations from the checkpoint are not finite")
    log("checkpoint: train_state.pkl loads back through load_pm_vqvae, every tensor "
        "equal; an imputation request from it ran")
    split = profile_step(trainer, batches[-1], VQVAE_GROUPS, named=GEMM_CORE)
    if split is not None:
        with torch.no_grad():
            h, w = model.vqvae.encoding_indices(fixed["image"][:1]).shape[1:]
        split["gemm_core"] = gemm_core_rates(split, model.pixel_cnn, image_shape[0] * h * w)
    model.pixel_cnn.chain_segment = "stream"
    return {"chain_segment": chain_segment, "steps_per_s": steps_per_s, "step_s": step_s,
            "losses": losses, "eval_loss": [loss_before, loss_after], "launches": launches,
            "split": split}


# Kernel names of the gated chain's libraries (csrc/gated_{stream,pair,
# segment}_*.cu, all from gated_levels.cuh), as their demangled names end:
# "gsk::data_gemm<256>(...)", "gsk::wgrad<128>(...)" (not cuDNN's
# "..._wgrad_...").
_CHAIN_KERNELS = ("::data_gemm<", "::wgrad<128>", "::wgrad<256>", "::gate_bwd(",
                  "::rowsum_images(", "::sum_images(", "::dwc_kernel(", "::dcond_kernel(",
                  "::proj_kernel(")
# ... of the decoder chain's (csrc/decoder_chain_*.cu: namespace dck, and
# its own kernels) ...
_DECODER_CHAIN_KERNELS = ("dck::", "::z_into_state<", "::z_bwd<")
# ... and of the block chain's (csrc/block_chain_*.cu: the same core in
# namespace bck).
_BLOCK_CHAIN_KERNELS = ("bck::",)
VQVAE_GROUPS = (("gated chain kernels", _CHAIN_KERNELS), ("vq_search kernel", ("vq_search",)))
VDVAE_GROUPS = (("decoder_chain kernels", _DECODER_CHAIN_KERNELS),
                ("block_chain kernels", _BLOCK_CHAIN_KERNELS),
                ("triangular solves (cuBLAS)", ("trsm",)))


# The gated chain's GEMM core, kernel by kernel, as their names end.
GEMM_CORE = {k: f"::{k}" for k in ("data_gemm<128>", "data_gemm<256>", "wgrad<128>",
                                   "wgrad<256>")}


def gemm_core_work(pc, rows):
    """Float32 operations (2 a multiply-add) of each GEMM-core kernel in one
    PM-VQVAE training step (the up and the down pass, forward and backward)
    at ``rows`` = B*H*W, as the kernels run them: every tap at every row
    (a tap off the image multiplies zeros), each row split counted once."""
    from posterior_matching_torch.ops import gated_chain as gc

    f, n = pc.num_filters, pc.num_resnet
    tv, th = (tp.skh * tp.skw for tp in gc.chain_taps(pc.receptive_field_dims))
    mm = lambda k, width: 2.0 * rows * k * width   # noqa: E731
    work = dict.fromkeys(GEMM_CORE, 0.0)
    for down in (False, True):
        skips = 2 if down else 0          # the skip aux products of a down level
        work["data_gemm<128>"] += n * (mm(2 * f * (tv + th + 1 + skips), f))
        work["data_gemm<256>"] += n * (mm(2 * f * (tv + th), 2 * f)         # forward conv_b
                                       + mm(2 * f * (tv + th), 2 * f)       # conv_b^T
                                       + mm(f * (1 + skips), 2 * f)         # aux^T
                                       + mm(f * (tv + th), 2 * f))          # conv_a^T
        work["wgrad<128>"] += n * mm(2 * f * (tv + th + 1 + skips), f)
        work["wgrad<256>"] += n * mm(2 * f * (tv + th), 2 * f)
    return work


def gemm_core_rates(split, pc, rows):
    """Each GEMM-core kernel's device ms in the profiled step and its float32
    work rate (TFLOP/s), logged."""
    out = {}
    for name, flops in gemm_core_work(pc, rows).items():
        ms = split["named"].get(name, 0.0)
        out[name] = {"ms": ms, "gflop": flops / 1e9,
                     "tflops": flops / (ms * 1e-3) / 1e12 if ms else None}
        log(f"  GEMM core {name}: {ms:.2f} ms device time, {flops / 1e9:.1f} GFLOP, "
            f"{out[name]['tflops'] or 0.0:.2f} TFLOP/s of float32 work")
    return out


def profile_step(trainer, batch, kernel_groups, named=None):
    """One more training step under :func:`profile_work`."""
    return profile_work(lambda: trainer.train_step(batch)["loss"].item(), kernel_groups,
                        "profiled step", named)


def profile_work(fn, kernel_groups, what, named=None):
    """``fn()`` under ``torch.profiler``: device time by kernel group
    (``kernel_groups``: the port's own, by name, then the libraries'), CUDA
    kernel launches, the device's idle share of the wall time (1 - the
    union of kernel intervals / wall), and the device ms of the kernels
    whose names contain each of ``named``'s markers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log(f"{what}: the profiler saw no device time (split not measured)")
        return None
    # cuDNN's implicit-GEMM and FFT convolutions ("..._fprop_implicit_gemm_
    # ...", a complex "..._gemm_cf32cf32_...") are convolutions: test for
    # those names before cuBLAS's "gemm"
    library_groups = (
        ("convolutions (cuDNN)", ("conv", "cudnn", "wgrad", "dgrad", "fprop", "fft", "cf32")),
        ("matmuls (cuBLAS)", ("gemm", "cutlass")),
    )
    groups = {}
    for e in kernels:
        g = next((grp for grp, marks in kernel_groups if any(k in e.name for k in marks)),
                 None) or next((grp for grp, marks in library_groups
                                if any(k in e.name.lower() for k in marks)),
                               "elementwise and reductions")
        ms, n = groups.get(g, (0.0, 0))
        groups[g] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy = (busy + cur_e - cur_s) / 1e3
    log(f"{what}: {wall_ms:.1f} ms wall, device busy {busy:.1f} ms, idle share "
        f"{1 - busy / wall_ms:.3f}, {len(kernels)} CUDA kernel launches")
    for g, (ms, n) in sorted(groups.items(), key=lambda t: -t[1][0]):
        log(f"  {g}: {ms:.2f} ms device time in {n} launches")
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda t: -t[1])[:8]
    for name, ms in top[:4]:
        log(f"  top kernel {ms:.2f} ms: {name[:90]}")
    named_ms = {k: sum(ms for name, ms in by_name.items() if mark in name)
                for k, mark in (named or {}).items()}
    return {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": 1 - busy / wall_ms,
            "kernel_launches": len(kernels), "top_kernels": top, "named": named_ms,
            "groups": {g: {"ms": ms, "launches": n} for g, (ms, n) in groups.items()}}


def small_step_check(vq_cfg, pm_cfg, seed, chain_segment):
    """One training step of a small model through the kernels of
    ``chain_segment`` on the GPU against the same step of the plain path on
    the CPU: the same codes, the same hash masks, the loss within 1e-5
    relative and every gradient within GRAD_TOL of its scale."""
    from posterior_matching_torch import convert
    from posterior_matching_torch.train.trainer import pm_vqvae_loss

    vq_small = dict(vq_cfg, hidden_units=32, residual_hidden_units=8)
    pc_small = dict(pm_cfg["pixel_cnn"], image_shape=(8, 8), num_resnet=2,
                    num_indices=64)
    vq_small["num_embeddings"] = 64
    cond_dim = 64
    params, state = convert.random_pm_vqvae_tree(cond_dim, vq_small, pc_small, seed=seed + 5)
    models = {d: convert.pm_vqvae_from_jax(params, state, cond_dim, vq_small, pc_small,
                                           device=d, chain_segment=chain_segment)
              for d in (DEVICE, "cpu")}
    g = torch.Generator().manual_seed(seed + 6)
    x = torch.rand(4, 32, 32, 3, generator=g)
    b = (torch.rand(4, 32, 32, 1, generator=g) > 0.5).float()
    out = {}
    for d, m in models.items():
        batch = {"image": x.to(d), "mask": b.to(d)}
        names = [n for n, _ in m.named_parameters() if not n.startswith("vqvae.")]
        ps = dict(m.named_parameters())
        with torch.no_grad():
            codes = m.vqvae.encoding_indices(batch["image"]).cpu()
        loss = pm_vqvae_loss(m, batch, 1234, True)
        grads = torch.autograd.grad(loss, [ps[n] for n in names])
        out[d] = (codes, loss.item(), {n: gr.cpu() for n, gr in zip(names, grads)})
    (cg, lg, gg), (cc, lc, gcpu) = out[DEVICE], out["cpu"]
    check(torch.equal(cg, cc), "small step: the GPU's codes differ from the CPU's")
    loss_rel = abs(lg - lc) / abs(lc)
    worst = max(((n, rel_err(gg[n], gcpu[n])[1]) for n in gcpu), key=lambda t: t[1])
    log(f"small step (chain_segment={chain_segment}) vs CPU plain path: codes equal, "
        f"loss {lg:.6f} vs {lc:.6f} "
        f"(relative {loss_rel:.3e}), worst gradient relative to scale {worst[1]:.3e} "
        f"({worst[0]}) over {len(gcpu)} tensors")
    check(loss_rel <= STEP_LOSS_TOL, "small step: the loss disagrees with the CPU's")
    check(worst[1] <= GRAD_TOL, "small step: a gradient disagrees with the CPU's")


# ---------------------------------------------------------------------------
# Phase 8: the PM-VQVAE training CLIs
# ---------------------------------------------------------------------------


def vqvae_cli_phase(args, gen):
    """``train_vqvae``, then ``train_pm_vqvae --chain_segment SEGMENT`` reading
    its run directory, at the full widths of ``configs/vqvae_mnist.py`` and
    ``configs/pm_vqvae_mnist.py`` on small synthetic MNIST files, in this
    process: the run directories and validation lines, the segment kernels'
    launches, the frozen VQ-VAE in stage 2's checkpoint, and an imputation
    served from it."""
    import contextlib
    import glob
    import io
    import os
    import tempfile

    from posterior_matching_torch import convert, masking, train_pm_vqvae, train_vqvae
    from posterior_matching_torch.data import load_arrays
    from posterior_matching_torch.models.pm_vqvae import pm_vqvae_impute
    from posterior_matching_torch.train.state import load_train_state

    steps, n_train, n_test, batch = 4, 512, 64, 32
    n_val = n_test // batch
    counters = chain_counters()
    cwd, data_env = os.getcwd(), os.environ.get("PM_TPU_DATA_DIR")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(f"{tmp}/data/mnist")
        os.environ["PM_TPU_DATA_DIR"] = f"{tmp}/data"
        try:
            for split, n in (("train", n_train), ("test", n_test)):
                arrays = load_arrays("mnist", split)   # the synthetic stand-in
                np.savez(f"{tmp}/data/mnist/{split}.npz",
                         **{k: v[:n] for k, v in arrays.items()})
            os.chdir(tmp)
            common = ["--config.steps", str(steps), "--config.validation_freq",
                      str(steps // 2), "--config.seed", str(args.seed)]
            for stage, main, extra in (
                    ("train_vqvae", train_vqvae.main, ["--config", "vqvae_mnist"]),
                    ("train_pm_vqvae", train_pm_vqvae.main,
                     ["--config", "pm_vqvae_mnist", "--chain_segment", str(SEGMENT)])):
                if stage == "train_pm_vqvae":
                    extra += ["--config.vqvae_dir", out["train_vqvae"]["run_dir"]]
                before = {k: c.launches for k, c in counters.items()}
                printed = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(printed):
                    rc = main([*extra, *common])
                wall = time.perf_counter() - t0
                launched = {k: c.launches - before[k] for k, c in counters.items()}
                lines = printed.getvalue().splitlines()
                for line in lines:
                    log(f"  {stage}: {line}")
                check(rc == 0, f"{stage} exited with {rc}")
                prefix = "vqvae" if stage == "train_vqvae" else "pm-vqvae"
                run_dirs = glob.glob(f"runs/{prefix}-mnist-*")
                check(len(run_dirs) == 1, f"{stage} made the run directories {run_dirs}")
                steps_lines = [ln for ln in lines if ln.startswith("[step ")]
                check(len(steps_lines) == 2 and all("val_loss=" in ln for ln in steps_lines),
                      f"{stage} did not log two validations with val_loss")
                out[stage] = {"run_dir": run_dirs[0], "files": sorted(os.listdir(run_dirs[0])),
                              "wall_s": wall, "lines": steps_lines, "launches": launched}
                log(f"{stage}: {steps} steps and 2 validations of {n_val} batches in "
                    f"{wall:.1f} s; run directory {out[stage]['files']}; launches {launched}")
            run1, run2 = out["train_vqvae"]["run_dir"], out["train_pm_vqvae"]["run_dir"]
            check(out["train_vqvae"]["files"] == ["model_config.json", "train_meta.json",
                                                  "train_state.pkl"],
                  "train_vqvae's run directory holds other files")
            check(out["train_pm_vqvae"]["files"] == ["config.json", "train_meta.json",
                                                     "train_state.pkl", "vqvae_config.json"],
                  "train_pm_vqvae's run directory holds other files")
            check(out["train_vqvae"]["launches"]["vq_search"] > 0,
                  "train_vqvae did not run the search kernel")
            per_pass = -(-8 // SEGMENT)   # pm_vqvae_mnist: 8 levels a pass
            seg = out["train_pm_vqvae"]["launches"]
            want_fwd, want_bwd = 2 * per_pass * (steps + 2 * n_val), 2 * per_pass * steps
            check(seg["gated_segment_fwd"] == want_fwd and seg["gated_segment_bwd"] == want_bwd
                  and not any(seg[k] for k in seg if "stream" in k or "pair" in k),
                  f"train_pm_vqvae launched {seg}, not {want_fwd} + {want_bwd} segment launches")
            with open(f"{run2}/config.json") as fp:
                config2 = json.load(fp)
            check(config2["vqvae_dir"] == run1 and "chain_segment" not in json.dumps(config2),
                  "stage 2's config.json does not name stage 1's run, or holds chain_segment")
            with open(f"{run1}/model_config.json") as fp:
                vq_config = json.load(fp)
            ts1 = load_train_state(f"{run1}/train_state.pkl")
            vq1 = convert.vqvae_from_jax(ts1.params, ts1.state, vq_config, device=DEVICE)
            model2 = convert.load_pm_vqvae(run2, device=DEVICE, chain_segment=SEGMENT)
        finally:
            os.chdir(cwd)
            if data_env is None:
                os.environ.pop("PM_TPU_DATA_DIR", None)
            else:
                os.environ["PM_TPU_DATA_DIR"] = data_env
    for name, t in vq1.state_dict().items():
        check(torch.equal(model2.vqvae.state_dict()[name], t),
              f"stage 2 changed the VQ-VAE's {name}")
    mask_fn = masking.get_mask_generator("MNISTMaskGenerator", device=DEVICE)
    req = masking.add_mask({"image": torch.rand(4, 28, 28, 1, generator=gen, device=DEVICE)},
                           gen, mask_fn)
    imp = pm_vqvae_impute(model2, req["image"], req["mask"], 2, generator=gen)
    torch.cuda.synchronize()
    check(imp.shape == (4, 2, 28, 28, 1) and bool(torch.isfinite(imp).all()),
          "an imputation from train_pm_vqvae's checkpoint failed")
    log("train_pm_vqvae read train_vqvae's run; its checkpoint holds stage 1's VQ-VAE and "
        "codebook unchanged, loads through load_pm_vqvae and served an imputation")
    return out


# ---------------------------------------------------------------------------
# Phase 9: PM-VDVAE
# ---------------------------------------------------------------------------


def mnist_batch(gen, dev, n, mask_fn):
    """``n`` seeded integer images in [0, 255] with MNIST-mixture masks."""
    from posterior_matching_torch.masking import add_mask

    x = torch.randint(0, 256, (n, 28, 28, 1), generator=gen, device=dev).float()
    return add_mask({"image": x}, gen, mask_fn)


def capture_runs(model, x, b):
    """The block-chain calls of one masked encode: each run's input and
    stacked weights, as the encoder hands them to the kernel."""
    from posterior_matching_torch.models import vdvae

    runs, chain = [], vdvae.block_chain

    def record(h, w, *, mid, k):
        runs.append((h.detach().clone(), {n: t.detach().clone() for n, t in w.items()},
                     mid, k))
        return chain(h, w, mid=mid, k=k)

    vdvae.block_chain = record
    try:
        with torch.no_grad():
            model.encode_masked(x, b)
    finally:
        vdvae.block_chain = chain
    return runs


def block_chain_phase(runs, seed):
    """Both block-chain kernels against autograd through the plain chain at
    each run's shapes, with a random cotangent on the run's output; each
    timed beside its bound and the plain version, relaunched bit for bit,
    its CUDA kernels a level counted."""
    from posterior_matching_torch.ops import block_chain as bc
    from posterior_matching_torch.ops.profiling import host_ms, time_ms

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 23)
    per_run = []
    for x, w, mid, k in runs:
        n_lvl, res, c = w["w1"].shape[0], x.shape[1], x.shape[-1]
        leaves = [t.clone().requires_grad_(True) for t in (x, *(w[n] for n in bc.NAMES))]
        lw = dict(zip(bc.NAMES, leaves[1:]))
        got = bc.block_chain(leaves[0], lw, mid=mid, k=k)
        want = bc.block_chain_plain(leaves[0], lw, mid=mid, k=k)
        torch.cuda.synchronize()
        fwd_err, rel = rel_err(got, want)
        check(rel <= CHAIN_TOL, f"block_chain_fwd res {res}: {rel:.3e} > {CHAIN_TOL}")
        cot = torch.randn(x.shape, generator=gen, device=x.device)
        gk = torch.autograd.grad(got, leaves, cot)
        gp = torch.autograd.grad(want, leaves, cot, retain_graph=True)
        torch.cuda.synchronize()
        bwd_err, worst = 0.0, ("", 0.0)
        for name, a, b_ in zip(("dx0", *("d" + n for n in bc.NAMES)), gk, gp):
            err, rel_g = rel_err(a, b_)
            bwd_err = max(bwd_err, err)
            worst = max(worst, (name, rel_g), key=lambda t_: t_[1])
            check(rel_g <= CHAIN_TOL, f"block_chain_bwd res {res} {name}: {rel_g:.3e}")
        log(f"block_chain res {res} (L = {n_lvl}, k = {k}, {x.shape[0]} images): output max "
            f"abs err {fwd_err:.3e} (relative to scale {rel:.3e}); 9 gradients max abs err "
            f"{bwd_err:.3e}, worst relative to scale {worst[1]:.3e} ({worst[0]})")

        cfg = bc.ChainConfig(x, n_lvl, mid, k)
        x0 = x.reshape(-1, c).contiguous()
        wc = {n: w[n].contiguous() for n in bc.NAMES}
        wk = {n: wc[n] for n in ("w1", "w2", "w3", "w4")}
        g = cot.reshape(-1, c).contiguous()
        with torch.no_grad():
            saves = bc.chain_fwd(cfg, x0, wc)
            saved = {"x0": x0, **saves}
            fwd_ms = time_ms(lambda: bc.chain_fwd(cfg, x0, wc), reps=10, warmup=2)
            bwd_ms = time_ms(lambda: bc.chain_bwd(cfg, g, saved, wk), reps=10, warmup=2)
            fwd_plain = time_ms(lambda: bc.block_chain_plain(x, w, mid=mid, k=k), reps=5)
        bwd_plain = time_ms(lambda: torch.autograd.grad(want, leaves, cot, retain_graph=True),
                            reps=5)
        grads = bc.chain_bwd(cfg, g, saved, wk)
        # a relaunch on the same inputs gives the same bits
        with torch.no_grad():
            saves2 = bc.chain_fwd(cfg, x0, wc)
            grads2 = bc.chain_bwd(cfg, g, saved, wk)
        torch.cuda.synchronize()
        check(all(torch.equal(saves[n], saves2[n]) for n in saves)
              and all(torch.equal(grads[n], grads2[n]) for n in grads),
              f"block_chain res {res}: a relaunch changed the bits")
        # CUDA kernels a level, from one profiled launch of each, and the
        # host's time to enqueue a launch
        calls = {"fwd": lambda: bc.chain_fwd(cfg, x0, wc),
                 "bwd": lambda: bc.chain_bwd(cfg, g, saved, wk)}
        per_level = {kind: kernels_a_level(f"block_chain_{kind} res {res}", fn,
                                           _BLOCK_CHAIN_KERNELS, n_lvl)
                     for kind, fn in calls.items()}
        host_us = {kind: host_ms(fn) * 1e3 / (per_level[kind] * n_lvl)
                   for kind, fn in calls.items()}
        # the backward does each product twice (data and weight gradients)
        flops = bc.chain_flops(x.shape[0], x.shape[1], x.shape[2], c, mid, k, n_lvl)
        fwd_bytes = nbytes(x0, *wc.values(), *saves.values())
        bwd_bytes = nbytes(g, *saved.values(), *wk.values(), *grads.values())
        run = {"res": res, "levels": n_lvl, "k": k, "rows": cfg.rows,
               "fwd": (fwd_err, fwd_ms, fwd_plain, flops, fwd_bytes),
               "bwd": (bwd_err, bwd_ms, bwd_plain, 2 * flops, bwd_bytes),
               "launches_per_level": per_level, "host_us_per_kernel": host_us}
        for kind in ("fwd", "bwd"):
            _, ms, pms, fl, by = run[kind]
            b_ms, b_by = bound_tc(fl, by)
            log(f"block_chain_{kind} res {res}: {ms:.4f} ms/launch (plain {pms:.3f}), bound "
                f"{b_ms:.4f} ms by {b_by} (float32 FMAs {bound(fl, by)[0]:.4f}; "
                f"{fl / 1e9:.3f} GFLOP, {by / 1e6:.1f} MB); {fl / (ms * 1e-3) / 1e12:.2f} "
                f"TFLOP/s of float32 work; {per_level[kind]:.1f} CUDA kernels a level, "
                f"{ms * 1e3 / (per_level[kind] * n_lvl):.1f} us each on the device's clock, "
                f"{host_us[kind]:.1f} us each to enqueue; relaunched bit for bit")
        per_run.append(run)
        del got, want, gk, gp, saves, saved, grads, saves2, grads2
    return chain_lines("block_chain", "posterior_matching_tpu/ops/block_chain.py",
                       (("fwd", 270), ("bwd", 308)), per_run, tc=True, design=BLOCK_DESIGN)


def vdvae_serving_phases(model, gen, mask_fn):
    """Imputation (three requests) and likelihood (one chunk), each with the
    chain's forward counter reset just before it and read just after."""
    from posterior_matching_torch.models.vdvae import vdvae_impute, vdvae_is_log_probs
    from posterior_matching_torch.ops import block_chain as bc

    bc.chain_fwd.launches = 0
    req_s, psnrs = [], []
    for i in range(REQUESTS):
        batch = mnist_batch(gen, DEVICE, BATCH, mask_fn)
        x, b = batch["image"], batch["mask"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imp = vdvae_impute(model, x, b, NUM_SAMPLES, generator=gen)
        torch.cuda.synchronize()
        req_s.append(time.perf_counter() - t0)
        check(imp.shape == (BATCH, NUM_SAMPLES, 28, 28, 1),
              f"imputations have shape {tuple(imp.shape)}")
        check(bool(torch.isfinite(imp).all()) and imp.min() >= 0 and imp.max() <= 255,
              "imputations are not finite values in [0, 255]")
        observed = (b == 1).expand_as(x)
        for s in range(NUM_SAMPLES):
            check(torch.equal(imp[:, s][observed], x[observed]),
                  "observed pixels were not copied through")
        # eval_pm_vdvae_imputation.py:94-96
        mse = ((imp.mean(1) / 255.0 - x / 255.0) ** 2).mean((1, 2, 3))
        psnr = (-10.0 * torch.log10(mse)).mean().item()
        check(np.isfinite(psnr), f"PSNR is not finite: {psnr}")
        psnrs.append(psnr)
        log(f"vdvae request {i}: {BATCH} images x {NUM_SAMPLES} samples in "
            f"{req_s[-1] * 1e3:.1f} ms = {BATCH / req_s[-1]:.2f} imgs/s, PSNR mean {psnr:.3f} dB")
    impute_launches = bc.chain_fwd.launches
    check(impute_launches == 5 * REQUESTS,
          f"block_chain_fwd launched {impute_launches} times over {REQUESTS} requests, "
          f"not {5 * REQUESTS}")
    steady = req_s[1:]
    imgs_per_s = BATCH * len(steady) / sum(steady)
    log(f"vdvae imputation: {imgs_per_s:.3f} imgs/s over requests 1-{REQUESTS - 1}; "
        f"block_chain_fwd launches {impute_launches} (5 a request)")
    split = profile_work(lambda: vdvae_impute(model, x, b, NUM_SAMPLES, generator=gen),
                         VDVAE_GROUPS, "profiled vdvae request")

    batch = mnist_batch(gen, DEVICE, LL_BATCH, mask_fn)
    bc.chain_fwd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    px, ac = vdvae_is_log_probs(model, batch["image"], batch["mask"], LL_SAMPLES,
                                batch_chunk=LL_BATCH, generator=gen)
    torch.cuda.synchronize()
    ll_s = time.perf_counter() - t0
    ll_launches = bc.chain_fwd.launches
    check(ll_launches == 10, f"block_chain_fwd launched {ll_launches} times in a chunk, not 10")
    check(px.shape == ac.shape == (LL_BATCH,), "likelihoods have the wrong shape")
    check(bool(torch.isfinite(px).all() and torch.isfinite(ac).all()),
          "likelihoods are not finite")
    bpd = (-px / (28 * 28 * np.log(2))).mean().item()   # eval_pm_vdvae_likelihood.py:146
    log(f"vdvae likelihood: {LL_BATCH} images x {LL_SAMPLES} importance samples in "
        f"{ll_s:.3f} s = {LL_BATCH / ll_s:.2f} imgs/s; BPD {bpd:.4f}, AC-LL "
        f"{ac.mean().item():.4f}; block_chain_fwd launches {ll_launches}")
    return {"imgs_per_s": imgs_per_s, "request_s": req_s, "psnr": psnrs,
            "impute_launches": impute_launches, "request_split": split,
            "likelihood_s": ll_s, "bpd": bpd, "ac_ll": ac.mean().item(),
            "likelihood_launches": ll_launches}


def fit_steps(trainer, batches, counters, expected, ckpt):
    """``TRAIN_STEPS`` steps of ``trainer`` with a checkpoint at the end;
    after each: its time, loss and the kernels' launches, each counter set
    to 0 just before the step. ``expected(name, count)`` says whether a
    step's count is right."""
    from posterior_matching_torch.train.callbacks import CheckpointCallback

    step_s, losses, launches = [], [], {k: 0 for k in counters}
    clock = [0.0]

    def reset():
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        clock[0] = time.perf_counter()

    def record(trainer_, metrics):
        loss = metrics["loss"].item()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - clock[0])
        counts = {k: c.launches for k, c in counters.items()}
        for k, v in counts.items():
            launches[k] += v
        losses.append(loss)
        log(f"train step {trainer_.step}: loss {loss:.4f} in {step_s[-1] * 1e3:.1f} ms; "
            f"launches {counts}")
        check(np.isfinite(loss), f"step {trainer_.step} loss is not finite")
        check(all(expected(k, v) for k, v in counts.items()),
              f"step {trainer_.step} did not launch the training kernels as expected: {counts}")
        reset()

    reset()
    trainer.fit(batches, TRAIN_STEPS, callbacks=[record, CheckpointCallback(ckpt)])
    steady = step_s[2:]
    return len(steady) / sum(steady), step_s, losses, launches


def vdvae_training_phase(model, model_config, args, gen, mask_fn, batches, fixed, expected,
                         small_config):
    """8 full-width steps of the PM-VDVAE trainer on ``batches``, then the
    checks: ``expected`` maps each kernel counter's name to its launches a
    step, ``small_config`` is the small model held against the CPU."""
    import tempfile

    from posterior_matching_torch import config, convert
    from posterior_matching_torch.models.vdvae import vdvae_impute
    from posterior_matching_torch.train.trainer import pm_vdvae_loss, pm_vdvae_trainer

    def eval_loss():
        with torch.no_grad():
            return pm_vdvae_loss(model, fixed, 1234).item()

    trainer = pm_vdvae_trainer(model, config.PM_VDVAE_MNIST_TRAIN, seed=args.seed,
                               mask_fn=mask_fn, device=DEVICE)
    trainer.init()
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    loss_before = eval_loss()
    run_dir = tempfile.TemporaryDirectory()
    counters = kernel_counters()
    steps_per_s, step_s, losses, launches = fit_steps(
        trainer, batches, counters, lambda name, count: count == expected.get(name, 0),
        f"{run_dir.name}/train_state.pkl")
    loss_after = eval_loss()
    log(f"vdvae training: {steps_per_s:.4f} steps/s over steps 3-{TRAIN_STEPS} (batch "
        f"{VDVAE_TRAIN_BATCH}); eval loss of a fixed batch {loss_before:.4f} -> "
        f"{loss_after:.4f}")
    check(loss_after < loss_before, "the eval loss did not drop")
    after = model.state_dict()
    for name in trainer.optimizer.params:
        check(not torch.equal(after[name], before[name]), f"{name} did not move")
    log(f"vdvae training: all {len(trainer.optimizer.params)} trainable tensors moved")

    small_vdvae_step_check(args.seed, small_config)

    with run_dir:
        with open(f"{run_dir.name}/model_config.json", "w") as fp:
            json.dump(model_config, fp)
        loaded = convert.load_pm_vdvae(run_dir.name, device=DEVICE)
    for name, t in loaded.state_dict().items():
        check(torch.equal(t, trainer.ema_params[name]),
              f"{name} is not the EMA parameter after the checkpoint")
    batch = mnist_batch(gen, DEVICE, 4, mask_fn)
    imp = vdvae_impute(loaded, batch["image"], batch["mask"], 2, generator=gen)
    torch.cuda.synchronize()
    check(imp.shape == (4, 2, 28, 28, 1) and bool(torch.isfinite(imp).all()),
          "an imputation from the checkpoint failed")
    log("vdvae checkpoint: train_state.pkl loads back through load_pm_vdvae with the EMA "
        "parameters, every tensor equal; an imputation request from it ran")
    split = profile_step(trainer, batches[-1], VDVAE_GROUPS)
    return {"steps_per_s": steps_per_s, "step_s": step_s, "losses": losses,
            "eval_loss": [loss_before, loss_after], "launches": launches, "split": split}


def kernel_counters():
    """The PM-VDVAE kernels' wrappers, whose ``launches`` count them."""
    from posterior_matching_torch.ops import block_chain as bc
    from posterior_matching_torch.ops import decoder_chain as dc

    return {"block_chain_fwd": bc.chain_fwd, "block_chain_bwd": bc.chain_bwd,
            "decoder_chain_fwd": dc.dec_fwd, "decoder_chain_bwd": dc.dec_bwd}


# The small models held against the CPU: width 192 (the kernels' MNIST
# width) on 8x8 images through the block chain, and configs/pm_vdvae_
# digits16.py's model (width 64) with the fused decoder (its 1x2 run, 4 rows
# at batch 4, stays unfused).
SMALL_VDVAE = {"image_shape": (8, 8, 1), "encoder_blocks": "8x3,8d2,4x2,4d4,1x2",
               "decoder_blocks": "1x1,4m1,4x1,8m4,8x2", "latent_dim": 16, "width": 192,
               "bottleneck_multiple": 0.25, "no_bias_above": 64, "num_mixtures": 10}
DIGITS16_FUSED = {"image_shape": (16, 16, 1), "encoder_blocks": "16x3,16d2,8x3,8d2,4x2,4d4,1x2",
                  "decoder_blocks": "1x2,4m1,4x2,8m4,8x3,16m8,16x3", "latent_dim": 8,
                  "width": 64, "bottleneck_multiple": 0.25, "no_bias_above": 32,
                  "num_mixtures": 5, "fused_chain": True}


def small_vdvae_step_check(seed, small):
    """The loss and every gradient of a small PM-VDVAE on the GPU against
    the plain path on the CPU, with the same injected normals: the loss
    within 1e-5 relative, every gradient within GRAD_TOL of its scale."""
    from posterior_matching_torch import convert
    from posterior_matching_torch.models.vdvae import parse_layer_string
    from posterior_matching_torch.train.trainer import pm_vdvae_loss

    tree = convert.random_pm_vdvae_tree(small, seed=seed + 7)
    g = torch.Generator().manual_seed(seed + 8)
    side, ld = small["image_shape"][0], small["latent_dim"]
    x = torch.randint(0, 256, (4, side, side, 1), generator=g).float()
    b = (torch.rand(4, side, side, 1, generator=g) > 0.5).float()
    eps = [torch.randn(4, r, r, ld, generator=g)
           for r, _ in parse_layer_string(small["decoder_blocks"])]
    out = {}
    counters = kernel_counters()
    for d in (DEVICE, "cpu"):
        m = convert.pm_vdvae_from_jax(tree, small, device=d)
        names, params = zip(*m.named_parameters())
        before = {k: c.launches for k, c in counters.items()}
        loss = pm_vdvae_loss(m, {"image": x.to(d), "mask": b.to(d)}, iter(eps))
        grads = torch.autograd.grad(loss, params)
        launched = {k: c.launches - before[k] for k, c in counters.items()}
        out[d] = (loss.item(), {n: gr.cpu() for n, gr in zip(names, grads)}, launched)
    (lg, gg, launched), (lc, gcpu, _) = out[DEVICE], out["cpu"]
    loss_rel = abs(lg - lc) / abs(lc)
    worst = max(((n, rel_err(gg[n], gcpu[n])[1]) for n in gcpu), key=lambda t: t[1])
    log(f"vdvae small step (width {small['width']}, fused_chain "
        f"{small.get('fused_chain')}) vs CPU plain path: loss {lg:.6f} vs {lc:.6f} (relative "
        f"{loss_rel:.3e}), worst gradient relative to scale {worst[1]:.3e} ({worst[0]}) over "
        f"{len(gcpu)} tensors; GPU launches {launched}")
    check(launched["block_chain_fwd"] > 0, "vdvae small step: the block chain did not run")
    check((launched["decoder_chain_bwd"] > 0) == bool(small.get("fused_chain")),
          "vdvae small step: the decoder chain ran where it should not, or not where it should")
    check(loss_rel <= STEP_LOSS_TOL, "vdvae small step: the loss disagrees with the CPU's")
    check(worst[1] <= GRAD_TOL, "vdvae small step: a gradient disagrees with the CPU's")


# ---------------------------------------------------------------------------
# Phase 10: PM-VDVAE through the fused decoder chain
# ---------------------------------------------------------------------------


def capture_dec_runs(model, batch, gen):
    """The decoder-chain calls of one fused training forward: each run's
    inputs, normals and stacked weights, as the decoder hands them over."""
    from posterior_matching_torch.models import vdvae

    runs, chain = [], vdvae.dec_chain

    def record(x0, acts, macts, eps, w, *, mid, ld, k):
        runs.append((*(t.detach().clone() for t in (x0, acts, macts, eps)),
                     {n: t.detach().clone() for n, t in w.items()}, mid, ld, k))
        return chain(x0, acts, macts, eps, w, mid=mid, ld=ld, k=k)

    vdvae.dec_chain = record
    try:
        with torch.no_grad():
            model(batch["image"], batch["mask"], gen)
    finally:
        vdvae.dec_chain = chain
    return runs


def decoder_chain_phase(runs, seed):
    """Both decoder-chain kernels against autograd through the plain chain
    at each run's shapes, with a random cotangent on each of the four
    outputs; each timed beside its bound and the plain version."""
    from posterior_matching_torch.ops import decoder_chain as dc
    from posterior_matching_torch.ops.profiling import time_ms

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 29)
    per_run = []
    out_names = ("x_final", "post", "prior", "masked")
    for x0, acts, macts, eps, w, mid, ld, k in runs:
        n_lvl, res, c = eps.shape[0], x0.shape[1], x0.shape[-1]
        leaves = [t.clone().requires_grad_(True)
                  for t in (x0, acts, macts, *(w[n] for n in dc.NAMES))]
        lw = dict(zip(dc.NAMES, leaves[3:]))
        got = dc.dec_chain(*leaves[:3], eps, lw, mid=mid, ld=ld, k=k)
        want = dc.dec_chain_plain(*leaves[:3], eps, lw, ld=ld, k=k)
        torch.cuda.synchronize()
        fwd_err, fwd_rel = 0.0, 0.0
        for name, a, b_ in zip(out_names, got, want):
            err, rel = rel_err(a, b_)
            fwd_err, fwd_rel = max(fwd_err, err), max(fwd_rel, rel)
            check(rel <= CHAIN_TOL, f"decoder_chain_fwd res {res} {name}: {rel:.3e} > {CHAIN_TOL}")
        cots = [torch.randn(t.shape, generator=gen, device=DEVICE) for t in want]
        gk = torch.autograd.grad(got, leaves, cots)
        gp = torch.autograd.grad(want, leaves, cots, retain_graph=True)
        torch.cuda.synchronize()
        bwd_err, worst = 0.0, ("", 0.0)
        for name, a, b_ in zip(("dx0", "dacts", "dmacts", *("d" + n for n in dc.NAMES)), gk, gp):
            err, rel_g = rel_err(a, b_)
            bwd_err = max(bwd_err, err)
            worst = max(worst, (name, rel_g), key=lambda t_: t_[1])
            check(rel_g <= CHAIN_TOL, f"decoder_chain_bwd res {res} {name}: {rel_g:.3e}")
        log(f"decoder_chain res {res} (L = {n_lvl}, k = {k}, {x0.shape[0]} images): 4 outputs "
            f"max abs err {fwd_err:.3e} (relative to scale {fwd_rel:.3e}); {len(gk)} gradients "
            f"max abs err {bwd_err:.3e}, worst relative to scale {worst[1]:.3e} ({worst[0]})")

        cfg = dc.DecConfig(x0, acts, n_lvl, mid, ld, k)
        flat = lambda t: t.reshape(-1, t.shape[-1]).contiguous()
        lvl = lambda t: t.reshape(n_lvl, cfg.rows, t.shape[-1]).contiguous()
        inputs = {"x0": flat(x0), "acts": flat(acts), "macts": flat(macts), "eps": lvl(eps),
                  **{n: w[n].contiguous() for n in dc.NAMES}}
        cot = {"g": flat(cots[0]), "gpost": lvl(cots[1]), "gprior": lvl(cots[2]),
               "gmask": lvl(cots[3])}
        weights = {n: inputs[n] for n in dc.NAMES}
        with torch.no_grad():
            outs = dc.dec_fwd(cfg, inputs)
            saved = {n: {**inputs, **outs}[n] for n in dc._SAVED}
            fwd_ms = time_ms(lambda: dc.dec_fwd(cfg, inputs), reps=5, warmup=1)
            bwd_ms = time_ms(lambda: dc.dec_bwd(cfg, cot, saved, weights), reps=5, warmup=1)
            fwd_plain = time_ms(lambda: dc.dec_chain_plain(x0, acts, macts, eps, w, ld=ld, k=k),
                                reps=3)
        bwd_plain = time_ms(lambda: torch.autograd.grad(want, leaves, cots, retain_graph=True),
                            reps=3)
        grads = dc.dec_bwd(cfg, cot, saved, weights)
        # a relaunch on the same inputs gives the same bits
        with torch.no_grad():
            outs2 = dc.dec_fwd(cfg, inputs)
            grads2 = dc.dec_bwd(cfg, cot, saved, weights)
        torch.cuda.synchronize()
        check(all(torch.equal(outs[n], outs2[n]) for n in outs)
              and all(torch.equal(grads[n], grads2[n]) for n in grads),
              f"decoder_chain res {res}: a relaunch changed the bits")
        # CUDA kernels a level, from one profiled launch of each
        per_level = {kind: kernels_a_level(f"decoder_chain_{kind} res {res}", fn,
                                           _DECODER_CHAIN_KERNELS, n_lvl) for kind, fn in (
            ("fwd", lambda: dc.dec_fwd(cfg, inputs)),
            ("bwd", lambda: dc.dec_bwd(cfg, cot, saved, weights)))}
        # the backward does each product twice (data and weight gradients),
        # but for the masked Block's input-side data gradient on the state
        flops = dc.chain_flops(x0.shape[0], x0.shape[1], x0.shape[2], c, mid, ld, k, n_lvl)
        bwd_flops = dc.bwd_flops(flops, cfg.rows, c, mid, n_lvl)
        read_w = [t for n, t in weights.items() if n != "bz" and "_b" not in n]
        fwd_bytes = nbytes(*inputs.values(), *outs.values())
        bwd_bytes = nbytes(*cot.values(), *saved.values(), *read_w, *grads.values())
        run = {"res": res, "levels": n_lvl, "k": k, "rows": cfg.rows,
               "fwd": (fwd_err, fwd_ms, fwd_plain, flops, fwd_bytes),
               "bwd": (bwd_err, bwd_ms, bwd_plain, bwd_flops, bwd_bytes),
               "launches_per_level": per_level}
        for kind in ("fwd", "bwd"):
            _, ms, pms, fl, by = run[kind]
            b_ms, b_by = bound_tc(fl, by)
            log(f"decoder_chain_{kind} res {res}: {ms:.4f} ms/launch (plain {pms:.3f}), bound "
                f"{b_ms:.4f} ms by {b_by} (float32 FMAs {bound(fl, by)[0]:.4f}; "
                f"{fl / 1e9:.3f} GFLOP, {by / 1e6:.1f} MB); {fl / (ms * 1e-3) / 1e12:.2f} "
                f"TFLOP/s of float32 work; {per_level[kind]:.1f} CUDA kernels a level; "
                f"relaunched bit for bit")
        per_run.append(run)
        del got, want, gk, gp, outs, saved, grads, outs2, grads2
    return chain_lines("decoder_chain", "posterior_matching_tpu/ops/decoder_chain.py",
                       (("fwd", 226), ("bwd", 291)), per_run, tc=True, design=DECODER_DESIGN)


def kernel_launches(fn, markers):
    """The kernels (of a chain, by their names' ``markers``) that one
    ``fn()`` launches, counted by ``torch.profiler`` between witness kernels
    (``profiling.profile_calls``), or None where no window measured
    them."""
    from posterior_matching_torch.ops.profiling import profile_calls

    prof = profile_calls(fn, 1)
    if prof is None:
        return None
    return sum(n for name, n in prof[2].items() if any(m in name for m in markers))


def kernels_a_level(what, fn, markers, n_lvl):
    """:func:`kernel_launches` over the run's levels; fails unless the
    count was measured and saw the chain's kernels."""
    n = kernel_launches(fn, markers)
    check(n is not None, f"{what}: the profiler lost part of three windows")
    check(n > 0, f"{what}: the profiler saw none of its kernels")
    return n / n_lvl


def chain_lines(name, replaces, kinds, per_run, tc=False, design=None):
    """The kernels-line entries of a chain's two kernels: per launch the
    mean over the runs, and each run beside it. With ``tc`` the bound is
    the tensor cores' (:func:`bound_tc`) and the float32 FMA bound stands
    beside it."""
    out = []
    mean = lambda vals: sum(vals) / len(vals)
    bnd = bound_tc if tc else bound
    for kind, line in kinds:
        per = [r[kind] for r in per_run]
        work = (mean([p[3] for p in per]), mean([p[4] for p in per]))
        b_ms, b_by = bnd(*work)
        out.append({
            "name": f"{name}_{kind}", "route": "cuda",
            "source": f"posterior_matching_torch/ops/csrc/{name}_{kind}.cu",
            "replaces": f"{replaces}:{line}",
            "max_abs_err": max(p[0] for p in per),
            "ms": mean([p[1] for p in per]), "plain_ms": mean([p[2] for p in per]),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            **({"bound_f32_ms": bound(*work)[0], "design": design} if tc else {}),
            "per_run": [{"res": r["res"], "levels": r["levels"], "k": r["k"],
                         "ms": r[kind][1], "plain_ms": r[kind][2],
                         "bound_ms": bnd(r[kind][3], r[kind][4])[0],
                         "gflop": r[kind][3] / 1e9, "mb": r[kind][4] / 1e6,
                         "tflops": r[kind][3] / (r[kind][1] * 1e-3) / 1e12,
                         **({"kernels_per_level": r["launches_per_level"][kind]}
                            if "launches_per_level" in r else {}),
                         **({"host_us_per_kernel": r["host_us_per_kernel"][kind]}
                            if "host_us_per_kernel" in r else {})}
                        for r in per_run],
        })
    return out


def fused_step_check(unfused, fused, batch, gen):
    """The first step of the fused model against the unfused one at full
    width on the card, the same batch and injected normals: the loss within
    1e-5 relative, every gradient within GRAD_TOL of its scale."""
    from posterior_matching_torch.train.trainer import pm_vdvae_loss

    n, ld = batch["image"].shape[0], fused.decoder.latent_dim
    eps = [torch.randn(n, r, r, ld, generator=gen, device=DEVICE)
           for r, _ in fused.decoder.specs]
    counters = kernel_counters()
    out = {}
    for name, m in (("unfused", unfused), ("fused", fused)):
        before = {k: c.launches for k, c in counters.items()}
        names, params = zip(*m.named_parameters())
        loss = pm_vdvae_loss(m, batch, iter(eps))
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        out[name] = (loss.item(), dict(zip(names, grads)),
                     {k: c.launches - before[k] for k, c in counters.items()})
    (lu, gu, _), (lf, gf, launched) = out["unfused"], out["fused"]
    loss_rel = abs(lf - lu) / abs(lu)
    worst = max(((n_, rel_err(gf[n_], gu[n_])[1]) for n_ in gu), key=lambda t: t[1])
    log(f"fused vs unfused first step at full width: loss {lf:.6f} vs {lu:.6f} (relative "
        f"{loss_rel:.3e}), worst gradient relative to scale {worst[1]:.3e} ({worst[0]}) over "
        f"{len(gu)} tensors; fused launches {launched}")
    check(launched["decoder_chain_fwd"] == 5 and launched["decoder_chain_bwd"] == 5,
          f"the fused step launched the decoder chain {launched}, not 5 + 5")
    check(loss_rel <= STEP_LOSS_TOL, "the fused step's loss disagrees with the unfused one's")
    check(worst[1] <= GRAD_TOL, "a fused step's gradient disagrees with the unfused one's")
    return {"loss": [lf, lu], "loss_rel": loss_rel, "worst_grad": worst}


def cli_phase(args, gen, mask_fn):
    """``train_pm_vdvae`` at full width with the fused decoder on small
    synthetic MNIST files, in this process (the kernels are built): its run
    directory, validation lines, decoder-chain launches and checkpoint."""
    import contextlib
    import glob
    import io
    import os
    import tempfile

    from posterior_matching_torch import config, convert, train_pm_vdvae
    from posterior_matching_torch.data import load_arrays
    from posterior_matching_torch.models.vdvae import vdvae_impute
    from posterior_matching_torch.ops import decoder_chain as dc

    steps, n_train, n_test, batch = 4, 512, 64, 16
    cwd, data_env = os.getcwd(), os.environ.get("PM_TPU_DATA_DIR")
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(f"{tmp}/data/mnist")
        os.environ["PM_TPU_DATA_DIR"] = f"{tmp}/data"
        try:
            for split, n in (("train", n_train), ("test", n_test)):
                arrays = load_arrays("mnist", split)   # the synthetic stand-in
                np.savez(f"{tmp}/data/mnist/{split}.npz",
                         **{k: v[:n] for k, v in arrays.items()})
            os.chdir(tmp)
            f0, b0 = dc.dec_fwd.launches, dc.dec_bwd.launches
            printed = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                rc = train_pm_vdvae.main([
                    "--config", "pm_vdvae_mnist", "--config.steps", str(steps),
                    "--config.validation_freq", str(steps // 2), "--config.seed",
                    str(args.seed), "--config.model.fused_chain=True"])
            wall = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
            if data_env is None:
                os.environ.pop("PM_TPU_DATA_DIR", None)
            else:
                os.environ["PM_TPU_DATA_DIR"] = data_env
        fwd, bwd = dc.dec_fwd.launches - f0, dc.dec_bwd.launches - b0
        lines = printed.getvalue().splitlines()
        for line in lines:
            log(f"  train_pm_vdvae: {line}")
        check(rc == 0, f"train_pm_vdvae exited with {rc}")
        run_dirs = glob.glob(f"{tmp}/runs/pm-vdvae-mnist-*")
        check(len(run_dirs) == 1, f"train_pm_vdvae made the run directories {run_dirs}")
        files = sorted(os.listdir(run_dirs[0]))
        check(files == ["model_config.json", "train_meta.json", "train_state.pkl"],
              f"the run directory holds {files}")
        steps_lines = [ln for ln in lines if ln.startswith("[step ")]
        check(len(steps_lines) == 2 and all("val_loss=" in ln for ln in steps_lines),
              "train_pm_vdvae did not log two validations with val_loss")
        n_val = n_test // batch
        check(bwd == 5 * steps and fwd == 5 * (steps + 2 * n_val),
              f"train_pm_vdvae launched the decoder chain {fwd} + {bwd} times, not "
              f"{5 * (steps + 2 * n_val)} + {5 * steps}")
        with open(f"{run_dirs[0]}/model_config.json") as fp:
            written = json.load(fp)
        loaded = convert.load_pm_vdvae(run_dirs[0], device=DEVICE, fused_chain=True)
    check(set(written) == set(config.PM_VDVAE_MNIST),
          f"the run's model_config.json holds {sorted(written)}, not the config file's keys")
    check(loaded.decoder.fused, "load_pm_vdvae did not take fused_chain=True")
    req = mnist_batch(gen, DEVICE, 4, mask_fn)
    imp = vdvae_impute(loaded, req["image"], req["mask"], 2, generator=gen)
    torch.cuda.synchronize()
    check(imp.shape == (4, 2, 28, 28, 1) and bool(torch.isfinite(imp).all()),
          "an imputation from the CLI's checkpoint failed")
    log(f"train_pm_vdvae: {steps} steps and 2 validations of {n_val} batches in {wall:.1f} s; "
        f"run directory {files}; decoder chain launches {fwd} fwd + {bwd} bwd; the checkpoint "
        "holds the config file's model keys, loads through load_pm_vdvae (fused on request) and "
        "served an imputation")
    return {"wall_s": wall, "lines": steps_lines, "dec_launches": [fwd, bwd]}


def vdvae_phases(args, gen):
    """Phases 9 to 11: the model, the kernel comparisons, the three paths,
    then training through the fused decoder and the CLI."""
    from posterior_matching_torch import config, convert, masking
    from posterior_matching_torch.models.vdvae import PosteriorMatchingVDVAE

    model_config = config.PM_VDVAE_MNIST
    if args.vdvae_run_dir:
        model = convert.load_pm_vdvae(args.vdvae_run_dir, device=DEVICE)
        with open(f"{args.vdvae_run_dir}/model_config.json") as fp:
            model_config = json.load(fp)
        weights_from = args.vdvae_run_dir
    else:
        tree = convert.random_pm_vdvae_tree(model_config, seed=args.seed)
        model = convert.pm_vdvae_from_jax(tree, model_config, device=DEVICE)
        weights_from = f"seed {args.seed}"
    model_config = dict(model_config, fused_chain=None)
    fused_config = dict(model_config, fused_chain=True)
    fused = PosteriorMatchingVDVAE.from_config(fused_config, device=DEVICE)
    fused.load_state_dict(model.state_dict())
    log(f"model: PM-VDVAE MNIST, weights from {weights_from}; width "
        f"{model_config['width']}, latent {model_config['latent_dim']}, "
        f"{len(model.encoder.specs)} encoder / {model.decoder.n_blocks} decoder blocks, "
        f"{sum(p.numel() for p in model.parameters())} parameters")
    mask_fn = masking.get_mask_generator("MNISTMaskGenerator", device=DEVICE)
    batch = mnist_batch(gen, DEVICE, VDVAE_TRAIN_BATCH, mask_fn)
    runs = capture_runs(model, batch["image"], batch["mask"])
    check([(r[0].shape[1], r[1]["w1"].shape[0], r[3]) for r in runs]
          == [(28, 6, 3), (14, 4, 3), (7, 2, 3), (3, 2, 3), (1, 2, 1)],
          "the encoder's runs are not the config's five")
    kernel_lines = block_chain_phase(runs, args.seed)
    del runs
    stamp("PM-VDVAE imputation and likelihood")
    serving = vdvae_serving_phases(model, gen, mask_fn)

    # ---- 10. the fused decoder: kernels, the first step, training --------
    stamp("decoder chain kernels")
    dec_runs = capture_dec_runs(fused, batch, gen)
    check([(r[0].shape[1], r[3].shape[0], r[7]) for r in dec_runs]
          == [(1, 2, 1), (3, 3, 3), (7, 3, 3), (14, 5, 3), (28, 7, 3)],
          "the decoder's fused runs are not the config's five")
    dec_lines = decoder_chain_phase(dec_runs, args.seed)
    del dec_runs
    first_step = fused_step_check(model, fused, batch, gen)

    batches = [{"image": mnist_batch(gen, DEVICE, VDVAE_TRAIN_BATCH, mask_fn)["image"]}
               for _ in range(TRAIN_STEPS)]
    fixed = mnist_batch(gen, DEVICE, VDVAE_TRAIN_BATCH, mask_fn)
    stamp("PM-VDVAE training")
    train = vdvae_training_phase(model, model_config, args, gen, mask_fn, batches, fixed,
                                 {"block_chain_fwd": 10, "block_chain_bwd": 10},
                                 SMALL_VDVAE)
    stamp("PM-VDVAE training through the fused decoder")
    fused_train = vdvae_training_phase(
        fused, fused_config, args, gen, mask_fn, batches, fixed,
        {"block_chain_fwd": 10, "block_chain_bwd": 10, "decoder_chain_fwd": 5,
         "decoder_chain_bwd": 5}, DIGITS16_FUSED)
    for lines, run in ((kernel_lines, train), (dec_lines, fused_train)):
        for line in lines:
            line["launches"] = run["launches"][line["name"]]
            line["launches_per_step"] = line["launches"] / TRAIN_STEPS
    log(f"kernel launches over {TRAIN_STEPS} training steps: unfused {train['launches']}, "
        f"fused {fused_train['launches']}; block_chain_fwd launches on the other paths: "
        f"imputation {serving['impute_launches']}, likelihood {serving['likelihood_launches']}")

    # ---- 11. the training CLI -----------------------------------------------
    stamp("the training CLI")
    cli = cli_phase(args, gen, mask_fn)
    return kernel_lines + dec_lines, {"serving": serving, "training": train,
                                      "fused_first_step": first_step,
                                      "fused_training": fused_train, "cli": cli}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--run_dir", default=None)
    parser.add_argument("--vdvae_run_dir", default=None)
    parser.add_argument("--out", default="chiprun_out/chip_smoke")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    from posterior_matching_torch import config, convert, masking
    from posterior_matching_torch.models.pm_vqvae import pm_vqvae_impute
    from posterior_matching_torch.ops import _build, sampler_chain as sc
    from posterior_matching_torch.ops.profiling import time_ms

    dev = torch.device(DEVICE)
    out_dir = repo / args.out
    out_dir.mkdir(parents=True, exist_ok=True)

    # ---- 1. header -------------------------------------------------------
    smi = nvidia_smi_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}")

    # ---- 2. build, then each kernel against its plain version -------------
    t0 = time.perf_counter()
    reports = _build.build()
    log(f"built {sorted(reports) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        (out_dir / f"ptxas_{name}.txt").write_text(rep)
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    vq_cfg = config.VQVAE_CELEB_A
    pm_cfg = config.PM_VQVAE_CELEB_A
    pc_cfg = pm_cfg["pixel_cnn"]
    if args.run_dir:
        model = convert.load_pm_vqvae(args.run_dir, device=DEVICE)
        weights_from = args.run_dir
    else:
        params, state = convert.random_pm_vqvae_tree(
            pm_cfg["conditional_dim"], vq_cfg, pc_cfg, seed=args.seed
        )
        model = convert.pm_vqvae_from_jax(
            params, state, pm_cfg["conditional_dim"], vq_cfg, pc_cfg,
            device=DEVICE,
        )
        weights_from = f"seed {args.seed}"
    pcnn = model.pixel_cnn
    f, n_lvl = pcnn.num_filters, 2 * pcnn.num_resnet
    hgt, wid = pcnn.image_shape
    k_idx = pcnn.num_indices
    n = BATCH * NUM_SAMPLES
    log(f"model: PM-VQVAE CelebA, weights from {weights_from}; PixelCNN "
        f"{pcnn.num_resnet} resnet x {f} filters, {hgt}x{wid} codes, K={k_idx}; "
        f"n = {BATCH} x {NUM_SAMPLES} = {n}")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    mask_fn = masking.get_mask_generator("CelebAMaskGenerator", device=DEVICE)
    image_shape = (BATCH, *config.CELEB_A_IMAGE_SHAPE)

    def request_batch():
        x = torch.rand(image_shape, generator=gen, device=dev)
        return masking.add_mask({"image": x}, gen, mask_fn)

    # Main-path inputs of image row 1: row 0 is run through the plain
    # versions first, so the previous-row state is what the sampler sees.
    with torch.no_grad():
        batch = request_batch()
        cond = model.conditional_latents(batch["image"], batch["mask"])
        cond = cond[None].expand(NUM_SAMPLES, *cond.shape).reshape(n, -1)
        w = sc.fuse_sampler_weights(pcnn)
        cpv, cph = sc.cond_projections(pcnn, cond, n)
        z = torch.zeros(wid, n, f, device=dev)
        zl = torch.zeros(n_lvl, wid, n, f, device=dev)
        zm = torch.zeros(n_lvl, wid, n, 2 * f, device=dev)
        g0 = sc.gumbel_noise((wid, n, k_idx), gen, dev)
        g1 = sc.gumbel_noise((wid, n, k_idx), gen, dev)
        wv = (w.viw, w.vib, w.huw, w.hub, w.wav, w.bav, w.wbv, w.bbv, w.waux)
        wr = (w.wa, w.ba, w.wb, w.bb, cph)
        wt = (w.emb, w.lw, w.lb, w.hlw, w.hlb)
        outv0, outm0, v00, hup0 = sc.vrow_plain(z, z, z, zl, zm, cpv, *wv)
        outh0, outmh0, s0, _ = sc.row_plain(*wr, zl, zm, outv0, hup0, z, g0, *wt)
        e1 = w.emb[s0.long()].contiguous()
        vrow_in = (z, e1, v00, outv0, outm0, cpv, *wv)

        want_v = sc.vrow_plain(*vrow_in)
        got_v = sc.vrow(*vrow_in)
        torch.cuda.synchronize()
        vrow_err = 0.0
        for name, gt, wt_ in zip(("outv", "outm", "v0", "hup"), got_v, want_v):
            err, rel = rel_err(gt, wt_)
            vrow_err = max(vrow_err, err)
            log(f"vrow {name}: max abs err {err:.3e}, relative to scale {rel:.3e}")
            if not rel <= VROW_TOL:
                raise AssertionError(f"vrow {name} disagrees: {rel:.3e} > {VROW_TOL}")

        outv1, _, _, hup1 = want_v
        row_in = (*wr, outh0, outmh0, outv1, hup1, e1, g1, *wt)
        want_r = sc.row_plain(*row_in, with_logits=True)
        got_r = sc.row(*row_in, with_logits=True)
        torch.cuda.synchronize()
        same = got_r[2] == want_r[2]                      # [W, n]
        agree = same.float().mean().item()
        log(f"row samples agree on {agree:.6f} of {same.numel()} positions")
        if agree < SAMPLE_AGREEMENT:
            raise AssertionError(f"row samples agree on {agree} < {SAMPLE_AGREEMENT}")
        # logits are comparable where every earlier sample of the chain agreed
        prefix = torch.cumprod(same.int(), 0).bool()
        ok = torch.cat([torch.ones_like(prefix[:1]), prefix[:-1]], 0)
        row_err, rel = rel_err(got_r[3][ok], want_r[3][ok])
        log(f"row logits: max abs err {row_err:.3e}, relative to scale {rel:.3e} "
            f"over {ok.float().mean().item():.4f} of positions")
        if not rel <= LOGITS_TOL:
            raise AssertionError(f"row logits disagree: {rel:.3e} > {LOGITS_TOL}")

        # times at the main path's shapes (the plain versions run the same
        # arithmetic as many small launches; no single library call
        # computes either chain)
        vrow_ms = time_ms(lambda: sc.vrow(*vrow_in), reps=10)
        vrow_plain_ms = time_ms(lambda: sc.vrow_plain(*vrow_in), reps=3)
        row_ms = time_ms(lambda: sc.row(*row_in), reps=10)
        row_plain_ms = time_ms(lambda: sc.row_plain(*row_in), reps=2)

    n_res = pcnn.num_resnet
    vrow_flops = 2 * wid * n * (9 * f * f + n_lvl * (12 * f * f + 24 * f * f) + n_res * 2 * f * f)
    row_flops = 2 * n * wid * (2 * f * f + n_lvl * (12 * f * f + 16 * f * f) + f * k_idx)
    vrow_bytes = nbytes(*vrow_in, *want_v)
    row_bytes = nbytes(*row_in, *want_r[:3])  # timed without the logits out

    vrow_bound, vrow_by = bound(vrow_flops, vrow_bytes)
    row_bound, row_by = bound(row_flops, row_bytes)
    log(f"vrow: {vrow_ms:.3f} ms/launch (plain {vrow_plain_ms:.3f}), bound "
        f"{vrow_bound:.3f} ms by {vrow_by} ({vrow_flops / 1e9:.1f} GFLOP, "
        f"{vrow_bytes / 1e6:.1f} MB)")
    log(f"row:  {row_ms:.3f} ms/launch (plain {row_plain_ms:.3f}), bound "
        f"{row_bound:.3f} ms by {row_by} ({row_flops / 1e9:.1f} GFLOP, "
        f"{row_bytes / 1e6:.1f} MB)")
    # The row kernel streams every weight of a pixel once per block (8
    # samples), pixel by pixel: hlw, wa and wb of each level, lw.
    row_blocks = -(-n // 8)
    row_wbytes = row_blocks * wid * 4 * (2 * f * f + n_lvl * 28 * f * f + f * k_idx)
    log(f"row:  weight stream {row_wbytes / row_blocks / (row_ms * 1e6):.1f} GB/s "
        f"per busy SM ({row_blocks} blocks, {row_wbytes / 1e9:.1f} GB a launch), "
        f"{row_flops / (row_ms * 1e6):.1f} GFLOP/s, {row_ms / row_bound:.2f}x its bound")
    # The vrow kernel streams every weight once per block (TS samples):
    # viw, huw, then wav, waux (down levels) and wbv of each level.
    vrow_nblocks = sc.vrow_blocks(wid, n)
    vrow_wbytes = vrow_nblocks * 4 * (9 * f * f + n_lvl * 36 * f * f + n_res * 2 * f * f)
    log(f"vrow: {vrow_nblocks} blocks ({-(-n // vrow_nblocks)} samples each), weight "
        f"stream {vrow_wbytes / vrow_nblocks / (vrow_ms * 1e6):.1f} GB/s per busy SM "
        f"({vrow_wbytes / 1e9:.2f} GB of L2 reads a launch), "
        f"{vrow_flops / (vrow_ms * 1e6) / vrow_nblocks:.1f} GFLOP/s per busy SM, "
        f"{vrow_ms / vrow_bound:.2f}x its bound")

    # ---- 3. the slice: three imputation requests ---------------------------
    stamp("PM-VQVAE imputation")
    sc.vrow.launches = 0
    sc.row.launches = 0
    req_s, psnrs = [], []
    for i in range(REQUESTS):
        batch = request_batch()
        x, b = batch["image"], batch["mask"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imp = pm_vqvae_impute(model, x, b, NUM_SAMPLES, generator=gen)
        torch.cuda.synchronize()
        req_s.append(time.perf_counter() - t0)
        if imp.shape != (BATCH, NUM_SAMPLES, *config.CELEB_A_IMAGE_SHAPE):
            raise AssertionError(f"imputations have shape {tuple(imp.shape)}")
        if not torch.isfinite(imp).all() or imp.min() < 0 or imp.max() > 1:
            raise AssertionError("imputations are not finite values in [0, 1]")
        observed = (b != 0).expand_as(x)
        if not torch.equal(imp[:, 0][observed], x[observed]):
            raise AssertionError("observed pixels were not copied through")
        mse = ((imp.mean(1) - x) ** 2).mean((1, 2, 3))
        psnr = (-10.0 * torch.log10(mse)).mean().item()
        if not np.isfinite(psnr):
            raise AssertionError(f"PSNR is not finite: {psnr}")
        psnrs.append(psnr)
        log(f"request {i}: {BATCH} images x {NUM_SAMPLES} samples in "
            f"{req_s[-1] * 1e3:.1f} ms = {BATCH / req_s[-1]:.2f} imgs/s, "
            f"PSNR mean {psnr:.3f} dB")
    launches = {"sampler_vrow": sc.vrow.launches, "sampler_row": sc.row.launches}
    log(f"kernel launches over {REQUESTS} requests: {launches} "
        f"(expected {REQUESTS * hgt} each)")
    for name, count in launches.items():
        if count != REQUESTS * hgt:
            raise AssertionError(f"{name} launched {count} times, not {REQUESTS * hgt}")
    steady = req_s[1:]
    log(f"imputation: {BATCH * len(steady) / sum(steady):.3f} imgs/s over "
        f"requests 1-{REQUESTS - 1}; kernels' share of a request "
        f"~{hgt * (vrow_ms + row_ms) / (1e3 * np.mean(steady)):.3f}")

    # A small request through the kernels against the plain path on the CPU,
    # with the same noise: the same codes, and imputations to 1e-4.
    cpu_model = type(model)(
        pm_cfg["conditional_dim"], vq_cfg, pc_cfg
    ).eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    xs, bs = x[:2], b[:2]
    noise = sc.gumbel_noise((hgt, wid, 2 * 2, k_idx), gen, dev)
    with torch.no_grad():
        cond_g = model.conditional_latents(xs, bs)
        codes_g = sc.pixelcnn_sample(pcnn, 2, cond_g, noise=noise)
        cond_c = cpu_model.conditional_latents(xs.cpu(), bs.cpu())
        codes_c = sc.pixelcnn_sample(cpu_model.pixel_cnn, 2, cond_c, noise=noise.cpu())
        imp_g = pm_vqvae_impute(model, xs, bs, 2, noise=noise)
        imp_c = pm_vqvae_impute(cpu_model, xs.cpu(), bs.cpu(), 2, noise=noise.cpu())
    code_agree = (codes_g.cpu() == codes_c).float().mean().item()
    same_grid = (codes_g.cpu() == codes_c).flatten(2).all(-1).T  # [B, S]
    imp_err = (imp_g.cpu() - imp_c)[same_grid].abs().max().item()
    log(f"small request vs CPU plain path: codes agree on {code_agree:.5f}, "
        f"imputation max abs err {imp_err:.3e} over {int(same_grid.sum())} of 4 grids")
    if code_agree < SAMPLE_AGREEMENT or imp_err > 1e-4:
        raise AssertionError("the GPU path disagrees with the CPU plain path")

    # ---- 4. the codebook search, 5. the gated chain kernels, 6. the modes --
    stamp("codebook search and gated chain kernels")
    train_batch = request_batch()
    vq_line = vq_phase(model, train_batch["image"])
    chain_lines = stream_phase(model, train_batch["image"], train_batch["mask"], args.seed)
    stamp("pair and segment kernels")
    chain_lines += level_phase(model, train_batch["image"], train_batch["mask"], args.seed)
    first_step = modes_step_check(model, train_batch, args.seed)

    # ---- 7. training, one run per chain mode from the same weights ---------
    batches = [{"image": torch.rand(image_shape, generator=gen, device=dev)}
               for _ in range(TRAIN_STEPS)]
    fixed = masking.add_mask({"image": batches[0]["image"]}, gen, mask_fn)
    init_sd = {k: v.clone() for k, v in model.state_dict().items()}
    train = {}
    for mode in ("stream", 1, SEGMENT):
        stamp(f"PM-VQVAE training, chain_segment={mode}")
        model.load_state_dict(init_sd)
        train[str(mode)] = training_phase(model, args, mask_fn, gen, batches, fixed, pm_cfg,
                                          vq_cfg, pc_cfg, mode)
    del init_sd
    run_of = {"gated_pair": "1", "gated_segment": str(SEGMENT)}
    for line in (vq_line, *chain_lines):
        run = train[run_of.get(line["name"].rsplit("_", 1)[0], "stream")]
        line["launches"] = run["launches"][line["name"]]
        line["launches_per_step"] = line["launches"] / TRAIN_STEPS

    # ---- 8. the PM-VQVAE training CLIs ---------------------------------------
    stamp("the PM-VQVAE training CLIs")
    vqvae_cli = vqvae_cli_phase(args, gen)

    # ---- 9-11. PM-VDVAE ------------------------------------------------------
    stamp("PM-VDVAE")
    vdvae_lines, vdvae = vdvae_phases(args, gen)

    # ---- 12. results -------------------------------------------------------
    stamp("results")
    kernels = [
        {"name": "sampler_vrow", "route": "cuda",
         "source": "posterior_matching_torch/ops/csrc/sampler_vrow.cu",
         "replaces": "posterior_matching_tpu/ops/sampler_chain.py:124",
         "launches": launches["sampler_vrow"], "max_abs_err": vrow_err,
         "ms": vrow_ms, "plain_ms": vrow_plain_ms, "bound_ms": vrow_bound,
         "bound_by": vrow_by, "library_ms": None,
         "design": f"{vrow_nblocks} blocks of 12 warps; operands built in shared "
                   "memory once a GEMM (zero halo rows); weights streamed by "
                   "cp.async.bulk through 3 x 32 KB mbarrier slots, each refilled by "
                   "the last warp done with it; 16 rows x 4 or 8 x 8 columns a "
                   "thread, split-K reduced in fixed order"},
        {"name": "sampler_row", "route": "cuda",
         "source": "posterior_matching_torch/ops/csrc/sampler_row.cu",
         "replaces": "posterior_matching_tpu/ops/sampler_chain.py:215",
         "launches": launches["sampler_row"], "max_abs_err": row_err,
         "ms": row_ms, "plain_ms": row_plain_ms, "bound_ms": row_bound,
         "bound_by": row_by, "library_ms": None,
         "design": "one block of 8 consumer warps + 1 producer warp per 8 samples; "
                   "operands gathered into shared memory once a GEMM; weights "
                   "streamed by cp.async.bulk through 2 x 64 KB mbarrier slots; "
                   "8 samples x 4 columns a lane, split-K reduced in fixed order"},
        vq_line, *chain_lines, *vdvae_lines,
    ]
    summary = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "imgs_per_s": BATCH * len(steady) / sum(steady),
        "request_s": req_s, "psnr": psnrs, "modes_first_step": first_step,
        "training": train, "vqvae_cli": vqvae_cli, "vdvae": vdvae, "kernels": kernels,
    }
    (out_dir / "summary.json").write_text(json.dumps(summary, indent=1))
    log(smi)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("launches_per_step", "bound_f32_ms", "per_run", "per_pass", "per_shape",
             "design")
    log(json.dumps({"kernels": [{**{k: kd[k] for k in keys},
                                 **{k: kd[k] for k in extra if k in kd}} for kd in kernels]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

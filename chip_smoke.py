"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

Runs the port's PM-VQVAE paths at the flagship CelebA width (imputation and
stage-2 training through each of the PixelCNN chain's three kernel
granularities), the PM-VQVAE MNIST training pipeline from the command line
(stage 1, then stage 2), PM-VDVAE MNIST's three paths at the full width of
``configs/pm_vdvae_mnist.py`` (imputation, likelihood, training), then the
PM-VQVAE CelebA pipeline and the PM-VDVAE evals from their CLIs, then
PM-VAE's training and UCI eval CLIs, then VaDE's and the greedy
acquisition's CLIs, then the PM-VQVAE digits16 pipeline through the
PixelCNN kernels' 64-filter builds, then PM-VDVAE training and the image
evals over ranks, then the PM-VDVAE in bf16 (the VDVAE chains' bf16
builds) with ``flat_optimizer`` and ``remat``, then the PM-VQVAE in bf16
(the gated chain's bf16 builds), then the samplers' bf16 builds with
``PM_TPU_SAMPLER=rowkernel`` and the naive raster sampler, then the modules
ported last (``use_ema=False``, ``packed_chain``, ``steps_per_call``,
``device_resident_data``, the last mask generators), then the native host
gather, the device rescale and the snapshot callback, and checks them, in
these phases:

1. header: torch and CUDA versions, the card's name and power limit;
2. all thirteen kernels (``posterior_matching_torch/ops/csrc``; the pair
   and segment kernels share a source per direction) and the bf16 builds
   of the VDVAE chains' four are built from this checkout's sources, one
   ``nvcc`` per library, in parallel; both
   row-sampler kernels are launched at the imputation path's shapes (n = 32
   images x 10 samples, F = 128, L = 24, 16 x 16 codes, K = 512) and held
   against their plain PyTorch versions on the same inputs, each relaunched
   bit for bit; each is timed with CUDA events beside its bound, the row
   kernel also with its weight stream per busy SM and its GFLOP/s;
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
   segment's for an up and a down segment of 4 levels; each relaunched bit
   for bit and timed beside its bound, by its device time (``torch.profiler``)
   and its host's time to enqueue a call;
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
   the run directory, in a temporary tree, stays for phase 13;
12. the PM-VQVAE CelebA pipeline from its three CLIs in this process, at
   the full widths of ``configs/vqvae_celeb_a.py`` and
   ``configs/pm_vqvae_celeb_a.py``, on small synthetic CelebA files (512
   training, 64 validation and 64 test images, cropped and resized to
   64x64x3 by the data path): ``train_vqvae`` (4 steps, two validations),
   ``train_pm_vqvae`` on its run (the stream chain, 4 steps, two
   validations), then ``eval_pm_vqvae`` on that run (64 images with CelebA
   masks, 10 samples, 1 trial): the batches, run directories, each CLI's
   kernel launches exactly (every counter set to 0 just before it: the
   search 8, 2 of them the reconstruction callback's, then the search 8,
   the stream 16 + 8 and, from the imputation callback at the two
   validations, 2 x 16 of each sampler kernel, then 2 x 16 of each sampler
   kernel), the eval's files, shapes and
   ``eval_summary.json`` keys
   (the JAX CLI's), and its wall time split into requests, embeddings and
   PRD;
13. the PM-VDVAE eval CLIs on phase 11's run: ``eval_pm_vdvae_imputation``
   (64 images, 10 samples, 1 trial; 5 block-chain launches a batch) and
   ``eval_pm_vdvae_likelihood`` (125 images in one batch and chunk, 16
   importance samples; 10 launches): their files, shapes and finite BPD;
14. PM-VAE from its CLIs, at the full widths of ``configs/pm_vae_gas.py``,
   ``configs/pm_vae_bsds.py`` and ``configs/pm_vae_mnist.py`` on the
   synthetic stand-ins: ``train_pm_vae`` for 200, 50 and 20 steps (two
   validations each; finite losses that fall, steps/s over steps 3-N, the
   checkpoint reloaded through ``load_pm_vae``, one profiled step's CUDA
   kernel launches), ``eval_pm_vae_uci`` on gas's run (1024 test rows, 512
   samples, 2 trials: ``uci_results`` of shape [2]), gas's ``impute``
   keeping the observed features exactly, the MNIST model's ``impute`` and
   ``is_log_prob`` on a batch of 32 at 64 samples, and a narrow model of
   each family stepped on the GPU and on the CPU with the same weights and
   normals (the loss within 1e-5 relative, every gradient within 1e-4 of
   scale); none of the thirteen kernels is launched (every counter set to
   0 before each CLI and read after it);
15. VaDE and greedy acquisition from their CLIs, at the full widths of
   ``configs/vade_mnist.py``, ``configs/pm_vade_mnist.py``,
   ``configs/pm_vae_mnist16.py`` and ``configs/lookahead_mnist16.py`` on the
   synthetic stand-ins: ``train_vade`` (40 pretraining and 40 ELBO steps at
   batch 128; the mixture fitted on the device, grafted into the prior
   before the ELBO phase, ``val_clustering_accuracy`` at both
   validations), ``train_pm_vade`` on its run (20 steps; every VaDE tensor
   bit for bit frozen), ``train_pm_vae --config pm_vae_mnist16`` (30
   steps, with phase 14's checks), ``train_lookahead_posterior`` on that
   run (20 steps of the full 64 x 32 x 16 one-step batch; the PM-VAE bit
   for bit frozen, every ``lookahead_*`` tensor moved) and
   ``eval_greedy_acquisition`` on it (8 instances, 31 steps, 50 samples,
   chunks of 8: its trajectories, the mean RMSE curves, its wall time);
   each training CLI's steps/s over steps 3-N, launches a step and idle
   share; a narrow VaDE, PM-VaDE and lookahead model stepped on the GPU and on the CPU with the same weights and draws (the
   loss within 1e-5 relative, every gradient within 1e-4 of scale); none
   of the thirteen kernels launched (every counter set to 0 before each
   CLI and read after it);
16. resume and the run directory's logs: ``train_pm_vqvae --config
   pm_vqvae_celeb_a`` (full width, on phase 12's files and VQ-VAE run),
   ``train_pm_vdvae`` with the fused decoder (full width, on phase 11's
   files), ``train_pm_vae --config pm_vae_gas`` and ``train_vade``'s ELBO
   phase (``vade_mnist``) and ``train_vqvae --config vqvae_celeb_a``, each
   run 6 steps straight and 3 steps then ``--resume_dir`` to 6, validating
   every 3: the two final checkpoints (parameters, buffers, Adam's count
   and moments, EMA parameters) bit for bit equal, the PM-VDVAE's within
   the RESUME bounds, as its step runs cuDNN's own choice of algorithms
   (the worst difference logged where not equal); the resumed run's seed
   restored, its one validation, its TensorBoard events read back (the
   imputation strips of PM-VQVAE, PM-VDVAE's three image tags), each run's
   kernel launches (the sampler kernels at each PM-VQVAE validation, the
   chains in training) and steps/s; then the cuDNN precision check: each
   distinct convolution of the VQ-VAE and the VDVAE, its gradients on the
   card with cuDNN's own choice of algorithms and with the deterministic
   ones against float64 on the CPU;
17. PM-VQVAE digits16 at the full width of ``configs/pm_vqvae_digits16.py``
   (4x4 codes, 6 resnet levels of 64 filters, 128 codes, cond 256) through
   the kernels' 64-filter builds: phase 2's sampler comparisons at a
   request's row (32 images x 10 samples), phase 5's gated stream, pair and
   segment comparisons at a training batch (32 x 4 x 4 rows), relaunches
   and times, and phase 3's small request against the CPU; then the
   pipeline from its three CLIs on stand-in ``digits16/{train,val,test}.npz``
   files (256 / 64 / 32 uint8 images from the seed) in a temporary
   ``$PM_TPU_DATA_DIR``: ``train_vqvae --config vqvae_digits16``,
   ``train_pm_vqvae --config pm_vqvae_digits16`` on its run with
   ``chain_segment`` "stream", 1 and 4 (4 steps and one validation each,
   whose imputation strips run the sampler kernels), ``eval_pm_vqvae`` on
   the stream run (32 images, 10 samples, 1 trial): each CLI's kernel
   launches exactly (every counter set to 0 just before it), its batches,
   run directory, finite validation loss, and the eval's files;
18. ranks (``posterior_matching_torch.parallel``), each rank a process of
   this script with the launcher's environment set by hand and a time
   limit (the kernels are built by now, so no rank compiles): (a)
   ``train_pm_vdvae --config pm_vdvae_mnist`` with the fused decoder at full
   width, per-device batch 16, 3 steps, as one NCCL rank and in this
   process without a group, both asking cuDNN for its deterministic algorithms:
   their ``train_state.pkl`` bit for bit equal, their steps/s, and the ms of
   one gradient all-reduce under NCCL at one rank; then two gloo ranks on
   the one card (every rank LOCAL_RANK 0): (b) the same run at global batch
   32 with ``--dist_backend gloo``: the ranks' parameter digests equal after
   every step, one run directory, its checkpoint reloaded, each rank's
   block- and decoder-chain launches exactly; (c) one fused
   ``pm_vdvae_trainer`` step at global batch 32 with injected normals
   against one process's step on the global batch, within the CPU test's
   bounds, the ranks bit for bit equal, and the ms of a gradient
   all-reduce under gloo at two ranks; (d) ``eval_pm_vqvae`` on phase 12's
   run (64 images x 10 samples): the PSNRs bit for bit phase 12's, each
   rank's sampler launches; (e) ``eval_pm_vdvae_imputation`` (64 x 10) and
   ``eval_pm_vdvae_likelihood`` (124 instances, 16 importance samples) on
   phase 11's run: every instance finite, written once, the means within
   IN_DISTRIBUTION_SE standard errors of phase 13's;
19. ``compute_dtype`` bfloat16, ``remat`` and ``flat_optimizer``: the bf16
   builds of the block and decoder chains (``-DPM_CORE_BF16=1``) at the
   five encoder and five decoder runs of a bf16 training batch of 16, each
   against its plain bf16 version (outputs within BF16_TOL of scale, the
   bf16 saves against the plain level on the kernel's level input equal but
   for SAVE_FLIPS of them, the backward against the plain backward on the
   kernel's saves), relaunched bit for bit and timed beside its bound, the
   plain version and the float32 form's ms; then ``train_pm_vdvae
   --config.model.compute_dtype bfloat16 --config.flat_optimizer True``
   with the fused decoder (2 steps, a validation each; every kernel counter
   set to 0 before it and each read after: the bf16 builds' launches
   exactly, no float32 chain's), its ``model_config.json`` and optimizer
   layout, its ``--resume_dir`` to step 3, both VDVAE evals on its run, and
   one bf16 step of the unfused model with ``remat`` off and on (gradients
   bit for bit equal, each step's peak device memory);
20. the PM-VQVAE in bf16: the gated chain's bf16 builds at CelebA's and
   digits16's widths against their plain bf16 versions, relaunched bit for
   bit and timed beside float32; ``train_pm_vqvae --config.compute_dtype
   bfloat16`` in each chain mode on phase 12's files and run (the bf16
   builds' launches exactly, no float32 chain's), ``eval_pm_vqvae`` on it;
21. the samplers' bf16 builds (``-DPM_CORE_BF16=1``, JAX's
   ``PM_TPU_SAMPLER=rowkernel`` sampler): (a) both at CelebA's row (n 320,
   W 16, F 128, L 24, K 512) and digits16's (n 320, W 4, F 64, L 12, K
   128), image row 1 after the plain bf16 versions' row 0, against the
   plain bf16 versions with ``sampler_chain.bf16_gate_ok``, relaunched bit
   for bit, timed beside their float32 builds (in turns) and the plain
   versions; (b) a CelebA request through ``pm_vqvae_impute`` with
   ``sampler_dtype`` float32 and bfloat16 in turns, each launching only its
   builds, imgs/s of each; (c) ``eval_pm_vqvae`` on phase 12's run without
   and with ``PM_TPU_SAMPLER=rowkernel``, each launching only its builds,
   PSNR of each; (d) the naive sampler on a toy PM-VQVAE with two
   hierarchies and the (5, 5) field, and on an unconditional PixelCNN of
   that topology: the card's codes equal the CPU's with the same noise;
22. (a) ``train_vqvae --config.model.use_ema False`` (its codebook a
   parameter that moves; the search's launches), ``train_pm_vqvae`` and
   ``eval_pm_vqvae`` on it; (b) ``train_pm_vqvae`` packed (the default on
   the card) and with ``--config.packed_chain False`` from one seed: the
   stream builds only, no level packed or stacked when packed, the weights
   within PACKED_TOL, launches a step and step ms of each, a packed run
   resumed at step 2 bit for bit the straight one, again in bf16; (c)
   ``steps_per_call`` 4 against 1 on ``train_pm_vqvae`` and ``train_pm_vae
   pm_vae_gas`` bit for bit, with ``device_resident_data`` finite, steps/s;
   (d) the Omniglot and CIFAR-10 mixtures, ``batch_level`` and
   ``update_freq`` drawn on the card and held against the CPU by
   distribution (:func:`options_phase`);
23. the JAX package's last two modules (:func:`host_modules_phase`): (a)
   the native host gather (``posterior_matching_torch/native``, built with
   g++ from this checkout) against numpy's bit for bit at CelebA's (32 x
   64x64x3 uint8, fused with the rescale), MNIST's (16 x 28x28x1 uint8,
   fused) and ``pm_vae_gas``'s (512 float32 rows of 8) training batches
   out of splits of their real sizes, the median ms of a batch of each over
   200 batches; (b) ``DeviceDataset.gather`` on the card bit for bit the
   host batch of the same indices and ``float32(u8) * float32(1/255)``;
   (c) ``SnapshotCallback`` (``max_to_keep`` 2) beside ``CheckpointCallback``
   on a full-width ``pm_vqvae_celeb_a`` trainer over 3 validations: two
   whole snapshots left, ``restore_latest()`` the last ``train_state.pkl``
   array for array, the ms each blocks the training thread, the
   snapshot's MB;
24. one JSON line of per-kernel numbers (the 64-filter forms as
   ``<kernel>_f64``, their launches the digits16 pipeline's; the VDVAE and
   gated chains' bf16 forms as ``<kernel>_bf16``, their launches phases 19
   and 20's CLIs'; the samplers' bf16 forms as ``sampler_{vrow,row}_bf16``,
   their launches phase 21's bf16 request's, with ``f32_ms`` and the
   digits16 shape under ``per_shape``), the card's name and power limit,
   and the result line.

Usage: ``python3 chip_smoke.py [--seed 0] [--run_dir RUN] [--vdvae_run_dir
RUN] [--out DIR]``.
It needs one CUDA device and exits non-zero without one, and in a directory
that holds this script and nothing else of the repository.
"""
import argparse
import contextlib
import glob
import io
import json
import os
import pickle
import subprocess
import sys
import tempfile
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


@contextlib.contextmanager
def cli_env(cwd, data_dir):
    """Runs what it holds in ``cwd`` with ``$PM_TPU_DATA_DIR`` set to
    ``data_dir``; both are restored after."""
    old_cwd, old_env = os.getcwd(), os.environ.get("PM_TPU_DATA_DIR")
    os.environ["PM_TPU_DATA_DIR"] = str(data_dir)
    os.chdir(cwd)
    try:
        yield
    finally:
        os.chdir(old_cwd)
        if old_env is None:
            os.environ.pop("PM_TPU_DATA_DIR", None)
        else:
            os.environ["PM_TPU_DATA_DIR"] = old_env


def write_splits(data_dir, dataset, sizes):
    """``<data_dir>/<dataset>/<split>.npz``: the synthetic stand-in of each
    split cut to its first ``n`` examples."""
    from posterior_matching_torch.data import load_arrays

    os.makedirs(f"{data_dir}/{dataset}", exist_ok=True)
    for split, n in sizes.items():
        arrays = load_arrays(dataset, split)   # the synthetic stand-in
        np.savez(f"{data_dir}/{dataset}/{split}.npz", **{k: v[:n] for k, v in arrays.items()})


def run_cli(name, main, argv):
    """``main(argv)`` in this process, its standard output captured and
    logged: ``(exit code, lines, wall seconds)``."""
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = main(list(argv))
    wall = time.perf_counter() - t0
    lines = printed.getvalue().splitlines()
    for line in lines:
        log(f"  {name}: {line}")
    check(rc == 0, f"{name} exited with {rc}")
    return rc, lines, wall


# ---------------------------------------------------------------------------
# Phase 2: the row sampler's kernels
# ---------------------------------------------------------------------------


def sampler_phase(pcnn, cond, gen):
    """Both row-sampler kernels against their plain PyTorch versions at a
    request's image row 1 (row 0 run through the plain versions first, so
    that the previous-row state is what the sampler sees), for ``cond``'s n
    chains: the vrow kernel's outputs within VROW_TOL, the row kernel's
    samples equal on SAMPLE_AGREEMENT of the positions and its logits within
    LOGITS_TOL where every earlier sample of the chain agreed; each
    relaunched bit for bit, timed with CUDA events beside its bound (the
    plain versions run the same arithmetic as many small launches; no single
    library call computes either chain), the row kernel also with its weight
    stream per busy SM and its GFLOP/s. Returns each kernel's numbers."""
    from posterior_matching_torch.ops import sampler_chain as sc
    from posterior_matching_torch.ops.profiling import time_ms

    dev = cond.device
    n = cond.shape[0]
    f, n_res = pcnn.num_filters, pcnn.num_resnet
    n_lvl, k_idx = 2 * n_res, pcnn.num_indices
    hgt, wid = pcnn.image_shape
    with torch.no_grad():
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
        again_v = sc.vrow(*vrow_in)
        torch.cuda.synchronize()
        vrow_err = 0.0
        for name, gt, wt_, ag in zip(("outv", "outm", "v0", "hup"), got_v, want_v, again_v):
            err, rel = rel_err(gt, wt_)
            vrow_err = max(vrow_err, err)
            log(f"vrow {name}: max abs err {err:.3e}, relative to scale {rel:.3e}")
            if not rel <= VROW_TOL:
                raise AssertionError(f"vrow {name} disagrees: {rel:.3e} > {VROW_TOL}")
            check(torch.equal(gt, ag), f"vrow {name} differs from launch to launch")

        outv1, _, _, hup1 = want_v
        row_in = (*wr, outh0, outmh0, outv1, hup1, e1, g1, *wt)
        want_r = sc.row_plain(*row_in, with_logits=True)
        got_r = sc.row(*row_in, with_logits=True)
        again_r = sc.row(*row_in, with_logits=True)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got_r, again_r)),
              "row differs from launch to launch")
        same = got_r[2] == want_r[2]                      # [W, n]
        agree = same.float().mean().item()
        log(f"row samples agree on {agree:.6f} of {same.numel()} positions; both kernels "
            f"relaunched bit for bit")
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

        # times at the main path's shapes
        vrow_ms = time_ms(lambda: sc.vrow(*vrow_in), reps=10)
        vrow_plain_ms = time_ms(lambda: sc.vrow_plain(*vrow_in), reps=3)
        row_ms = time_ms(lambda: sc.row(*row_in), reps=10)
        row_plain_ms = time_ms(lambda: sc.row_plain(*row_in), reps=2)

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
    return {"vrow": {"max_abs_err": vrow_err, "ms": vrow_ms, "plain_ms": vrow_plain_ms,
                     "bound_ms": vrow_bound, "bound_by": vrow_by, "blocks": vrow_nblocks},
            "row": {"max_abs_err": row_err, "ms": row_ms, "plain_ms": row_plain_ms,
                    "bound_ms": row_bound, "bound_by": row_by, "blocks": row_blocks}}


def small_request_check(model, xs, bs, gen, cond_dim, vq_cfg, pc_cfg):
    """A small request (``xs``, ``bs``: two images, 2 samples each) through
    the kernels against the plain path on the CPU, with the same noise: the
    same codes, and imputations to 1e-4."""
    from posterior_matching_torch.models.pm_vqvae import pm_vqvae_impute
    from posterior_matching_torch.ops import sampler_chain as sc

    pcnn = model.pixel_cnn
    hgt, wid = pcnn.image_shape
    cpu_model = type(model)(cond_dim, vq_cfg, pc_cfg).eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    noise = sc.gumbel_noise((hgt, wid, 2 * 2, pcnn.num_indices), gen, xs.device)
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


def device_split(calls):
    """Device ms and device kernels a call (``torch.profiler``) and host ms
    to enqueue one, of each of ``calls`` ({kind: fn}): where a call's time
    back to back is the host's."""
    from posterior_matching_torch.ops.profiling import host_ms, profile_calls

    out = {}
    for kind, fn in calls.items():
        prof = profile_calls(fn, 5)
        out[kind] = {"device_ms": None if prof is None else prof[0],
                     "kernels_per_call": None if prof is None else prof[1],
                     "host_ms": host_ms(fn)}
    return out


def log_split(what, split):
    for kind, sp in split.items():
        dev = "not measured" if sp["device_ms"] is None else (
            f"{sp['device_ms']:.4f} ms in {sp['kernels_per_call']:.0f} kernels")
        log(f"{what.format(kind=kind)}: device {dev} a call, host {sp['host_ms']:.4f} ms to "
            f"enqueue one")


def stream_phase(model, x, b, seed):
    """Both gated chain kernels against autograd through the plain chain at
    full width, up pass then down pass, with in-kernel hash dropout; each
    wrapper call timed back to back, by its device time and by its host's
    time to enqueue it."""
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
            split = device_split({
                "fwd": lambda: gc.stream_fwd(cfg, xv0, xh0, sk, cond, w),
                "bwd": lambda: gc.stream_bwd(cfg, gv, gh, saved, w_nb)})
        bwd_plain = time_ms(lambda: torch.autograd.grad(want, leaves, cot, retain_graph=True),
                            reps=3)
        grads = gc.stream_bwd(cfg, gv, gh, saved, w_nb)
        with torch.no_grad():
            saves2 = gc.stream_fwd(cfg, xv0, xh0, sk, cond, w)
        grads2 = gc.stream_bwd(cfg, gv, gh, saved, w_nb)
        check(all(torch.equal(saves[k], saves2[k]) for k in saves)
              and all(torch.equal(grads[k], grads2[k]) for k in grads),
              f"gated_stream {direction}: a relaunch differs")
        del saves2, grads2
        fwd_bytes = nbytes(xv0, xh0, cond, *w.values(), *(sk or ()),
                           *(saves[k] for k in ("xvo", "xho", "a1v", "a1h", "b1v", "b1h")))
        bwd_bytes = nbytes(gv, gh, *saved.values(), *w_nb.values(), *grads.values())
        (ff, fb), (bf, bb) = stream_work(cfg, fwd_bytes, bwd_bytes)
        results[direction] = {
            "fwd": (fwd_err, fwd_ms, fwd_plain, ff, fb),
            "bwd": (bwd_err, bwd_ms, bwd_plain, bf, bb),
            "splits": gc.wgrad_splits("gated_stream_bwd", cfg), "split": split,
        }
        log(f"gated_stream_bwd {direction}: wgrad row splits {results[direction]['splits']}; "
            f"forward and backward relaunched bit for bit")
        log_split(f"gated_stream_{{kind}} {direction}", split)
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
                             **results[d]["split"][kind],
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
    timed beside its bound, by its device time and by its host's time to
    enqueue it."""
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
                split = device_split({
                    "fwd": lambda: fwd(cfg, xv, xh, sk, cond, ws),
                    "bwd": lambda: bwd(cfg, gs, xv, xh, cond, sk, saves, ws)})
            bwd_plain = time_ms(lambda: torch.autograd.grad(want, leaves, cot, retain_graph=True),
                                reps=3)
            head, grads = bwd(cfg, gs, xv, xh, cond, sk, saves, ws)
            with torch.no_grad():
                saves2 = fwd(cfg, xv, xh, sk, cond, ws)
            head2, grads2 = bwd(cfg, gs, xv, xh, cond, sk, saves, ws)
            flat = lambda ds: [t for d in ds for t in d.values()]
            check(all(torch.equal(a, c) for a, c in zip(flat(saves), flat(saves2)))
                  and all(torch.equal(a, c) for a, c in zip(flat([head, *grads]),
                                                             flat([head2, *grads2]))),
                  f"gated_{kind} {direction}: a relaunch differs")
            del saves2, head2, grads2
            ins = (xv, xh, cond, *(t for w in ws for t in w.values()),
                   *(t for pair in (sk or ()) for t in pair))
            fwd_bytes = nbytes(*ins, *(t for s_ in saves for t in s_.values()))
            bwd_bytes = nbytes(*(t for pair in gs for t in pair), *ins,
                               *(t for s_ in saves for t in s_.values()),
                               *head.values(), *(t for g_ in grads for t in g_.values()))
            (ff, fb), (bf, bb) = stream_work(cfg, fwd_bytes, bwd_bytes)
            results[kind][direction] = {"fwd": (fwd_err, fwd_ms, fwd_plain, ff, fb),
                                        "bwd": (bwd_err, bwd_ms, bwd_plain, bf, bb),
                                        "splits": gc.wgrad_splits("gated_levels_bwd", cfg),
                                        "split": split}
            log(f"gated_{kind}_bwd {direction}: wgrad row splits "
                f"{results[kind][direction]['splits']}; forward and backward relaunched "
                f"bit for bit")
            log_split(f"gated_{kind}_{{kind}} {direction}", split)
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
                                 **results[kind][d]["split"][k2],
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
    from posterior_matching_torch import convert, masking, train_pm_vqvae, train_vqvae
    from posterior_matching_torch.models.pm_vqvae import pm_vqvae_impute
    from posterior_matching_torch.train.state import load_train_state

    steps, n_train, n_test, batch = 4, 512, 64, 32
    n_val = n_test // batch
    counters = chain_counters()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_splits(f"{tmp}/data", "mnist", {"train": n_train, "test": n_test})
        with cli_env(tmp, f"{tmp}/data"):
            common = ["--config.steps", str(steps), "--config.validation_freq",
                      str(steps // 2), "--config.seed", str(args.seed)]
            for stage, main, extra in (
                    ("train_vqvae", train_vqvae.main, ["--config", "vqvae_mnist"]),
                    ("train_pm_vqvae", train_pm_vqvae.main,
                     ["--config", "pm_vqvae_mnist", "--chain_segment", str(SEGMENT)])):
                if stage == "train_pm_vqvae":
                    extra += ["--config.vqvae_dir", out["train_vqvae"]["run_dir"]]
                before = {k: c.launches for k, c in counters.items()}
                _, lines, wall = run_cli(stage, main, [*extra, *common])
                launched = {k: c.launches - before[k] for k, c in counters.items()}
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
            check(out["train_vqvae"]["files"] == ["model_config.json", "tb", "train_meta.json",
                                                  "train_state.pkl"],
                  "train_vqvae's run directory holds other files")
            check(out["train_pm_vqvae"]["files"] == ["config.json", "tb", "train_meta.json",
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

    def record(h, w, *, mid, k, **kw):
        runs.append((h.detach().clone(), {n: t.detach().clone() for n, t in w.items()},
                     mid, k))
        return chain(h, w, mid=mid, k=k, **kw)

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

    def record(x0, acts, macts, eps, w, *, mid, ld, k, **kw):
        runs.append((*(t.detach().clone() for t in (x0, acts, macts, eps)),
                     {n: t.detach().clone() for n, t in w.items()}, mid, ld, k))
        return chain(x0, acts, macts, eps, w, mid=mid, ld=ld, k=k, **kw)

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


def cli_phase(args, gen, mask_fn, work):
    """``train_pm_vdvae`` at full width with the fused decoder on small
    synthetic MNIST files, in this process (the kernels are built), in
    ``work``: its run directory, validation lines, decoder-chain launches
    and checkpoint. The run directory stays for phase 13."""
    from posterior_matching_torch import config, convert, train_pm_vdvae
    from posterior_matching_torch.models.vdvae import vdvae_impute
    from posterior_matching_torch.ops import decoder_chain as dc

    steps, n_train, n_test, batch = 4, 512, 64, 16
    write_splits(f"{work}/data", "mnist", {"train": n_train, "test": n_test})
    f0, b0 = dc.dec_fwd.launches, dc.dec_bwd.launches
    with cli_env(work, f"{work}/data"):
        _, lines, wall = run_cli("train_pm_vdvae", train_pm_vdvae.main, [
            "--config", "pm_vdvae_mnist", "--config.steps", str(steps),
            "--config.validation_freq", str(steps // 2), "--config.seed",
            str(args.seed), "--config.model.fused_chain=True"])
    fwd, bwd = dc.dec_fwd.launches - f0, dc.dec_bwd.launches - b0
    run_dirs = glob.glob(f"{work}/runs/pm-vdvae-mnist-*")
    check(len(run_dirs) == 1, f"train_pm_vdvae made the run directories {run_dirs}")
    files = sorted(os.listdir(run_dirs[0]))
    check(files == ["model_config.json", "tb", "train_meta.json", "train_state.pkl"],
          f"the run directory holds {files}")
    steps_lines = [ln for ln in lines if ln.startswith("[step ")]
    check(len(steps_lines) == 2 and all("val_loss=" in ln for ln in steps_lines),
          "train_pm_vdvae did not log two validations with val_loss")
    n_val = n_test // batch
    # each validation: its batches, then the reconstruction callback's one
    # forward (its imputations and samples run the decoder's blocks unfused)
    want_fwd = 5 * (steps + 2 * (n_val + 1))
    check(bwd == 5 * steps and fwd == want_fwd,
          f"train_pm_vdvae launched the decoder chain {fwd} + {bwd} times, not "
          f"{want_fwd} + {5 * steps}")
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
    return {"wall_s": wall, "lines": steps_lines, "dec_launches": [fwd, bwd],
            "run_dir": run_dirs[0]}


def vdvae_phases(args, gen, work):
    """Phases 9 to 11: the model, the kernel comparisons, the three paths,
    then training through the fused decoder and the CLI (in ``work``)."""
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
    cli = cli_phase(args, gen, mask_fn, work)
    return kernel_lines + dec_lines, {"serving": serving, "training": train,
                                      "fused_first_step": first_step,
                                      "fused_training": fused_train, "cli": cli}


# ---------------------------------------------------------------------------
# Phase 12: the PM-VQVAE CelebA pipeline from its three CLIs
# ---------------------------------------------------------------------------

# The JAX eval CLI's eval_summary.json keys (eval_pm_vqvae.py:197-217).
EVAL_SUMMARY_KEYS = {"dataset", "num_instances", "num_samples", "num_trials", "psnr_mean",
                     "psnr_std", "per_trial_psnr", "precision", "precision_std", "recall",
                     "recall_std", "embedder", "measured_at"}
IMPUTATION_FILES = ["embedder.txt", "f_scores.npy", "prd_data.npy", "psnrs.npy"]


def wall_split(lines):
    """The eval CLIs' ``Wall time:`` line as ``{part: seconds}``."""
    (line,) = [ln for ln in lines if ln.startswith("Wall time: ")]
    parts = [p.rsplit(" ", 2) for p in line[len("Wall time: "):].split(", ")]
    return {name.lower(): float(sec) for name, sec, _ in parts}


def imputation_results_check(run_dir, n, num_samples, what):
    """The files and shapes an imputation eval CLI writes."""
    res = f"{run_dir}/imputation_results"
    files = sorted(f for f in os.listdir(res) if f != "eval_summary.json")
    check(files == IMPUTATION_FILES, f"{what} wrote {files}")
    psnrs, prd = np.load(f"{res}/psnrs.npy"), np.load(f"{res}/prd_data.npy")
    f_scores = np.load(f"{res}/f_scores.npy")
    check(psnrs.shape == (1, n) and bool(np.isfinite(psnrs).all()),
          f"{what}: psnrs.npy {psnrs.shape}, not (1, {n}) finite values")
    check(prd.shape == (1, num_samples, 2, 1001) and bool(((prd >= 0) & (prd <= 1)).all()),
          f"{what}: prd_data.npy {prd.shape}, not (1, {num_samples}, 2, 1001) in [0, 1]")
    check(f_scores.shape == (1, 2), f"{what}: f_scores.npy {f_scores.shape}")
    with open(f"{res}/embedder.txt") as fp:
        check(fp.read() == "random_conv\n", f"{what}: embedder.txt is not random_conv")
    return {"psnr_mean": float(psnrs.mean()), "f_scores": f_scores[0].tolist()}


def pipeline_stage(out, stage, main, argv, expected, counters, image_shape, dataset, n_val):
    """One CLI of a pipeline in this process (in the working and data
    directories the caller set) into ``out[stage]``: every kernel counter
    set to 0 just before it and all of them checked exactly against
    ``expected`` after it, the image batches its loaders yielded (noted as
    they are yielded: ``image_shape`` float32 in [0, 1]), and for a
    training CLI its one run directory ``runs/<prefix>-<dataset>-*`` and
    its ``n_val`` validation lines. Returns the run directory (None for the
    eval)."""
    from posterior_matching_torch.data.datasets import ArrayDataset

    seen = set()
    plain_iter = ArrayDataset.__iter__

    def noting_iter(self):
        for batch in plain_iter(self):
            img = batch["image"]
            seen.add((img.shape[1:], str(img.dtype), bool(0 <= img.min() and img.max() <= 1)))
            yield batch

    for c in counters.values():
        c.launches = 0
    ArrayDataset.__iter__ = noting_iter
    try:
        _, lines, wall = run_cli(stage, main, argv)
    finally:
        ArrayDataset.__iter__ = plain_iter
    shape = "x".join(map(str, image_shape))
    check(seen == {(tuple(image_shape), "float32", True)},
          f"{stage} read the image batches {seen}, not {shape} float32 in [0, 1]")
    launched = {k: c.launches for k, c in counters.items()}
    want = {k: expected.get(k, 0) for k in counters}
    check(launched == want, f"{stage} launched {launched}, not {want}")
    out[stage] = {"wall_s": wall, "launches": launched, "lines": lines}
    if not stage.startswith("eval"):
        prefix = stage.replace("train_", "").replace("_", "-")
        run_dirs = glob.glob(f"runs/{prefix}-{dataset}-*")
        check(len(run_dirs) == 1, f"{stage} made the run directories {run_dirs}")
        out[stage]["run_dir"] = os.path.abspath(run_dirs[0])
        out[stage]["files"] = sorted(os.listdir(run_dirs[0]))
        steps_lines = [ln for ln in lines if ln.startswith("[step ")]
        check(len(steps_lines) == n_val and all("val_loss=" in ln for ln in steps_lines),
              f"{stage} did not log {n_val} validations with val_loss")
    log(f"{stage}: {wall:.1f} s; {shape} batches; launches {launched}")
    return out[stage].get("run_dir")


def celeb_a_pipeline_phase(args, work):
    """``train_vqvae --config vqvae_celeb_a``, ``train_pm_vqvae --config
    pm_vqvae_celeb_a`` (the stream chain) reading its run, then
    ``eval_pm_vqvae --dataset celeb_a`` on that run, at the configs' full
    widths on small synthetic CelebA files (512 training, 64 validation and
    64 test images), in this process in ``work``: the image batches each
    CLI read (noted as its loaders yield them), the run directories, each
    CLI's kernel launches (every counter set to 0 just before it), the
    eval's files and summary keys, and its wall time by part."""
    from posterior_matching_torch import eval_pm_vqvae, train_pm_vqvae, train_vqvae
    from posterior_matching_torch.config import CELEB_A_IMAGE_SHAPE, CONFIGS
    from posterior_matching_torch.ops import sampler_chain as sc

    steps, n_eval = 4, 2 * BATCH
    sizes = {"train": 512, "validation": 64, "test": n_eval}
    t0 = time.perf_counter()
    write_splits(f"{work}/data", "celeb_a", sizes)
    log(f"synthetic CelebA files {sizes} written in {time.perf_counter() - t0:.1f} s")
    counters = {**chain_counters(), "sampler_vrow": sc.vrow, "sampler_row": sc.row}
    stage1, stage2 = CONFIGS["vqvae_celeb_a"](), CONFIGS["pm_vqvae_celeb_a"]()
    n_val1 = sizes["validation"] // stage1["data"]["val_batch_size"]
    n_val2 = sizes["validation"] // stage2["data"]["val_batch_size"]
    n_req = n_eval // BATCH
    rows = stage2["pixel_cnn"]["image_shape"][0]
    common = ["--config.steps", str(steps), "--config.validation_freq", str(steps // 2),
              "--config.seed", str(args.seed)]
    out = {}
    with cli_env(work, f"{work}/data"):
        def run_stage(stage, main, argv, expected):
            return pipeline_stage(out, stage, main, argv, expected, counters,
                                  CELEB_A_IMAGE_SHAPE, "celeb_a", 2)

        # each validation: its batches, then the reconstruction callback's
        # one forward
        run1 = run_stage("train_vqvae", train_vqvae.main,
                         ["--config", "vqvae_celeb_a", *common],
                         {"vq_search": steps + 2 * (n_val1 + 1)})
        run2 = run_stage("train_pm_vqvae", train_pm_vqvae.main,
                         ["--config", "pm_vqvae_celeb_a", *common, "--config.vqvae_dir", run1],
                         {"vq_search": steps + 2 * n_val2,
                          "gated_stream_fwd": 2 * (steps + 2 * n_val2),
                          "gated_stream_bwd": 2 * steps,
                          # the imputation callback's strips at each validation
                          "sampler_vrow": 2 * rows, "sampler_row": 2 * rows})
        run_stage("eval_pm_vqvae", eval_pm_vqvae.main,
                  ["--run_dir", run2, "--dataset", "celeb_a", "--mask_generator",
                   "CelebAMaskGenerator", "--num_instances", str(n_eval), "--batch_size",
                   str(BATCH), "--num_samples", str(NUM_SAMPLES), "--num_trials", "1"],
                  {"sampler_vrow": n_req * rows, "sampler_row": n_req * rows})
    check(out["train_vqvae"]["files"] == ["model_config.json", "tb", "train_meta.json",
                                          "train_state.pkl"],
          "train_vqvae's run directory holds other files")
    check(out["train_pm_vqvae"]["files"] == ["config.json", "tb", "train_meta.json",
                                             "train_state.pkl", "vqvae_config.json"],
          "train_pm_vqvae's run directory holds other files")
    res = imputation_results_check(run2, n_eval, NUM_SAMPLES, "eval_pm_vqvae")
    with open(f"{run2}/imputation_results/eval_summary.json") as fp:
        summary = json.load(fp)
    check(set(summary) == EVAL_SUMMARY_KEYS,
          f"eval_summary.json holds {sorted(summary)}, not the JAX CLI's keys")
    check(summary["embedder"] == "random_conv" and summary["num_instances"] == n_eval
          and np.isfinite(summary["psnr_mean"]), "eval_summary.json's values are wrong")
    split = wall_split(out["eval_pm_vqvae"]["lines"])
    out["eval_pm_vqvae"].update(res, summary=summary, wall_split=split)
    log(f"eval_pm_vqvae: {n_eval} images x {NUM_SAMPLES} samples, 1 trial, in "
        f"{out['eval_pm_vqvae']['wall_s']:.2f} s: requests {split['requests']:.3f} s, "
        f"embeddings {split['embeddings']:.3f} s, PRD {split['prd']:.3f} s; PSNR "
        f"{summary['psnr_mean']:.3f}, precision {summary['precision']:.4f}, recall "
        f"{summary['recall']:.4f}")
    return out


# ---------------------------------------------------------------------------
# Phase 17: PM-VQVAE digits16, the kernels' 64-filter builds
# ---------------------------------------------------------------------------

# Stand-in digits16 files (16x16x1 uint8 images and labels drawn from the
# seed): datasets/prepare_local.py writes the real ones from scikit-learn's
# digits, which this checkout does not hold.
DIGITS16_SIZES = {"train": 256, "val": 64, "test": BATCH}
DIGITS16_IMAGE = (16, 16, 1)
DIGITS16_STEPS = 4
DIGITS16_MODES = ("stream", 1, SEGMENT)


def write_digits16(data_dir, seed):
    rng = np.random.RandomState(seed)
    os.makedirs(f"{data_dir}/digits16", exist_ok=True)
    for split, n in DIGITS16_SIZES.items():
        np.savez(f"{data_dir}/digits16/{split}.npz",
                 image=rng.randint(0, 256, (n, *DIGITS16_IMAGE)).astype(np.uint8),
                 label=rng.randint(0, 10, n).astype(np.int64))


def digits16_phase(args, gen, work):
    """``pm_vqvae_digits16`` at its full width (4x4 codes, 6 resnet levels of
    64 filters, 128 codes, cond 256) through the kernels' 64-filter builds.
    First the kernels, on weights from ``--seed``: both sampler kernels at a
    request's image row (32 images x 10 samples) and the six gated chain
    entry points at a training batch (32 x 4 x 4 rows, keep 0.5) against
    their plain versions, each relaunched bit for bit and timed beside its
    bound, and a small request against the plain path on the CPU. Then the
    pipeline from its three CLIs, in this process, on stand-in files in
    ``work``: ``train_vqvae --config vqvae_digits16``, ``train_pm_vqvae
    --config pm_vqvae_digits16`` on its run once in each chain mode
    (DIGITS16_STEPS steps and one validation, whose imputation strips run
    the sampler kernels), then ``eval_pm_vqvae`` on the stream run (32
    images, 10 samples, 1 trial): each CLI's kernel launches exactly (every
    counter set to 0 just before it), its batches, run directory and
    validation line, and the eval's files. Returns the kernel lines (named
    ``<kernel>_f64``, their launches those of the pipeline's runs) and the
    pipeline's record."""
    from posterior_matching_torch import (config, convert, eval_pm_vqvae, masking,
                                          train_pm_vqvae, train_vqvae)
    from posterior_matching_torch.ops import sampler_chain as sc

    t0 = time.perf_counter()
    stage1, stage2 = config.CONFIGS["vqvae_digits16"](), config.CONFIGS["pm_vqvae_digits16"]()
    vq_cfg = stage1["model"]
    pc_cfg = {**stage2["pixel_cnn"], "num_indices": vq_cfg["num_embeddings"]}
    cd = stage2["conditional_dim"]
    model = convert.pm_vqvae_from_jax(
        *convert.random_pm_vqvae_tree(cd, vq_cfg, pc_cfg, seed=args.seed), cd, vq_cfg, pc_cfg,
        device=DEVICE)
    pcnn = model.pixel_cnn
    n_res, rows = pcnn.num_resnet, pcnn.image_shape[0]
    check(pcnn.num_filters == 64 and pcnn.num_indices == 128,
          f"pm_vqvae_digits16 has {pcnn.num_filters} filters and {pcnn.num_indices} codes")
    mask_fn = masking.get_mask_generator(stage2["data"]["mask_generator"], device=DEVICE)
    batch = masking.add_mask({"image": torch.rand(BATCH, *DIGITS16_IMAGE, generator=gen,
                                                  device=DEVICE)}, gen, mask_fn)
    x, b = batch["image"], batch["mask"]
    with torch.no_grad():
        cond = model.conditional_latents(x, b)
        cond = cond[None].expand(NUM_SAMPLES, *cond.shape).reshape(NUM_SAMPLES * BATCH, -1)
    sampler = sampler_phase(pcnn, cond, gen)
    small_request_check(model, x[:2], b[:2], gen, cd, vq_cfg, pc_cfg)
    chain_lines = stream_phase(model, x, b, args.seed) + level_phase(model, x, b, args.seed)
    kernel_s = time.perf_counter() - t0
    del model

    steps, n_val = DIGITS16_STEPS, DIGITS16_SIZES["val"] // stage2["data"]["val_batch_size"]
    write_digits16(f"{work}/data", args.seed)
    counters = {**chain_counters(), "sampler_vrow": sc.vrow, "sampler_row": sc.row}
    common = ["--config.steps", str(steps), "--config.validation_freq", str(steps),
              "--config.seed", str(args.seed)]
    out = {}

    def run_stage(stage, cwd, main, argv, expected):
        os.makedirs(cwd, exist_ok=True)
        with cli_env(cwd, f"{work}/data"):
            run = pipeline_stage(out, stage, main, argv, expected, counters, DIGITS16_IMAGE,
                                 "digits16", 1)
        return run

    # train_vqvae's validation: its batches, then the reconstruction
    # callback's one forward
    run1 = run_stage("train_vqvae", f"{work}/stage1", train_vqvae.main,
                     ["--config", "vqvae_digits16", *common],
                     {"vq_search": steps + n_val + 1})
    runs = {}
    for mode in DIGITS16_MODES:
        per_step = mode_launches(mode, n_res)
        (fwd,), (bwd,) = ([k for k in per_step if k.endswith(e)] for e in ("_fwd", "_bwd"))
        expected = {"vq_search": steps + n_val, fwd: per_step[fwd] * (steps + n_val),
                    bwd: per_step[bwd] * steps,
                    # the imputation callback's strips at the validation
                    "sampler_vrow": rows, "sampler_row": rows}
        runs[str(mode)] = run_stage(
            "train_pm_vqvae", f"{work}/stage2_{mode}", train_pm_vqvae.main,
            ["--config", "pm_vqvae_digits16", *common, "--config.vqvae_dir", run1,
             "--chain_segment", str(mode)], expected)
        out[f"train_pm_vqvae_{mode}"] = out.pop("train_pm_vqvae")
    run_stage("eval_pm_vqvae", f"{work}/stage2_stream", eval_pm_vqvae.main,
              ["--run_dir", runs["stream"], "--dataset", "digits16", "--mask_generator",
               stage2["data"]["mask_generator"], "--num_instances", str(BATCH), "--batch_size",
               str(BATCH), "--num_samples", str(NUM_SAMPLES), "--num_trials", "1"],
              {"sampler_vrow": rows, "sampler_row": rows})
    res = imputation_results_check(runs["stream"], BATCH, NUM_SAMPLES, "eval_pm_vqvae digits16")
    out["eval_pm_vqvae"].update(res)
    val_losses = {mode: line_value([ln for ln in out[f"train_pm_vqvae_{mode}"]["lines"]
                                    if ln.startswith("[step ")][-1], "val_loss")
                  for mode in map(str, DIGITS16_MODES)}
    check(all(np.isfinite(v) for v in val_losses.values()),
          f"a digits16 validation loss is not finite: {val_losses}")
    seconds = time.perf_counter() - t0
    log(f"digits16: kernels {kernel_s:.1f} s, pipeline {seconds - kernel_s:.1f} s; validation "
        f"losses {val_losses}; eval PSNR {res['psnr_mean']:.3f}")

    # the lines: launches of the pipeline's runs (the vrow and row kernels:
    # the eval's)
    lines = []
    for name, line in (("sampler_vrow", sampler["vrow"]), ("sampler_row", sampler["row"])):
        src = "sampler_vrow.cu" if name == "sampler_vrow" else "sampler_row.cu"
        lines.append({"name": f"{name}_f64", "route": "cuda",
                      "source": f"posterior_matching_torch/ops/csrc/{src}",
                      "replaces": "posterior_matching_tpu/ops/sampler_chain.py:"
                                  + ("124" if name == "sampler_vrow" else "215"),
                      "launches": out["eval_pm_vqvae"]["launches"][name],
                      **{k: line[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                              "bound_by")},
                      "library_ms": None})
    run_of = {"gated_pair": "1", "gated_segment": str(SEGMENT), "gated_stream": "stream"}
    for line in chain_lines:
        kind = line["name"].rsplit("_", 1)[0]
        line["launches"] = out[f"train_pm_vqvae_{run_of[kind]}"]["launches"][line["name"]]
        line["name"] += "_f64"
        lines.append(line)
    return lines, {**out, "val_losses": val_losses, "seconds": seconds, "kernel_s": kernel_s}


# ---------------------------------------------------------------------------
# Phase 13: the PM-VDVAE eval CLIs
# ---------------------------------------------------------------------------


def vdvae_eval_phase(run_dir, work):
    """``eval_pm_vdvae_imputation`` (64 instances in batches of 32, 10
    samples, 1 trial) and ``eval_pm_vdvae_likelihood`` (125 instances in one
    batch of 125, 16 importance samples, 1 trial) on phase 11's run
    directory, on MNIST's synthetic test split cut to 125, in this process:
    their files and shapes, finite values, and the block chain's launches
    (the counters set to 0 just before each)."""
    from posterior_matching_torch import eval_pm_vdvae_imputation, eval_pm_vdvae_likelihood

    n_imp, n_ll, ll_samples = 2 * BATCH, LL_BATCH, LL_SAMPLES
    write_splits(f"{work}/eval_data", "mnist", {"test": max(n_imp, n_ll)})
    counters = kernel_counters()
    common = ["--run_dir", run_dir, "--dataset", "mnist", "--mask_generator",
              "MNISTMaskGenerator", "--num_trials", "1"]
    out = {}
    with cli_env(work, f"{work}/eval_data"):
        for stage, main, argv, fwd in (
                ("eval_pm_vdvae_imputation", eval_pm_vdvae_imputation.main,
                 [*common, "--num_instances", str(n_imp), "--batch_size", str(BATCH),
                  "--num_samples", str(NUM_SAMPLES)], 5 * (n_imp // BATCH)),
                ("eval_pm_vdvae_likelihood", eval_pm_vdvae_likelihood.main,
                 [*common, "--num_instances", str(n_ll), "--batch_size", str(n_ll),
                  "--num_samples", str(ll_samples)], 10)):
            for c in counters.values():
                c.launches = 0
            _, lines, wall = run_cli(stage, main, argv)
            launched = {k: c.launches for k, c in counters.items()}
            want = dict.fromkeys(counters, 0)
            want["block_chain_fwd"] = fwd
            check(launched == want, f"{stage} launched {launched}, not {want}")
            out[stage] = {"wall_s": wall, "launches": launched, "lines": lines}
            log(f"{stage}: {wall:.1f} s; launches {launched}")
    out["eval_pm_vdvae_imputation"].update(
        imputation_results_check(run_dir, n_imp, NUM_SAMPLES, "eval_pm_vdvae_imputation"),
        wall_split=wall_split(out["eval_pm_vdvae_imputation"]["lines"]))
    res = f"{run_dir}/likelihood_results"
    check(sorted(os.listdir(res)) == ["bpd.npy", "x_lls.npy", "xo_lls.npy"],
          f"eval_pm_vdvae_likelihood wrote {sorted(os.listdir(res))}")
    lls = {k: np.load(f"{res}/{k}.npy") for k in ("bpd", "x_lls", "xo_lls")}
    check(all(v.shape == (1, n_ll) for v in lls.values()),
          f"likelihood results have shapes {[v.shape for v in lls.values()]}")
    check(bool(np.isfinite(lls["bpd"]).all()) and bool(np.isfinite(lls["x_lls"]).all()),
          "BPD or log p(x) is not finite")
    np.testing.assert_allclose(lls["bpd"], -lls["x_lls"] / (28 * 28 * np.log(2)), rtol=1e-6)
    out["eval_pm_vdvae_likelihood"]["bpd"] = float(lls["bpd"].mean())
    log(f"PM-VDVAE eval CLIs on the run of phase 11: imputation PSNR "
        f"{out['eval_pm_vdvae_imputation']['psnr_mean']:.3f}, wall "
        f"{out['eval_pm_vdvae_imputation']['wall_split']}; likelihood BPD "
        f"{out['eval_pm_vdvae_likelihood']['bpd']:.4f} over {n_ll} images at {ll_samples} "
        f"importance samples")
    return out


# ---------------------------------------------------------------------------
# Phase 14: PM-VAE from its CLIs
# ---------------------------------------------------------------------------

# PM-VAE: the training CLI at each family's full width (gas, bsds, the
# MNIST conv model), then the UCI eval CLI on gas's run at its own sample
# count on the 1024 synthetic test rows, 2 trials (the CLI's default is 5).
# Each run: (config, steps, whether its loss must fall from the first
# validation window to the second). bsds's matching log-likelihood is NaN
# within its first 3 steps on the synthetic stand-in, in the JAX package
# too (its KL weight is 0 until step 30,000): its run is held to finite
# reconstruction log-likelihoods.
PM_VAE_RUNS = (("pm_vae_gas", 200, True), ("pm_vae_bsds", 50, False),
               ("pm_vae_mnist", 20, True))
PM_VAE_EVAL_SAMPLES, PM_VAE_EVAL_TRIALS = 512, 2
# The small GPU-vs-CPU steps: each family at narrow widths.
SMALL_PM_VAE = {
    "features": {"latent_dim": 8, "encoder_net": "ResidualMLP", "decoder_net": "ResidualMLP",
                 "decoder_dist": "IdentityGaussian", "posterior_dist": "TriLGaussian",
                 "decoder_dist_config": {"event_size": 10},
                 "encoder_net_config": {"residual_blocks": 2, "hidden_units": 32,
                                        "layer_norm": True},
                 "decoder_net_config": {"residual_blocks": 2, "hidden_units": 32,
                                        "layer_norm": True},
                 "matching_ll_stop_gradients": True},
    "image": {"latent_dim": 6, "encoder_net": "ConvEncoder", "decoder_net": "ConvDecoder",
              "posterior_dist": "TriLGaussian", "partial_posterior_dist": "AutoregressiveGMM",
              "decoder_dist": "Bernoulli",
              "encoder_net_config": {"conv_layers": [(8, 5, 1), (8, 5, 2), (16, 5, 1),
                                                     (16, 5, 2), (16, 7, 1)]},
              "decoder_net_config": {"conv_layers": [(16, 7, 1), (16, 5, 2), (8, 5, 1),
                                                     (8, 5, 2), (1, 5, 1)]}},
}


def all_kernel_counters():
    """The wrappers of all thirteen kernels, whose ``launches`` count
    them."""
    from posterior_matching_torch.ops import sampler_chain as sc

    return {"sampler_vrow": sc.vrow, "sampler_row": sc.row, **chain_counters(),
            **kernel_counters()}


@contextlib.contextmanager
def step_clock():
    """Records the trainer, its last batch and the span of each of its
    steps, from its call to its end with the device waited for, while a
    training CLI runs: ``{"trainer", "batch", "spans"}``."""
    from posterior_matching_torch.train.trainer import Trainer

    seen = {"trainer": None, "batch": None, "spans": []}
    step = Trainer.train_step

    def timed(self, batch):
        t0 = time.perf_counter()
        out = step(self, batch)
        torch.cuda.synchronize()
        seen["spans"].append(time.perf_counter() - t0)
        seen["trainer"], seen["batch"] = self, batch
        return out

    Trainer.train_step = timed
    try:
        yield seen
    finally:
        Trainer.train_step = step


def counted_cli(name, main, argv, work, counters):
    """A CLI in this process on the synthetic stand-ins, every kernel
    counter set to 0 just before it and read just after (none may have
    launched), each training step waited for and timed: ``(lines, wall,
    clock)``."""
    for c in counters.values():
        c.launches = 0
    with cli_env(work, f"{work}/no_data"), step_clock() as clock:
        _, lines, wall = run_cli(name, main, argv)
    launched = {k: c.launches for k, c in counters.items() if c.launches}
    check(not launched, f"{name} launched kernels {launched}")
    return lines, wall, clock


def step_rate(name, clock, steps, lines, finite=True):
    """Steps/s of the last ``steps`` steps: steps 3 to ``steps`` over the
    sum of their spans (the whole window but the validations between
    steps); the last two ``[step ...]`` lines, each with a ``val_loss`` and,
    with ``finite``, finite losses; and one more step profiled (its CUDA
    kernel launches and the device's idle share)."""
    spans = clock["spans"][-steps:]
    check(len(spans) == steps, f"{name} ran {len(spans)} steps")
    windows = [ln for ln in lines if ln.startswith("[step ")][-2:]
    check(len(windows) == 2 and all("val_loss=" in ln for ln in windows),
          f"{name}: validations {windows}")
    losses = [line_value(ln, "loss") for ln in windows]
    check(not finite or all(np.isfinite(losses)), f"{name}: window losses {losses}")
    steps_per_s = (steps - 2) / sum(spans[2:])
    prof = profile_step(clock["trainer"], clock["batch"], ())
    per_step = None if prof is None else prof["kernel_launches"]
    log(f"{name}: {steps} steps, {steps_per_s:.1f} steps/s over steps 3-{steps} (each step "
        f"waited for), window losses {losses}, {per_step} CUDA kernel launches a step")
    return {"steps": steps, "steps_per_s": steps_per_s, "losses": losses,
            "launches_per_step": per_step,
            "idle_share": None if prof is None else prof["idle_share"], "lines": windows}


def line_value(line, key):
    """The number after `` key=`` in a CLI's log line."""
    return float(line.split(f" {key}=")[1].split()[0])


def same_bits(a, b):
    bits = lambda v: v.detach().contiguous().cpu().view(torch.int32)   # NaN included
    return torch.equal(bits(a), bits(b))


def small_grad_check(what, build, loss_of):
    """The loss and every gradient of a narrow model on the GPU against the
    CPU, with the same weights and draws: the loss within STEP_LOSS_TOL
    relative, every gradient within GRAD_TOL of its scale (a parameter the
    loss does not reach has none on either side)."""
    out = {}
    for d in (DEVICE, "cpu"):
        m = build(d)
        names, params = zip(*m.named_parameters())
        loss = loss_of(m, d)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        out[d] = (loss.item(), {n: g.cpu() for n, g in zip(names, grads) if g is not None})
    (lg, gg), (lc, gcpu) = out[DEVICE], out["cpu"]
    check(set(gg) == set(gcpu) and gcpu, f"{what}: different parameters got gradients")
    loss_rel = abs(lg - lc) / abs(lc)
    worst = max(((n, rel_err(gg[n], gcpu[n])[1]) for n in gcpu), key=lambda t: t[1])
    log(f"{what} small step vs CPU: loss {lg:.6f} vs {lc:.6f} (relative {loss_rel:.3e}), worst "
        f"gradient relative to scale {worst[1]:.3e} ({worst[0]}) over {len(gcpu)} tensors")
    check(loss_rel <= STEP_LOSS_TOL, f"{what} small step: the loss disagrees with the CPU's")
    check(worst[1] <= GRAD_TOL, f"{what} small step: a gradient disagrees with the CPU's")
    return {"loss_rel": loss_rel, "worst_grad_rel": worst[1], "tensors": len(gcpu)}


def small_pm_vae_step_check(data_key, seed):
    """The loss and every gradient of a narrow PM-VAE of one family on the
    GPU against the CPU (:func:`small_grad_check`), with the same weights
    and injected normals."""
    from posterior_matching_torch import convert
    from posterior_matching_torch.train.trainer import pm_vae_loss_fn

    cfg = SMALL_PM_VAE[data_key]
    g = torch.Generator().manual_seed(seed + 15)
    shape = (64, 10) if data_key == "features" else (16, 28, 28, 1)
    x = torch.randn(shape, generator=g) if data_key == "features" else \
        (torch.rand(shape, generator=g) > 0.5).float()
    b = (torch.rand(shape, generator=g) > 0.5).float()
    eps = torch.randn(shape[0], cfg["latent_dim"], generator=g)
    loss_fn = pm_vae_loss_fn({"model": cfg, "beta": {"schedule": "cyclic", "low_value": 0.0,
                                                     "high_value": 1.0, "period": 10,
                                                     "delay": 2}}, data_key)
    tree = convert.init_pm_vae_tree(cfg, seed=seed + 16)
    return small_grad_check(
        f"pm-vae ({cfg['encoder_net']})", lambda d: convert.pm_vae_from_jax(tree, cfg, device=d),
        lambda m, d: loss_fn(m, {data_key: x.to(d), "mask": b.to(d)}, iter([eps]), True, 6)[0])


def pm_vae_train_cli(name, steps, falls, seed, work, counters):
    """``train_pm_vae --config name`` at full width for ``steps`` steps and
    two validations, on the synthetic stand-in, in this process
    (:func:`counted_cli`, :func:`step_rate`): its run directory, finite
    reconstruction log-likelihoods, with ``falls`` finite losses falling
    from the first window to the second, and the checkpoint reloaded
    through ``load_pm_vae`` bit for bit."""
    from posterior_matching_torch import convert, train_pm_vae

    lines, wall, clock = counted_cli(f"train_pm_vae {name}", train_pm_vae.main, [
        "--config", name, "--config.steps", str(steps), "--config.validation_freq",
        str(steps // 2), "--config.seed", str(seed)], work, counters)
    dataset = name[len("pm_vae_"):]
    run_dirs = glob.glob(f"{work}/runs/pm-vae-{dataset}-*")
    check(len(run_dirs) == 1, f"train_pm_vae {name} made the run directories {run_dirs}")
    files = sorted(os.listdir(run_dirs[0]))
    check(files == ["model_config.json", "tb", "train_meta.json", "train_state.pkl"],
          f"the run directory holds {files}")
    # before step_rate's profiled step moves the weights
    loaded = convert.load_pm_vae(run_dirs[0], device=DEVICE).state_dict()
    want = clock["trainer"].model.state_dict()
    check(set(want) == set(loaded) and all(same_bits(v, want[k]) for k, v in loaded.items()),
          f"train_pm_vae {name}: the checkpoint does not reload through load_pm_vae")
    rate = step_rate(f"train_pm_vae {name}", clock, steps, lines, finite=falls)
    losses = rate["losses"]
    recs = [line_value(ln, k) for ln in rate["lines"]
            for k in ("reconstruction_ll", "val_reconstruction_ll")]
    check(all(np.isfinite(recs)), f"train_pm_vae {name}: reconstruction_ll {recs}")
    check(not falls or losses[1] < losses[0],
          f"train_pm_vae {name}: the loss did not fall ({losses})")
    log(f"train_pm_vae {name}: 2 validations in {wall:.1f} s wall; the checkpoint reloads "
        "through load_pm_vae")
    return {"wall_s": wall, "run_dir": run_dirs[0], **rate}


def pm_vae_phase(args, work):
    """Phase 14: PM-VAE's three configurations through the training CLI,
    gas's run through the eval CLI, the conv model's imputation and
    importance sampling, and the small GPU-vs-CPU steps; no kernel is
    launched."""
    from posterior_matching_torch import convert, eval_pm_vae_uci, masking

    counters = all_kernel_counters()
    out = {"small_step": {k: small_pm_vae_step_check(k, args.seed) for k in SMALL_PM_VAE}}
    os.makedirs(f"{work}/no_data", exist_ok=True)
    for name, steps, falls in PM_VAE_RUNS:
        out[name] = pm_vae_train_cli(name, steps, falls, args.seed, work, counters)

    gas_dir = out["pm_vae_gas"]["run_dir"]
    for c in counters.values():
        c.launches = 0
    with cli_env(work, f"{work}/no_data"):
        _, lines, wall = run_cli("eval_pm_vae_uci", eval_pm_vae_uci.main, [
            "--run_dir", gas_dir, "--dataset", "gas", "--num_samples", str(PM_VAE_EVAL_SAMPLES),
            "--num_trials", str(PM_VAE_EVAL_TRIALS)])
    launched = {k: c.launches for k, c in counters.items() if c.launches}
    check(not launched, f"eval_pm_vae_uci launched kernels {launched}")
    res = {k: np.load(f"{gas_dir}/uci_results/{k}.npy") for k in ("nrmse", "ac_lls")}
    check(all(v.shape == (PM_VAE_EVAL_TRIALS,) and np.isfinite(v).all() for v in res.values()),
          f"uci_results have shapes {[v.shape for v in res.values()]} or are not finite")
    check(any(ln.startswith("NRMSE: ") for ln in lines)
          and any(ln.startswith("AC LL: ") for ln in lines), "eval_pm_vae_uci printed no result")
    out["eval_pm_vae_uci"] = {"wall_s": wall, "nrmse": res["nrmse"].tolist(),
                              "ac_lls": res["ac_lls"].tolist()}
    log(f"eval_pm_vae_uci: 1024 rows x {PM_VAE_EVAL_SAMPLES} samples x {PM_VAE_EVAL_TRIALS} "
        f"trials in {wall:.1f} s wall; NRMSE {res['nrmse'].tolist()}, AC LL "
        f"{res['ac_lls'].tolist()} (a {out['pm_vae_gas']['steps']}-step model)")

    gen = torch.Generator(device=DEVICE).manual_seed(args.seed)
    bern = masking.get_mask_generator("BernoulliMaskGenerator", DEVICE)
    with torch.no_grad():
        gas = convert.load_pm_vae(gas_dir, device=DEVICE)
        x = torch.randn(32, 8, generator=gen, device=DEVICE)
        b = bern(gen, x.shape)
        imp = gas.impute(x, b, gen, PM_VAE_EVAL_SAMPLES)
        check(imp.shape == (PM_VAE_EVAL_SAMPLES, 32, 8) and bool(torch.isfinite(imp).all())
              and torch.equal(imp[:, b != 0], (x * b)[None].expand_as(imp)[:, b != 0]),
              "gas impute did not keep the observed features exactly")

        mnist = convert.load_pm_vae(out["pm_vae_mnist"]["run_dir"], device=DEVICE)
        mask_fn = masking.get_mask_generator("MNISTMaskGenerator", DEVICE)
        req = mnist_batch(gen, DEVICE, BATCH, mask_fn)
        xm = (req["image"] > 127).float()
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imp_m = mnist.impute(xm, req["mask"], gen, 64)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ll = mnist.is_log_prob(xm, req["mask"], gen, 64)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    launched = {k: c.launches for k, c in counters.items() if c.launches}
    check(not launched, f"the conv PM-VAE's imputation launched kernels {launched}")
    observed = (req["mask"] != 0).expand_as(xm)[None].expand_as(imp_m)
    check(imp_m.shape == (64, BATCH, 28, 28, 1) and bool(torch.isfinite(imp_m).all())
          and torch.equal(imp_m[observed], xm[None].expand_as(imp_m)[observed]),
          "the conv PM-VAE's imputations are not finite or lost observed pixels")
    check(all(v.shape == (BATCH,) and bool(torch.isfinite(v).all()) for v in ll),
          "the conv PM-VAE's importance-sampled log-likelihoods are not finite")
    out["mnist_requests"] = {"impute_ms": (t1 - t0) * 1e3, "is_log_prob_ms": (t2 - t1) * 1e3,
                             "log_p_x": ll[0].mean().item(), "ac_ll": ll[1].mean().item()}
    log(f"pm_vae_mnist: impute {BATCH} x 64 samples (32 autoregressive steps) in "
        f"{(t1 - t0) * 1e3:.1f} ms, is_log_prob in {(t2 - t1) * 1e3:.1f} ms; log p(x) "
        f"{ll[0].mean().item():.2f}, log p(x_u | x_o) {ll[1].mean().item():.2f}; "
        "no kernel launched")
    return out


# ---------------------------------------------------------------------------
# Phase 15: VaDE and greedy acquisition from their CLIs
# ---------------------------------------------------------------------------

# Steps of each CLI (train_vade's for each of its phases 1 and 3), each
# validating twice; the acquisition eval's instances, samples, episode and
# chunk are the JAX CLI's defaults but for 8 instances.
VADE_STEPS, PM_VADE_STEPS, PM_VAE16_STEPS, LOOKAHEAD_STEPS = 40, 20, 30, 20
ACQ_INSTANCES, ACQ_SAMPLES, ACQ_EPISODE, ACQ_CHUNK = 8, 50, 31, 8
# The small GPU-vs-CPU steps: a narrow conv VaDE (the autoregressive GMM
# partial posterior for PM-VaDE) on 28x28 images, and a narrow PM-VAE of
# 16x16 images under the lookahead posterior.
SMALL_VADE = {"num_components": 5, "latent_dim": 4, "encoder_net": "ConvEncoder",
              "decoder_net": "ConvDecoder", "decoder_dist": "Bernoulli",
              "encoder_net_config": {"conv_layers": [(8, 5, 1), (8, 5, 2), (16, 5, 1),
                                                     (16, 5, 2), (16, 7, 1)]},
              "decoder_net_config": {"conv_layers": [(16, 7, 1), (16, 5, 2), (8, 5, 1),
                                                     (8, 5, 2), (1, 5, 1)]},
              "partial_posterior_dist": "AutoregressiveGMM",
              "partial_posterior_dist_config": {"num_components": 3, "residual_blocks": 1,
                                                "hidden_units": 32}}
SMALL_LOOKAHEAD_PM_VAE = {"latent_dim": 4, "encoder_net": "ConvEncoder",
                          "decoder_net": "ConvDecoder", "posterior_dist": "TriLGaussian",
                          "decoder_dist": "Bernoulli",
                          "encoder_net_config": {"conv_layers": [(8, 3, 1), (8, 3, 2),
                                                                 (16, 3, 2), (16, 1, 1)]},
                          "decoder_net_config": {"conv_layers": [(16, 8, 1), (16, 5, 2),
                                                                 (8, 5, 1), (1, 3, 1)]}}


def small_vade_step_checks(seed):
    """VaDE's ELBO, PM-VaDE's matching loss and the lookahead loss of narrow
    models, each on the GPU against the CPU."""
    from posterior_matching_torch import convert
    from posterior_matching_torch.train.trainer import (
        lookahead_loss_fn,
        pm_vade_loss_fn,
        vade_loss_fn,
    )

    g = torch.Generator().manual_seed(seed + 17)
    x = (torch.rand(16, 28, 28, 1, generator=g) > 0.5).float()
    b = (torch.rand(16, 28, 28, 1, generator=g) > 0.5).float()
    eps = torch.randn(16, SMALL_VADE["latent_dim"], generator=g)
    batch = lambda d: {"image": x.to(d), "mask": b.to(d)}
    out = {}
    for partial, name, loss_fn in ((False, "vade", vade_loss_fn),
                                   (True, "pm_vade", pm_vade_loss_fn)):
        tree = convert.init_vade_tree(SMALL_VADE, seed=seed + 18, partial=partial)
        out[name] = small_grad_check(
            name, lambda d: convert.vade_from_jax(tree, SMALL_VADE, device=d),
            lambda m, d: loss_fn("image")(m, batch(d), iter([eps]), True))

    cfg = {"num_features": 256, "lookahead_subsample": 16, "model_samples": 8}
    tree = convert.init_lookahead_tree(cfg, SMALL_LOOKAHEAD_PM_VAE, seed=seed + 19)
    x16 = (torch.rand(4, 16, 16, 1, generator=g) > 0.5).float()
    b16 = (torch.rand(4, 16, 16, 1, generator=g) > 0.8).float()
    lat = SMALL_LOOKAHEAD_PM_VAE["latent_dim"]
    draws = [torch.randn(8, 4, lat, generator=g), torch.randperm(256, generator=g)[:16],
             torch.randn(8 * 4 * 16, lat, generator=g)]
    out["lookahead"] = small_grad_check(
        "lookahead", lambda d: convert.lookahead_from_jax(tree, cfg, SMALL_LOOKAHEAD_PM_VAE,
                                                          device=d),
        lambda m, d: lookahead_loss_fn("image")(m, {"image": x16.to(d), "mask": b16.to(d)},
                                                iter(draws), True))
    return out


def vade_phase(args, work):
    """Phase 15: ``train_vade`` (its three phases; the mixture grafted and
    ``val_clustering_accuracy`` logged), ``train_pm_vade`` on its run (the
    VaDE frozen bit for bit), ``train_pm_vae --config pm_vae_mnist16``,
    ``train_lookahead_posterior`` on that run (only ``lookahead_*``
    moved) and ``eval_greedy_acquisition`` on it, all at the configs'
    widths on the stand-ins; the small GPU-vs-CPU steps; no kernel
    launched."""
    from posterior_matching_torch import (
        config,
        convert,
        eval_greedy_acquisition,
        train_lookahead_posterior,
        train_pm_vade,
        train_vade,
    )
    from posterior_matching_torch.train.trainer import Trainer

    counters = all_kernel_counters()
    out = {"small_step": small_vade_step_checks(args.seed)}
    os.makedirs(f"{work}/no_data", exist_ok=True)
    seed = ["--config.seed", str(args.seed)]

    # -- train_vade, its mixture and graft recorded ----------------------------
    fits, starts = [], []

    class Recorded(train_vade.GaussianMixture):
        def fit(self, x):
            fits.append(self)
            return super().fit(x)

    init = Trainer.init

    def recorded_init(self, initial_state_dict=None):
        init(self, initial_state_dict)
        starts.append({k: v.detach().clone() for k, v in self.model.state_dict().items()})

    train_vade.GaussianMixture, Trainer.init = Recorded, recorded_init
    try:
        lines, wall, clock = counted_cli("train_vade vade_mnist", train_vade.main, [
            "--config", "vade_mnist", "--config.pretrain_steps", str(VADE_STEPS),
            "--config.steps", str(VADE_STEPS), "--config.validation_freq",
            str(VADE_STEPS // 2), *seed], work, counters)
    finally:
        train_vade.GaussianMixture, Trainer.init = Recorded.__bases__[0], init
    (vade_dir,) = glob.glob(f"{work}/runs/vade-mnist-*")
    files = sorted(os.listdir(vade_dir))
    check(files == ["model_config.json", "pretrain_state.pkl", "tb", "train_meta.json",
                    "train_state.pkl"], f"the VaDE run directory holds {files}")
    gmm_lines = [ln for ln in lines if ln.startswith("GMM Accuracy: ")]
    check(len(gmm_lines) == 1, "train_vade printed no GMM accuracy")
    check(len(fits) == 1 and len(starts) == 2, "train_vade fitted no mixture")
    graft = train_vade.gmm_graft(fits[0])
    check(all(np.array_equal(starts[1][k].cpu().numpy(), v) for k, v in graft.items()),
          "phase 3 did not start from the grafted mixture")
    accs = [float(ln.split("val_clustering_accuracy=")[1].split()[0])
            for ln in lines if "val_clustering_accuracy=" in ln]
    check(len(accs) == 2, "train_vade did not log val_clustering_accuracy at each validation")
    out["train_vade"] = {"wall_s": wall, "gmm_accuracy": float(gmm_lines[0].split()[-1]),
                         "val_clustering_accuracy": accs, "gmm_n_iter": fits[0].n_iter_,
                         **step_rate("train_vade (phase 3)", clock, VADE_STEPS, lines)}
    log(f"train_vade: {wall:.1f} s wall, GMM accuracy {out['train_vade']['gmm_accuracy']} "
        f"({fits[0].n_iter_} EM iterations on the best of 10 initialisations), "
        f"val_clustering_accuracy {accs}")

    # -- train_pm_vade on it ------------------------------------------------------
    lines, wall, clock = counted_cli("train_pm_vade pm_vade_mnist", train_pm_vade.main, [
        "--config", "pm_vade_mnist", "--config.vade_dir", vade_dir, "--config.steps",
        str(PM_VADE_STEPS), "--config.validation_freq", str(PM_VADE_STEPS // 2), *seed],
        work, counters)
    (pm_vade_dir,) = glob.glob(f"{work}/runs/pm-vade-mnist-*")
    vade = convert.load_vade(vade_dir, device=DEVICE).state_dict()
    pm_vade = convert.load_vade(pm_vade_dir, device=DEVICE).state_dict()
    moved = [k for k, v in vade.items() if not same_bits(v, pm_vade[k])]
    check(not moved, f"train_pm_vade moved frozen parameters {moved[:5]}")
    check(set(pm_vade) - set(vade) == {k for k in pm_vade if k.startswith("partial_")},
          "the PM-VaDE checkpoint's parameters are not the VaDE's and partial_*")
    out["train_pm_vade"] = {"wall_s": wall, "frozen": len(vade),
                            **step_rate("train_pm_vade", clock, PM_VADE_STEPS, lines)}
    log(f"train_pm_vade: {wall:.1f} s wall; all {len(vade)} VaDE tensors bit for bit frozen")

    # -- train_pm_vae mnist16, then the lookahead posterior on it ------------------
    out["train_pm_vae_mnist16"] = pm_vae_train_cli("pm_vae_mnist16", PM_VAE16_STEPS, True,
                                                   args.seed, work, counters)
    pm_vae_dir = out["train_pm_vae_mnist16"]["run_dir"]
    lines, wall, clock = counted_cli(
        "train_lookahead_posterior lookahead_mnist16", train_lookahead_posterior.main, [
            "--config", "lookahead_mnist16", "--config.pm_vae_dir", pm_vae_dir,
            "--config.steps", str(LOOKAHEAD_STEPS), "--config.validation_freq",
            str(LOOKAHEAD_STEPS // 2), *seed], work, counters)
    (la_dir,) = glob.glob(f"{work}/runs/lookahead-mnist16-*")
    la = convert.load_lookahead(la_dir, device=DEVICE)
    pm_vae = convert.load_pm_vae(pm_vae_dir, device=DEVICE).state_dict()
    check(all(same_bits(v, la.pm_vae.state_dict()[k]) for k, v in pm_vae.items()),
          "train_lookahead_posterior moved the PM-VAE")
    la_cfg = dict(config.lookahead_mnist16()["model"], num_features=256)
    start = convert.lookahead_state_dict(convert.init_lookahead_tree(
        la_cfg, json.load(open(f"{la_dir}/pm_vae_config.json")), seed=args.seed))
    still = [k for k, v in la.state_dict().items() if k.startswith("lookahead_")
             and np.array_equal(v.cpu().numpy(), start[k])]
    check(not still, f"lookahead tensors that did not move: {still}")
    s_mod, s_sub = la.model_samples, la.lookahead_subsample
    out["train_lookahead"] = {"wall_s": wall, "one_step_rows": s_mod * 32 * s_sub, **step_rate(
        "train_lookahead_posterior", clock, LOOKAHEAD_STEPS, lines)}
    log(f"train_lookahead_posterior: {wall:.1f} s wall, {s_mod} x 32 x {s_sub} = "
        f"{s_mod * 32 * s_sub} one-step rows a step; only lookahead_* moved")

    # -- eval_greedy_acquisition on it --------------------------------------------
    lines, wall, _ = counted_cli("eval_greedy_acquisition", eval_greedy_acquisition.main, [
        "--run_dir", la_dir, "--dataset", "mnist16", "--num_instances", str(ACQ_INSTANCES),
        "--num_samples", str(ACQ_SAMPLES), "--episode_length", str(ACQ_EPISODE),
        "--chunk_size", str(ACQ_CHUNK)], work, counters)
    curves = {}
    for name in ("sampling", "lookahead"):
        with open(f"{la_dir}/trajectories/{name}_trajectories.pkl", "rb") as fp:
            trajectories = pickle.load(fp)
        check(len(trajectories) == ACQ_INSTANCES
              and all(tr["rmse"].shape == (ACQ_EPISODE,) and np.isfinite(tr["rmse"]).all()
                      and tr["mask"].shape == (ACQ_EPISODE, 16, 16, 1)
                      and tr[f"{name}_probs"].shape == (ACQ_EPISODE, 256)
                      and tr["mask"][-1].sum() == ACQ_EPISODE - 1 for tr in trajectories),
              f"the {name} trajectories have the wrong shapes or values")
        curves[name] = np.mean([tr["rmse"] for tr in trajectories], 0).tolist()
    rows = ACQ_CHUNK * ACQ_SAMPLES * 257
    out["eval_greedy_acquisition"] = {"wall_s": wall, "rmse_curves": curves,
                                      "sampling_rows_a_step": rows}
    log(f"eval_greedy_acquisition: {ACQ_INSTANCES} instances x {ACQ_EPISODE} steps x 2 "
        f"rollouts ({rows} partial-encoder rows a step for the sampling estimator) in "
        f"{wall:.1f} s wall; mean RMSE first/last step: sampling {curves['sampling'][0]:.4f} -> "
        f"{curves['sampling'][-1]:.4f}, lookahead {curves['lookahead'][0]:.4f} -> "
        f"{curves['lookahead'][-1]:.4f}; no kernel launched")
    return out


# ---------------------------------------------------------------------------
# Phase 16: resume, the run directory's logs, the cuDNN precision check
# ---------------------------------------------------------------------------

# Phase 16's runs: straight to RESUME_STEPS, and to RESUME_AT and on from
# there, validating every RESUME_AT steps.
RESUME_AT, RESUME_STEPS = 3, 6
# The PM-VDVAE's step runs cuDNN's own choice of convolution algorithms,
# whose weight-gradient sums land in another order from one call to the
# next (its deterministic ones cost the fused step 5-8%:
# tools/step_timing.py), so its resumed run is held to bounds, not bit for
# bit. Counts and the step exactly. Parameters and EMA parameters within
# RESUME_PARAM_STEPS x lr x RESUME_STEPS of each other, elementwise: Adam's
# bias-corrected update is at most 1.015 lr an element in its first 6
# steps whatever the gradients, so two runs drift apart by at most 2.03 lr
# a step, while a parameter restored wrong is off by its own scale. Adam's
# moments within RESUME_MOMENT_TOL of the tensor's scale: a moment, the
# seed or the stream restored wrong moves them by a tenth of their scale or
# more (the last 3 of 6 gradients weigh 0.27 of 0.47 in mu).
RESUME_PARAM_STEPS = 2.1
RESUME_MOMENT_TOL = 1e-2
def checkpoint_arrays(run_dir):
    """Every array of a run's ``train_state.pkl``, flat by its path (the
    optimizer's through its optax records)."""
    from posterior_matching_torch.train.state import ForeignRecord, load_train_state

    ts = load_train_state(f"{run_dir}/train_state.pkl")
    out = {"step": np.asarray(ts.step)}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}", v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}/{i}", v)
        elif isinstance(node, ForeignRecord):
            walk(f"{prefix}/{type(node).__name__}", node.args)
        else:
            out[prefix] = np.asarray(node)

    for field in ("params", "state", "opt_state", "ema_params"):
        walk(field, getattr(ts, field))
    return out


def resume_check(name, main, argv, cwd, data_dir, counters, lr=None):
    """``main`` on ``argv`` straight to RESUME_STEPS, then to RESUME_AT and
    on to RESUME_STEPS by ``--resume_dir``, each run in its own directory
    under ``cwd`` with every kernel counter set to 0 just before it and
    each training step waited for and timed: the straight and resumed
    checkpoints equal bit for bit or, given the learning rate ``lr`` of a
    step that runs cuDNN's own choice of algorithms, within the RESUME
    bounds (the worst difference logged where they are not equal), the
    resumed run's seed restored and its one validation at RESUME_STEPS.
    Returns each run's run directory, launches and steps/s, and the
    comparison."""
    common = [*argv, "--config.validation_freq", str(RESUME_AT)]
    runs = {}
    for label, extra in (
            ("straight", ["--config.steps", str(RESUME_STEPS), "--config.seed", "5"]),
            ("short", ["--config.steps", str(RESUME_AT), "--config.seed", "5"]),
            ("resumed", ["--config.steps", str(RESUME_STEPS), "--resume_dir", None])):
        if label == "resumed":
            extra[-1] = runs["short"]["run_dir"]
        os.makedirs(f"{cwd}/{label}")
        for c in counters.values():
            c.launches = 0
        with cli_env(f"{cwd}/{label}", data_dir), step_clock() as clock:
            _, lines, wall = run_cli(f"{name} ({label})", main, [*common, *extra])
        (run_dir,) = glob.glob(f"{cwd}/{label}/runs/*")
        spans = clock["spans"]
        runs[label] = {"run_dir": run_dir, "lines": lines, "wall_s": wall,
                       "launches": {k: c.launches for k, c in counters.items() if c.launches},
                       "steps": len(spans), "steps_per_s": len(spans) / sum(spans)}
    resumed = runs["resumed"]
    steps_lines = [ln for ln in resumed["lines"] if ln.startswith("[step ")]
    check(resumed["steps"] == RESUME_STEPS - RESUME_AT and len(steps_lines) == 1
          and steps_lines[0].startswith(f"[step {RESUME_STEPS}/{RESUME_STEPS}] "),
          f"{name}: the resumed run stepped {resumed['steps']} times, validated {steps_lines}")
    check(any(ln.startswith("Restored training seed 5 from ") for ln in resumed["lines"]),
          f"{name}: the resumed run did not restore the seed")
    want, got = (checkpoint_arrays(runs[k]["run_dir"]) for k in ("straight", "resumed"))
    check(set(got) == set(want) and int(want["step"]) == RESUME_STEPS,
          f"{name}: the checkpoints hold other arrays")
    differ = {k: float(np.abs(got[k].astype(np.float64) - w).max()
                       / max(float(np.abs(w).max()), 1e-30))
              for k, w in want.items() if not np.array_equal(got[k], w)}
    worst = max(differ.items(), key=lambda t: t[1], default=(None, 0.0))
    bounds = ""
    if lr is None:
        over = differ
    else:
        atol = RESUME_PARAM_STEPS * lr * RESUME_STEPS
        param = {k: float(np.abs(got[k].astype(np.float64) - want[k]).max()) for k in differ
                 if not k.startswith("opt_state/")}
        moment = {k: v for k, v in differ.items() if k.startswith("opt_state/")}
        over = {k: v for k, v in differ.items()
                if not np.issubdtype(want[k].dtype, np.floating)
                or (k in param and param[k] > atol) or moment.get(k, 0.0) > RESUME_MOMENT_TOL}
        bounds = (f"; parameters at most {max(param.values(), default=0.0):.3e} apart (bound "
                  f"{atol:.3e}), moments {max(moment.values(), default=0.0):.3e} of scale "
                  f"(bound {RESUME_MOMENT_TOL:g})")
    log(f"{name}: resumed vs straight, {len(want)} arrays: "
        + ("bit for bit equal" if not differ else
           f"{len(differ)} differ, worst {worst[1]:.3e} of scale ({worst[0]})") + bounds
        + "; steps/s " + ", ".join(f"{k} {v['steps_per_s']:.2f}" for k, v in runs.items())
        + f" | {nvidia_smi_line()}")
    check(not over, f"{name}: the resumed run is not the straight run: {len(over)} arrays "
          f"out of bounds, {sorted(over)[:3]}")
    return {"runs": {k: {kk: v for kk, v in r.items() if kk != "lines"} for k, r in runs.items()},
            "arrays": len(want), "differ": len(differ), "worst_of_scale": worst[1]}


def tests_module(name):
    """A helper module of the repo's ``tests/`` (none imports JAX), loaded
    by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parent / "tests" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def events(run_dir):
    """The summary values of a run's ``tb/`` event file, through the tests'
    reader (``tests/tb_events.py``)."""
    (path,) = glob.glob(f"{run_dir}/tb/events.out.tfevents.*")
    return tests_module("tb_events").read_events(path)


def resume_phase(args, work, celeb_a_dir, vqvae_dir, mnist_dir):
    """Phase 16: resume equal to a straight run through five CLIs at full
    width, bit for bit (the PM-VDVAE within bounds), their TensorBoard
    events and launches; then the cuDNN precision check."""
    from posterior_matching_torch import (
        train_pm_vae,
        train_pm_vdvae,
        train_pm_vqvae,
        train_vade,
        train_vqvae,
    )
    from posterior_matching_torch.config import CONFIGS

    counters = all_kernel_counters()
    out = {}
    t0 = time.perf_counter()
    # PM-VQVAE: the chain kernels relaunch bit for bit, and its trainer asks
    # for cuDNN's deterministic algorithms
    name = "train_pm_vqvae pm_vqvae_celeb_a"
    res = resume_check(name, train_pm_vqvae.main, [
        "--config", "pm_vqvae_celeb_a", "--config.vqvae_dir", vqvae_dir],
        f"{work}/pm_vqvae", celeb_a_dir, counters)
    rows = CONFIGS["pm_vqvae_celeb_a"]()["pixel_cnn"]["image_shape"][0]
    for label, validations in (("straight", 2), ("short", 1), ("resumed", 1)):
        run = res["runs"][label]
        check(run["launches"].get("sampler_vrow") == run["launches"].get("sampler_row")
              == validations * rows and run["launches"].get("gated_stream_bwd") ==
              2 * run["steps"], f"{name} ({label}) launched {run['launches']}")
    tb = events(res["runs"]["resumed"]["run_dir"])
    strips = [(step, v) for step, tag, v in tb if tag == "imputations"]
    check(strips == [(RESUME_STEPS, (64, 3 * 7 * 64))],
          f"{name}: the resumed run's events hold the imputation strips {strips}")
    out["pm_vqvae"] = res
    log(f"{name}: sampler kernels {rows} + {rows} a validation (the imputation callback), "
        f"the resumed run's events hold its imputation strips at step {RESUME_STEPS}")

    # PM-VDVAE, fused: cuDNN's own choice of algorithms, within bounds
    name = "train_pm_vdvae pm_vdvae_mnist (fused)"
    res = resume_check(name, train_pm_vdvae.main, [
        "--config", "pm_vdvae_mnist", "--config.model.fused_chain=True"],
        f"{work}/pm_vdvae", mnist_dir, counters, lr=CONFIGS["pm_vdvae_mnist"]()["lr"])
    run = res["runs"]["resumed"]
    check(run["launches"].get("decoder_chain_bwd") == 5 * run["steps"]
          and run["launches"].get("block_chain_bwd") == 10 * run["steps"],
          f"{name} (resumed) launched {run['launches']}")
    tags = sorted(tag for step, tag, v in events(run["run_dir"]) if isinstance(v, tuple))
    check(tags == ["imputations", "reconstructions", "samples"],
          f"{name}: the resumed run's events hold the images {tags}")
    out["pm_vdvae"] = res

    # stage 1 (the codebook's EMA state restored), PM-VAE gas and VaDE's
    # ELBO phase: no kernel but the search's in stage 1
    name = "train_vqvae vqvae_celeb_a"
    res = resume_check(name, train_vqvae.main, ["--config", "vqvae_celeb_a"],
                       f"{work}/vqvae", celeb_a_dir, counters)
    check(all(set(r["launches"]) == {"vq_search"} for r in res["runs"].values()),
          f"{name} launched {[r['launches'] for r in res['runs'].values()]}")
    out["vqvae"] = res
    for key, name, main, argv, data_dir in (
            ("pm_vae", "train_pm_vae pm_vae_gas", train_pm_vae.main,
             ["--config", "pm_vae_gas"], f"{work}/no_data"),
            ("vade", "train_vade vade_mnist", train_vade.main,
             ["--config", "vade_mnist", "--config.pretrain_steps", "3"], f"{work}/no_data")):
        res = resume_check(name, main, argv, f"{work}/{key}", data_dir, counters)
        check(not any(r["launches"] for r in res["runs"].values()),
              f"{name} launched kernels")
        out[key] = res
    resumed_vade = glob.glob(f"{work}/vade/resumed/runs/*")[0]
    check(not os.path.exists(f"{resumed_vade}/pretrain_state.pkl"),
          "the resumed train_vade ran its pretraining")
    seconds = time.perf_counter() - t0
    log(f"resume checks: {seconds:.1f} s | {nvidia_smi_line()}")
    out["conv_precision"] = conv_precision_check(args.seed)
    out["seconds"] = time.perf_counter() - t0
    return out


# A cuDNN convolution's gradients on the card against float64 on the CPU,
# relative to the float64 tensor's largest magnitude. Float32 sums in any
# order read up to 8.9e-6 of scale here (the VDVAE's 14x14 48 -> 48 weight
# gradient under the deterministic algorithms, NVIDIA H100); the Winograd
# and FFT algorithms that lose digits read 1.36e-3 (PM-VAE's 5x5 layers).
# The bar sits between the two, an order of magnitude from each.
CONV_PRECISION_TOL = 1e-4


def conv_precision_check(seed):
    """Each distinct cuDNN convolution of the VQ-VAE (``vqvae_celeb_a``,
    batch 32) and of the VDVAE (``pm_vdvae_mnist``'s k x k convs, batch 16),
    on the input it sees in a forward pass, with a seeded cotangent: the
    weight and input gradients (and the output) on the card in float32,
    with cuDNN's own choice of algorithms and with the deterministic ones
    the training step asks for (``det_``), against float64 on the CPU, the
    CPU's float32 beside. Returns the worst figures per model; fails above
    CONV_PRECISION_TOL."""
    import copy

    from posterior_matching_torch import config, convert, masking
    from posterior_matching_torch.models import vdvae as vdm, vqvae as vqm
    from posterior_matching_torch.train.trainer import deterministic_convolutions

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)
    vq_cfg = config.VQVAE_CELEB_A
    params, state = convert.init_vqvae_tree(vq_cfg, seed=seed)
    vq = convert.vqvae_from_jax(params, state, vq_cfg, device=DEVICE)
    vd = convert.pm_vdvae_from_jax(convert.random_pm_vdvae_tree(config.PM_VDVAE_MNIST, seed),
                                   config.PM_VDVAE_MNIST, device=DEVICE)
    mask_fn = masking.get_mask_generator("MNISTMaskGenerator", device=DEVICE)

    def capture(model, run, convs):
        seen = {}

        def hook(mod, inputs, output):
            x = inputs[0]
            key = (type(mod).__name__, tuple(next(mod.parameters()).shape), tuple(x.shape))
            seen.setdefault(key, (mod, x.detach().clone()))

        handles = [m.register_forward_hook(hook) for m in model.modules() if convs(m)]
        try:
            with torch.no_grad():
                run()
        finally:
            for h in handles:
                h.remove()
        return seen

    def grads(mod, x, cot, device, dtype):
        m = copy.deepcopy(mod).to(device=device, dtype=dtype)
        w = next(m.parameters())
        xx = x.to(device=device, dtype=dtype).requires_grad_()
        y = m(xx)
        gw, gx = torch.autograd.grad(y, (w, xx), cot.to(device=device, dtype=dtype))
        return [t.detach().double().cpu() for t in (y, gw, gx)]

    def scale_err(got, want):
        return ((got - want).abs().max() / want.abs().max()).item()

    out = {}
    vq_x = torch.rand((BATCH, *config.CELEB_A_IMAGE_SHAPE), generator=gen, device=dev)
    vd_batch = mnist_batch(gen, dev, VDVAE_TRAIN_BATCH, mask_fn)
    noise = torch.Generator(device=dev).manual_seed(seed)
    cases = {
        "vqvae_celeb_a": capture(vq, lambda: vq(vq_x, is_training=False),
                                 lambda m: isinstance(m, (vqm.Conv, vqm.ConvTranspose))),
        # the VDVAE's 1x1 convs are matrix products, not cuDNN's
        "pm_vdvae_mnist": capture(vd, lambda: vd(vd_batch["image"], vd_batch["mask"], noise),
                                  lambda m: isinstance(m, vdm.Conv) and m.k > 1),
    }
    for model_name, seen in cases.items():
        rows = []
        for (kind, wshape, xshape), (mod, x) in seen.items():
            y = mod(x)
            cot = torch.randn(y.shape, generator=gen, device=dev)
            ref = grads(mod, x, cot, "cpu", torch.float64)
            gpu = grads(mod, x, cot, DEVICE, torch.float32)
            with deterministic_convolutions():
                det = grads(mod, x, cot, DEVICE, torch.float32)
            cpu = grads(mod, x, cot, "cpu", torch.float32)
            row = {"layer": f"{kind} w{list(wshape)} x{list(xshape)}",
                   "cpu_dw": scale_err(cpu[1], ref[1])}
            for prefix, got in (("", gpu), ("det_", det)):
                row.update({f"{prefix}{k}": scale_err(t, r)
                            for k, t, r in zip(("out", "dw", "dx"), got, ref)})
            rows.append(row)
            log(f"conv precision {model_name} {row['layer']}: card vs float64 out "
                f"{row['out']:.2e}, dW {row['dw']:.2e}, dx {row['dx']:.2e}; deterministic "
                f"{row['det_out']:.2e}, {row['det_dw']:.2e}, {row['det_dx']:.2e} (CPU float32 "
                f"dW {row['cpu_dw']:.2e})")
        worst = {k: max(r[k] for r in rows) for k in rows[0] if k != "layer"}
        out[model_name] = {"layers": rows, "worst": worst}
        log(f"conv precision {model_name}: {len(rows)} distinct convolutions, worst of scale: "
            f"out {worst['out']:.3e}, dW {worst['dw']:.3e}, dx {worst['dx']:.3e}; "
            f"deterministic {worst['det_out']:.3e}, {worst['det_dw']:.3e}, "
            f"{worst['det_dx']:.3e} (CPU float32 dW {worst['cpu_dw']:.3e}); bar "
            f"{CONV_PRECISION_TOL:g} | {nvidia_smi_line()}")
    for model_name, res in out.items():
        check(max(v for k, v in res["worst"].items() if k != "cpu_dw") <= CONV_PRECISION_TOL,
              f"{model_name}: a cuDNN convolution is more than {CONV_PRECISION_TOL:g} of "
              "scale off float64")
    return out


# ---------------------------------------------------------------------------
# Phase 18: ranks, the data parallelism of posterior_matching_torch.parallel
# ---------------------------------------------------------------------------

# Each rank is a process of this script (``--rank_mode``) with the
# launcher's environment set by hand; every rank of the one card is
# LOCAL_RANK 0 (gloo takes two ranks on one GPU, NCCL refuses them).
RANK_TIMEOUT = 300          # seconds a rank process may take
RANKS_STEPS, RANKS_BATCH = 3, 16       # train_pm_vdvae's steps, per-device batch
RANKS_SPLITS = {"train": 128, "test": 64}
ALL_REDUCE_REPS = 20
# (c): the two-rank step against one process within the CPU test's bounds
# (tests/test_torch_parallel.py, ``torch_parallel_worker.params_close``):
# loss 1e-5 relative, Adam's moments 1e-4 of scale (the gradient bar,
# GRAD_TOL); each parameter (and its EMA) within 5% of the learning rate,
# or, where its gradient is within that bar of zero (its sign not
# determined at that precision: Adam moves it by up to the rate either
# way), within twice the rate.
RANKS_LOSS_TOL, RANKS_MOMENT_TOL, RANKS_PARAM_STEP_SHARE = 1e-5, GRAD_TOL, 0.05
# (e): the VDVAE evals' ranks draw their own normals (and, past the first
# batch, other masks), so they equal phase 13's one-process results only in
# distribution: the two means of the per-instance values must agree within
# this many standard errors of their difference.
IN_DISTRIBUTION_SE = 4.0
LL_RANK_BATCH = 62          # (e)'s likelihood: 62 instances a rank, 124 in all


def spawn_ranks(mode, spec_path, world):
    """``world`` ranks of one group, each a process of this script in
    ``mode`` with RANK_TIMEOUT seconds; their output logged, each killed at
    its limit; raises unless every one exits 0. Returns their standard
    outputs."""
    port, procs = tests_module("torch_parallel_worker").free_port(), []
    for r in range(world):
        rank_env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK="0",
                        MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rank_mode", mode, "--rank_spec",
             str(spec_path)], env=rank_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs, failed = [], []
    for r, proc in enumerate(procs):
        try:
            out, _ = proc.communicate(timeout=RANK_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = proc.communicate()
            out += f"\n[killed after {RANK_TIMEOUT} s]"
        for line in out.splitlines():
            log(f"  rank {r}/{world}: {line}")
        if proc.returncode != 0:
            failed.append(f"rank {r} exited with {proc.returncode}")
        outs.append(out)
    check(not failed, f"{mode}: {failed}")
    return outs


def params_digest(model) -> str:
    import hashlib

    h = hashlib.sha256()
    for _, p in sorted(model.named_parameters()):
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def time_all_reduce(model):
    """One gradient all-reduce of the step (every parameter's size and the
    5 logged scalars, one flat buffer) over the process group, mean over
    ALL_REDUCE_REPS after 3 warm-ups: ``all_reduce_mean`` whole by CUDA
    events and by the host's clock, and its collective alone
    (``dist.all_reduce`` of the flat buffer) by CUDA events."""
    from posterior_matching_torch.parallel import mesh

    grads = [torch.randn_like(p) for p in model.parameters()]
    grads += [torch.ones((), device=DEVICE) for _ in range(5)]
    flat = torch.cat([g.reshape(-1) for g in grads])
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    whole, host, collective = [], [], []
    for i in range(3 + ALL_REDUCE_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        events[0].record()
        mesh.all_reduce_mean(grads)
        events[1].record()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        events[2].record()
        mesh.dist.all_reduce(flat)
        events[3].record()
        torch.cuda.synchronize()
        if i >= 3:
            whole.append(events[0].elapsed_time(events[1]))
            host.append((t1 - t0) * 1e3)
            collective.append(events[2].elapsed_time(events[3]))
    return {"floats": flat.numel(), "event_ms": float(np.mean(whole)),
            "host_ms": float(np.mean(host)), "collective_ms": float(np.mean(collective)),
            "backend": mesh.dist.get_backend(), "world": mesh.world_size()}


@contextlib.contextmanager
def recorded_steps():
    """Each ``Trainer.train_step`` waited for: its span and, after it, the
    parameters' digest."""
    from posterior_matching_torch.train.trainer import Trainer

    seen = {"spans": [], "digests": []}
    step = Trainer.train_step

    def recorded(self, batch):
        t0 = time.perf_counter()
        out = step(self, batch)
        torch.cuda.synchronize()
        seen["spans"].append(time.perf_counter() - t0)
        seen["digests"].append(params_digest(self.model))
        return out

    Trainer.train_step = recorded
    try:
        yield seen
    finally:
        Trainer.train_step = step


def rank_train_cli(spec, backend=None):
    """``train_pm_vdvae`` in this process as the spec says, cuDNN's
    deterministic algorithms asked for where ``spec["deterministic"]``,
    the VDVAE kernels counted: its lines, launches, step spans and
    digests."""
    from posterior_matching_torch import train_pm_vdvae

    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    argv = list(spec["argv"]) + (["--dist_backend", backend] if backend else [])
    kept = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = spec["deterministic"]
    try:
        with cli_env(spec["cwd"], spec["data"]), recorded_steps() as seen:
            _, lines, wall = run_cli("train_pm_vdvae", train_pm_vdvae.main, argv)
    finally:
        torch.backends.cudnn.deterministic = kept
    return {"lines": lines, "wall_s": wall, "spans": seen["spans"], "digests": seen["digests"],
            "launches": {k: c.launches for k, c in counters.items()}}


def rank_main(mode, spec_path) -> int:
    """A rank of phase 18 (``mode`` "cli" or "ranks"); writes what it saw
    to ``<spec dir>/<mode>.<rank>.json``."""
    from posterior_matching_torch import (
        convert,
        eval_pm_vdvae_imputation,
        eval_pm_vdvae_likelihood,
        eval_pm_vqvae,
    )
    from posterior_matching_torch.ops import sampler_chain as sc
    from posterior_matching_torch.parallel import mesh

    worker = tests_module("torch_parallel_worker")
    with open(spec_path) as fp:
        spec = json.load(fp)
    rank = int(os.environ.get("RANK", "0"))
    out = {}
    if mode == "cli":
        # (a): one rank over NCCL
        out["cli"] = rank_train_cli(spec["a"])
        os.environ["MASTER_PORT"] = str(spec["port2"])
        check(mesh.maybe_initialize_distributed(), "no process group for the timing")
        out["all_reduce"] = time_all_reduce(convert.pm_vdvae_from_jax(
            convert.random_pm_vdvae_tree(spec["model"], seed=0), spec["model"], device=DEVICE))
        mesh.dist.destroy_process_group()
    else:
        # (b): two ranks over gloo, the group started by the CLI's flag
        out["cli"] = rank_train_cli(spec["b"], backend="gloo")
        check(not mesh.distributed(), "train_pm_vdvae left its process group up")
        os.environ["MASTER_PORT"] = str(spec["port2"])
        check(mesh.maybe_initialize_distributed(backend="gloo"), "no gloo group")
        # (c): one fused step at the Trainer, normals injected
        with open(spec["c"]["inputs"], "rb") as fp:
            inputs = pickle.load(fp)
        trainer = worker.vdvae_trainer(inputs, device=DEVICE)
        out["c_metrics"] = {k: v.item() for k, v in trainer.train_step(inputs["batch"]).items()}
        with open(f"{spec['dir']}/c.{rank}.pkl", "wb") as fp:
            pickle.dump(worker.trainer_state(trainer), fp)
        out["all_reduce"] = time_all_reduce(trainer.model)
        del trainer
        # (d) and (e): the eval CLIs, every kernel counter set to 0 before each
        counters = {**kernel_counters(), "sampler_vrow": sc.vrow, "sampler_row": sc.row}
        for stage, main, key in (("eval_pm_vqvae", eval_pm_vqvae.main, "d"),
                                 ("eval_pm_vdvae_imputation", eval_pm_vdvae_imputation.main, "e1"),
                                 ("eval_pm_vdvae_likelihood", eval_pm_vdvae_likelihood.main,
                                  "e2")):
            for c in counters.values():
                c.launches = 0
            with cli_env(spec[key]["cwd"], spec[key]["data"]):
                _, lines, wall = run_cli(stage, main, spec[key]["argv"])
            out[stage] = {"lines": lines, "wall_s": wall,
                          "launches": {k: c.launches for k, c in counters.items()}}
        mesh.dist.destroy_process_group()
    with open(f"{spec['dir']}/{mode}.{rank}.json", "w") as fp:
        json.dump(out, fp)
    return 0


def ranks_phase(args, work, celeb_a, vdvae_run, vdvae_data, celeb_data):
    """Phase 18 in ``work`` (see the module's docstring): (a) one NCCL rank
    against one process, (b)-(e) two gloo ranks on the one card; the
    kernels are built (phase 2), so no rank compiles."""
    from posterior_matching_torch import config, convert, masking

    worker = tests_module("torch_parallel_worker")
    t_phase = time.perf_counter()
    os.makedirs(f"{work}/a_one")
    os.makedirs(f"{work}/a_nccl")
    os.makedirs(f"{work}/b")
    write_splits(f"{work}/data", "mnist", RANKS_SPLITS)
    cfg = dict(config.PM_VDVAE_MNIST, fused_chain=True)
    train_argv = ["--config", "pm_vdvae_mnist", "--config.model.fused_chain=True",
                  "--config.steps", str(RANKS_STEPS), "--config.validation_freq",
                  str(RANKS_STEPS), "--config.seed", str(args.seed),
                  f"--config.data.train_batch_size={RANKS_BATCH}",
                  f"--config.data.val_batch_size={RANKS_BATCH}"]

    def write_spec(name, spec):
        path = f"{work}/{name}.json"
        with open(path, "w") as fp:
            json.dump({"dir": work, "port2": worker.free_port(), "model": cfg, **spec}, fp)
        return path

    def read(mode, world):
        outs = []
        for r in range(world):
            with open(f"{work}/{mode}.{r}.json") as fp:
                outs.append(json.load(fp))
        return outs

    def run_dir(cwd):
        dirs = glob.glob(f"{cwd}/runs/pm-vdvae-mnist-*")
        check(len(dirs) == 1, f"{cwd} holds the run directories {dirs}")
        return dirs[0]

    def steps_per_s(spans):
        return (len(spans) - 1) / sum(spans[1:])   # the first step's warm-up left out

    # ---- (a) one rank over NCCL against one process -------------------------
    stamp("phase 18 (a): train_pm_vdvae, one NCCL rank against one process")
    a_spec = {name: {"cwd": f"{work}/a_{name}", "data": f"{work}/data", "argv": train_argv,
                     "deterministic": True} for name in ("one", "nccl")}
    a = {"one": {"cli": rank_train_cli(a_spec["one"])}}   # in this process, no group
    spawn_ranks("cli", write_spec("a_nccl", {"a": a_spec["nccl"]}), 1)
    a["nccl"] = read("cli", 1)[0]
    for name in a:
        a[name]["run_dir"] = run_dir(f"{work}/a_{name}")
        a[name]["steps_per_s"] = steps_per_s(a[name]["cli"]["spans"])
    one, nccl = (checkpoint_arrays(a[k]["run_dir"]) for k in ("one", "nccl"))
    check(sorted(one) == sorted(nccl) and int(one["step"]) == RANKS_STEPS,
          "(a): the checkpoints hold other arrays")
    differ = [k for k in one if not np.array_equal(one[k], nccl[k])]
    check(not differ, f"(a): the NCCL rank's train_state.pkl differs from one process's at "
                      f"{differ[:5]} ({len(differ)} arrays)")
    check(a["one"]["cli"]["launches"] == a["nccl"]["cli"]["launches"],
          f"(a): launches {a['one']['cli']['launches']} vs {a['nccl']['cli']['launches']}")
    reduce_nccl = a["nccl"]["all_reduce"]
    log(f"(a) train_pm_vdvae fused, batch {RANKS_BATCH}, {RANKS_STEPS} steps, cuDNN "
        f"deterministic: train_state.pkl bit for bit equal ({len(one)} arrays); steps/s over "
        f"steps 2-{RANKS_STEPS}: one process {a['one']['steps_per_s']:.3f}, one NCCL rank "
        f"{a['nccl']['steps_per_s']:.3f}; a gradient all-reduce ({reduce_nccl['floats']} "
        f"floats) under NCCL at W = 1: {reduce_nccl['event_ms']:.3f} ms (CUDA events), "
        f"{reduce_nccl['host_ms']:.3f} ms (host)")

    # ---- (c)'s inputs and its one-process step --------------------------------
    gen = torch.Generator(device=DEVICE).manual_seed(args.seed + 18)
    tree = convert.random_pm_vdvae_tree(cfg, seed=args.seed)
    mask_fn = masking.get_mask_generator("MNISTMaskGenerator", device=DEVICE)
    batch = mnist_batch(gen, DEVICE, 2 * RANKS_BATCH, mask_fn)
    with torch.no_grad():
        shapes = worker.normals_shapes(convert.pm_vdvae_from_jax(tree, cfg, device=DEVICE), batch)
    check(all(sh[0] == 2 * RANKS_BATCH for sh in shapes), f"normals of shapes {shapes}")
    normals = [torch.randn(sh, generator=gen, device=DEVICE).cpu().numpy() for sh in shapes]
    c_inputs = {"vdvae_tree": tree, "vdvae_config": cfg, "vdvae_train": {},
                "vdvae_normals": [normals], "batch": {k: v.cpu() for k, v in batch.items()}}
    with open(f"{work}/c_inputs.pkl", "wb") as fp:
        pickle.dump(c_inputs, fp)
    ref = worker.vdvae_trainer(c_inputs, device=DEVICE)
    ref_metrics = {k: v.item() for k, v in ref.train_step(c_inputs["batch"]).items()}
    want = worker.trainer_state(ref)
    del ref

    # ---- (d) and (e): run directories of links to phases 12 and 11 ------------
    def linked(src, dst, files):
        os.makedirs(dst)
        for f in files:
            os.symlink(f"{src}/{f}", f"{dst}/{f}")
        return dst

    d_run = linked(celeb_a["train_pm_vqvae"]["run_dir"], f"{work}/d_run",
                   ("train_state.pkl", "config.json", "vqvae_config.json"))
    e_run = linked(vdvae_run, f"{work}/e_run", ("train_state.pkl", "model_config.json"))
    n_eval = n_imp = 2 * BATCH
    spec = {
        "b": {"cwd": f"{work}/b", "data": f"{work}/data", "argv": train_argv,
              "deterministic": False},
        "c": {"inputs": f"{work}/c_inputs.pkl"},
        "d": {"cwd": work, "data": celeb_data, "argv": [
            "--run_dir", d_run, "--dataset", "celeb_a", "--mask_generator",
            "CelebAMaskGenerator", "--num_instances", str(n_eval), "--batch_size", str(BATCH),
            "--num_samples", str(NUM_SAMPLES), "--num_trials", "1"]},
        "e1": {"cwd": work, "data": vdvae_data, "argv": [
            "--run_dir", e_run, "--dataset", "mnist", "--mask_generator",
            "MNISTMaskGenerator", "--num_instances", str(n_imp), "--batch_size", str(BATCH),
            "--num_samples", str(NUM_SAMPLES), "--num_trials", "1"]},
        "e2": {"cwd": work, "data": vdvae_data, "argv": [
            "--run_dir", e_run, "--dataset", "mnist", "--mask_generator",
            "MNISTMaskGenerator", "--num_instances", str(2 * LL_RANK_BATCH), "--batch_size",
            str(LL_RANK_BATCH), "--batch_chunk", str(LL_RANK_BATCH), "--num_samples",
            str(LL_SAMPLES), "--num_trials", "1"]},
    }

    # ---- (b)-(e): two gloo ranks on the one card -----------------------------
    stamp("phase 18 (b)-(e): two gloo ranks on the one card")
    t0 = time.perf_counter()
    spawn_ranks("ranks", write_spec("ranks", spec), 2)
    ranks_s = time.perf_counter() - t0
    ranks = read("ranks", 2)

    # (b)
    b_run = run_dir(f"{work}/b")
    check(sorted(os.listdir(b_run)) == ["model_config.json", "tb", "train_meta.json",
                                        "train_state.pkl"],
          f"(b): the run directory holds {sorted(os.listdir(b_run))}")
    digests = [r["cli"]["digests"] for r in ranks]
    check(len(digests[0]) == RANKS_STEPS and digests[0] == digests[1],
          f"(b): the ranks' parameter digests after each step {digests}")
    steps_lines = [ln for ln in ranks[0]["cli"]["lines"] if ln.startswith("[step ")]
    check(len(steps_lines) == 1 and "val_loss=" in steps_lines[0]
          and np.isfinite(line_value(steps_lines[0], "loss")), f"(b): rank 0 logged {steps_lines}")
    check(not ranks[1]["cli"]["lines"], f"(b): rank 1 printed {ranks[1]['cli']['lines'][:3]}")
    from posterior_matching_torch.train.state import load_train_state

    reloaded = convert.pm_vdvae_from_jax(load_train_state(f"{b_run}/train_state.pkl").params,
                                         cfg, device=DEVICE)
    check(params_digest(reloaded) == digests[0][-1], "(b): the checkpoint's parameters are not "
                                                     "the ranks' last ones")
    del reloaded
    n_val = RANKS_SPLITS["test"] // (2 * RANKS_BATCH)
    for r, out in enumerate(ranks):
        callback = r == 0   # the reconstruction callback runs on rank 0 alone
        want_launches = {
            "block_chain_fwd": 10 * (RANKS_STEPS + n_val) + 15 * callback,
            "block_chain_bwd": 10 * RANKS_STEPS,
            "decoder_chain_fwd": 5 * (RANKS_STEPS + n_val) + 5 * callback,
            "decoder_chain_bwd": 5 * RANKS_STEPS}
        check(out["cli"]["launches"] == want_launches,
              f"(b): rank {r} launched {out['cli']['launches']}, not {want_launches}")

    # (c)
    lr = config.PM_VDVAE_MNIST_TRAIN["lr"]
    got = []
    for r in range(2):
        with open(f"{work}/c.{r}.pkl", "rb") as fp:
            got.append(pickle.load(fp))
    worst = {"loss": 0.0, "moments": 0.0, "params_of_lr": 0.0}
    for key in ("params", "ema", "mu", "nu"):
        for name, w in want[key].items():
            a0 = got[0][key][name]
            check(np.array_equal(a0, got[1][key][name]), f"(c): the ranks differ at {key} {name}")
            if key in ("mu", "nu"):
                worst["moments"] = max(worst["moments"], float(
                    np.abs(a0 - w).max() / max(np.abs(w).max(), 1e-12)))
            else:
                worst["params_of_lr"] = max(worst["params_of_lr"],
                                            float(np.abs(a0 - w).max() / lr))
    for out in ranks:
        worst["loss"] = max(worst["loss"], abs(out["c_metrics"]["loss"] - ref_metrics["loss"])
                            / abs(ref_metrics["loss"]))
        check(out["c_metrics"]["skipped"] == ref_metrics["skipped"] == 0.0, "(c): skipped")
    check(worst["loss"] <= RANKS_LOSS_TOL and worst["moments"] <= RANKS_MOMENT_TOL,
          f"(c): the two-rank step against one process: {worst}")
    worker.params_close(got[0], want, lr, 1, RANKS_MOMENT_TOL, RANKS_PARAM_STEP_SHARE)
    reduce_gloo = ranks[0]["all_reduce"]

    # (d)
    d_res, ref_res = f"{d_run}/imputation_results", f"{celeb_a['train_pm_vqvae']['run_dir']}" \
                                                     "/imputation_results"
    check(sorted(os.listdir(d_res)) == sorted(os.listdir(ref_res)),
          f"(d): eval_pm_vqvae wrote {sorted(os.listdir(d_res))}")
    psnr2, psnr1 = np.load(f"{d_res}/psnrs.npy"), np.load(f"{ref_res}/psnrs.npy")
    check(psnr2.shape == psnr1.shape == (1, n_eval) and same_bits(
        torch.from_numpy(psnr2), torch.from_numpy(psnr1)),
        f"(d): two ranks' PSNRs differ from one process's: worst "
        f"{float(np.abs(psnr2 - psnr1).max()) if psnr2.shape == psnr1.shape else psnr2.shape}")
    rows = config.PM_VQVAE_CELEB_A["pixel_cnn"]["image_shape"][0]
    for r, out in enumerate(ranks):
        launched = {k: v for k, v in out["eval_pm_vqvae"]["launches"].items() if v}
        want_d = {"sampler_vrow": n_eval // BATCH * rows, "sampler_row": n_eval // BATCH * rows}
        check(launched == want_d, f"(d): rank {r} launched {launched}, not {want_d}")
    check(any(ln.startswith("Wall time: ") for ln in ranks[0]["eval_pm_vqvae"]["lines"])
          and not ranks[1]["eval_pm_vqvae"]["lines"], "(d): rank 1 printed, or rank 0 did not")

    # (e)
    def in_distribution(what, two, one):
        two, one = two[np.isfinite(two)], one[np.isfinite(one)]
        se = float(np.sqrt(two.var(ddof=1) / two.size + one.var(ddof=1) / one.size))
        gap = abs(float(two.mean() - one.mean()))
        check(gap <= IN_DISTRIBUTION_SE * se,
              f"(e): {what}: two ranks' mean {two.mean():.4f} against one process's "
              f"{one.mean():.4f}, {gap / se:.2f} standard errors apart")
        return {"two_ranks": float(two.mean()), "one_process": float(one.mean()),
                "standard_errors": gap / se}

    imp2 = np.load(f"{e_run}/imputation_results/psnrs.npy")
    check(imp2.shape == (1, n_imp) and bool(np.isfinite(imp2).all()),
          f"(e): eval_pm_vdvae_imputation wrote psnrs {imp2.shape}")
    e_imp = in_distribution("PSNR", imp2, np.load(f"{vdvae_run}/imputation_results/psnrs.npy"))
    ll2 = {k: np.load(f"{e_run}/likelihood_results/{k}.npy") for k in ("bpd", "x_lls", "xo_lls")}
    check(all(v.shape == (1, 2 * LL_RANK_BATCH) and bool(np.isfinite(v).all())
              for v in ll2.values()),
          f"(e): eval_pm_vdvae_likelihood wrote {[v.shape for v in ll2.values()]}")
    e_ll = in_distribution("BPD", ll2["bpd"],
                           np.load(f"{vdvae_run}/likelihood_results/bpd.npy"))
    for r, out in enumerate(ranks):
        for stage, fwd in (("eval_pm_vdvae_imputation", 5 * n_imp // BATCH),
                           ("eval_pm_vdvae_likelihood", 10)):
            launched = {k: v for k, v in out[stage]["launches"].items() if v}
            check(launched == {"block_chain_fwd": fwd},
                  f"(e): rank {r}'s {stage} launched {launched}")
            check(r == 0 or not out[stage]["lines"], f"(e): rank {r}'s {stage} printed")
    seconds = time.perf_counter() - t_phase
    b_steps = steps_per_s(ranks[0]["cli"]["spans"])
    log(f"(b) two gloo ranks on one card, global batch {2 * RANKS_BATCH}: parameter digests "
        f"equal after each of {RANKS_STEPS} steps, one run directory, checkpoint reloaded, "
        f"launches {ranks[0]['cli']['launches']} (rank 0) / {ranks[1]['cli']['launches']} "
        f"(rank 1); {b_steps:.3f} steps/s (two ranks sharing one card: not a multi-GPU rate); "
        f"a gradient all-reduce under gloo at W = 2: {reduce_gloo['event_ms']:.3f} ms (CUDA "
        f"events), {reduce_gloo['host_ms']:.3f} ms (host)")
    log(f"(c) a fused step at two ranks against one process on the global batch: {worst}")
    log(f"(d) eval_pm_vqvae at two ranks: {n_eval} PSNRs bit for bit phase 12's")
    log(f"(e) at two ranks: imputation PSNR {e_imp}, likelihood BPD {e_ll}")
    log(f"phase 18: {seconds:.1f} s (the two gloo ranks {ranks_s:.1f} s)")
    return {"seconds": seconds, "a": {k: {"steps_per_s": v["steps_per_s"],
                                          "spans": v["cli"]["spans"],
                                          "launches": v["cli"]["launches"]}
                                      for k, v in a.items()},
            "all_reduce": {"nccl_w1": reduce_nccl, "gloo_w2": reduce_gloo},
            "b": {"steps_per_s": b_steps, "digests": digests,
                  "launches": [r["cli"]["launches"] for r in ranks]},
            "c": worst, "d": {"psnr_mean": float(psnr2.mean())},
            "e": {"imputation_psnr": e_imp, "likelihood_bpd": e_ll}}


# ---------------------------------------------------------------------------
# Phase 19: compute_dtype bfloat16, remat and flat_optimizer
# ---------------------------------------------------------------------------

# Dense bf16 products on the H100 SXM's tensor cores (NVIDIA data sheet).
PEAK_BF16_FLOPS = 989e12
# The bf16 builds against their plain versions. Both round the same float32
# values to bf16; a value within their float32 sums' difference (~1e-6) of
# a bf16 boundary rounds the other way (one ulp, 2^-8 of it), which moves
# the outputs of the products it enters by up to ~1e-3 of their scale, and
# later levels carry that on. So each tensor within BF16_TOL of its scale
# (max and mean logged, and the bf16 plain version's distance from the
# float32 one beside); the bf16 saves, against the plain forward of the
# same level on the kernel's level input, equal but for at most SAVE_FLIPS
# of them, where a level run in float32 would change a third of them
# (tests/test_torch_vdvae_bf16.py::test_saves_tell_bf16_from_float32): the
# check that the products ran in bf16; the backward kernel against the
# plain backward on the kernel's own saves; a relaunch bit for bit.
BF16_TOL, SAVE_FLIPS = 5e-3, 0.05
BF16_STEPS, BF16_VAL_FREQ, BF16_RESUME_STEPS = 2, 1, 3


def bf16_flops(kind, b, h, w, c, mid, k, n_lvl, ld=None):
    """A run's forward operations split (bf16, float32): c1..c3 of its
    Blocks in bf16, every c4 (and the decoder's z projection) in float32."""
    from posterior_matching_torch.distributions import tril_size
    from posterior_matching_torch.ops import block_chain as bc

    rows, taps = b * h * w, b * bc.tap_pixels(h, w, k)
    if kind == "block":
        return (2.0 * n_lvl * (rows * c * mid + 2 * taps * mid * mid),
                2.0 * n_lvl * rows * mid * c)
    mw = ld + tril_size(ld)
    return (2.0 * n_lvl * (6 * rows * c * mid + 8 * taps * mid * mid),
            2.0 * n_lvl * rows * (mid * (2 * ld + mw + 2 * ld + c + c) + ld * c))


def bound_bf16(flops16, flops32, byts):
    """The least time (ms) for a bf16 build's work on this card: its bf16
    products at the dense bf16 rate plus its float32 products as their core
    runs them (TF32_PASSES TF32 products each), against the bytes at the
    memory rate; and what sets it."""
    t_op = (flops16 / PEAK_BF16_FLOPS + TF32_PASSES * flops32 / PEAK_TF32_FLOPS) * 1e3
    t_by = byts / PEAK_BYTES * 1e3
    return max(t_op, t_by), ("operations" if t_op >= t_by else "bytes")


def bf16_err(got, want):
    """(max abs error, max and mean error relative to ``want``'s scale)."""
    err = (got.float() - want.float().reshape(got.shape)).abs()
    scale = max(1.0, want.abs().max().item())
    return err.max().item(), err.max().item() / scale, err.mean().item() / scale


def bf16_check(got, want, what):
    """:func:`bf16_err` within BF16_TOL of scale; returns it."""
    e = bf16_err(got, want)
    check(e[1] <= BF16_TOL, f"{what}: {e[1]:.3e} of scale at the worst, {e[2]:.3e} on average")
    return e


def bf16_saves_check(got, want, what):
    """bf16 saves against the plain forward's float32 values, rounded: equal
    but for at most SAVE_FLIPS of them, each within 2^-6 of the tensor's
    scale (a value rounded the other way, or a later product moved by an
    operand that was). Returns the share that differs."""
    from posterior_matching_torch.ops.block_chain import round_bf16

    got, want = got.float(), round_bf16(want.float()).reshape(got.shape)
    share = (got != want).float().mean().item()
    worst = (got - want).abs().max().item() / max(1e-30, want.abs().max().item())
    check(share <= SAVE_FLIPS and worst <= 2.0 ** -6,
          f"{what}: {share:.4f} of the bf16 saves differ from the plain forward's, the worst "
          f"by {worst:.3e} of scale")
    return share


def bf16_block_phase(runs, seed):
    """The block chain's bf16 build at each encoder run of a bf16 training
    batch: forward and saves against the plain forward, the backward
    against the plain backward on the kernel's saves, a relaunch bit for
    bit, each timed beside the plain version and its bound."""
    from posterior_matching_torch.ops import block_chain as bc
    from posterior_matching_torch.ops.profiling import time_ms

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 31)
    per_run, bf16 = [], torch.bfloat16
    for x, w, mid, k in runs:
        n_lvl, (b, h, w_, c) = w["w1"].shape[0], x.shape
        cfg = bc.ChainConfig(x, n_lvl, mid, k, bf16)
        R = cfg.rows
        x0, cot = x.reshape(R, c).contiguous(), torch.randn(x.shape, generator=gen, device=DEVICE)
        wk = {n: w[n].to(cfg.dtype_of(n)).contiguous() for n in bc.NAMES}
        g = cot.reshape(R, c).contiguous()
        with torch.no_grad():
            outs = bc.chain_fwd_bf16(cfg, x0, wk)
            saved = {"x0": x0, **outs}
            wb = {n: wk[n] for n in ("w1", "w2", "w3", "w4")}
            grads = bc.chain_bwd_bf16(cfg, g, saved, wb)
            outs2, grads2 = bc.chain_fwd_bf16(cfg, x0, wk), bc.chain_bwd_bf16(cfg, g, saved, wb)
            want = bc.block_chain_plain(x, w, mid=mid, k=k, compute_dtype=bf16)
            f32 = bc.block_chain_plain(x, w, mid=mid, k=k)
            lv = lambda t: t.reshape(n_lvl, b, h, w_, -1).float()
            shares = []
            for lvl in range(n_lvl):   # the plain level on the kernel's level input
                hs = bc.bf16_sub_fwd(lv(outs["xout"])[lvl - 1] if lvl else x,
                                     {n: w[n][lvl] for n in bc.NAMES}, k)
                for i, name in enumerate(("h1", "h2", "h3")):
                    shares.append(bf16_saves_check(outs[name][lvl], hs[i],
                                                   f"block_chain_fwd_bf16 res {h} {name}"))
            d_x0, d_w = bc.bf16_chain_bwd(x, lv(outs["xout"]),
                                          [lv(outs[n]) for n in ("h1", "h2", "h3")], w, cot, k)
        torch.cuda.synchronize()
        fwd_err, fwd_rel, fwd_mean = bf16_check(outs["xout"][-1], want,
                                                f"block_chain_fwd_bf16 res {h}")
        gap = bf16_err(want, f32)
        bwd_err, worst = 0.0, ("", 0.0, 0.0)
        for name, a, ref in (("dx0", grads["dx0"], d_x0),
                             *(("d" + n, grads["d" + n], d_w[n]) for n in bc.NAMES)):
            err, rel, mean = bf16_check(a, ref, f"block_chain_bwd_bf16 res {h} {name}")
            bwd_err, worst = max(bwd_err, err), max(worst, (name, rel, mean), key=lambda t: t[1])
        check(all(torch.equal(outs[n], outs2[n]) for n in outs)
              and all(torch.equal(grads[n], grads2[n]) for n in grads),
              f"block_chain bf16 res {h}: a relaunch changed the bits")
        with torch.no_grad():
            fwd_ms = time_ms(lambda: bc.chain_fwd_bf16(cfg, x0, wk), reps=10, warmup=2)
            bwd_ms = time_ms(lambda: bc.chain_bwd_bf16(cfg, g, saved, wb), reps=10, warmup=2)
            fwd_plain = time_ms(lambda: bc.block_chain_plain(x, w, mid=mid, k=k,
                                                             compute_dtype=bf16), reps=3)
            bwd_plain = time_ms(lambda: bc.bf16_chain_bwd(
                x, lv(outs["xout"]), [lv(outs[n]) for n in ("h1", "h2", "h3")], w, cot, k),
                reps=3)
        f16, f32_ = bf16_flops("block", b, h, w_, c, mid, k, n_lvl)
        fwd_bytes = nbytes(x0, *wk.values(), *outs.values())
        bwd_bytes = nbytes(g, *saved.values(), *wb.values(), *grads.values())
        run = {"res": h, "levels": n_lvl, "k": k, "rows": R, "save_flips": max(shares),
               "bf16_vs_f32": gap[1:], "fwd_err": (fwd_rel, fwd_mean), "bwd_err": worst,
               "fwd": (fwd_err, fwd_ms, fwd_plain, (f16, f32_), fwd_bytes),
               "bwd": (bwd_err, bwd_ms, bwd_plain, (2 * f16, 2 * f32_), bwd_bytes)}
        per_run.append(run)
        log(f"block_chain bf16 res {h} (L = {n_lvl}): output {fwd_rel:.3e} / {fwd_mean:.3e} of "
            f"scale (max / mean) from the bf16 plain version, which lies {gap[1]:.3e} / "
            f"{gap[2]:.3e} from the float32 one; saves differing {max(shares):.4f}; 9 gradients "
            f"against the plain backward on the kernel's saves worst {worst[1]:.3e} / "
            f"{worst[2]:.3e} ({worst[0]}); relaunched bit for bit; fwd {fwd_ms:.4f} ms "
            f"(plain {fwd_plain:.3f}, bound {bound_bf16(f16, f32_, fwd_bytes)[0]:.4f}), bwd "
            f"{bwd_ms:.4f} ms (plain {bwd_plain:.3f}, bound "
            f"{bound_bf16(2 * f16, 2 * f32_, bwd_bytes)[0]:.4f})")
        del outs, outs2, grads, grads2, saved
    return per_run


def bf16_decoder_phase(runs, seed):
    """The decoder chain's bf16 build at each decoder run of a bf16 training
    batch, as :func:`bf16_block_phase` holds the block chain's."""
    from posterior_matching_torch.ops import block_chain as bc
    from posterior_matching_torch.ops import decoder_chain as dc
    from posterior_matching_torch.ops.profiling import time_ms

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 37)
    per_run, bf16 = [], torch.bfloat16
    for x0, acts, macts, eps, w, mid, ld, k in runs:
        n_lvl, (b, h, w_, c) = eps.shape[0], x0.shape
        cfg = dc.DecConfig(x0, acts, n_lvl, mid, ld, k, bf16)
        R, shapes = cfg.rows, cfg.shapes()
        flat = lambda t: t.reshape(-1, t.shape[-1]).contiguous()
        inputs = {"x0": flat(x0), "acts": flat(acts), "macts": flat(macts),
                  "eps": eps.reshape(n_lvl, R, ld).contiguous(),
                  **{n: w[n].to(cfg.dtype_of(n)).contiguous() for n in dc.NAMES}}
        cot5 = [torch.randn(x0.shape, generator=gen, device=DEVICE),
                *(torch.randn((n_lvl, b, h, w_, shapes[n][-1]), generator=gen, device=DEVICE)
                  for n in ("post", "prior", "masked"))]
        cots = {"g": flat(cot5[0]), **{g_: t.reshape(shapes[n]).contiguous() for g_, n, t in zip(
            ("gpost", "gprior", "gmask"), ("post", "prior", "masked"), cot5[1:])}}
        wk = {n: inputs[n] for n in dc.NAMES}
        with torch.no_grad():
            outs = dc.dec_fwd_bf16(cfg, inputs)
            saved = {n: {**inputs, **outs}[n] for n in cfg.saved}
            grads = dc.dec_bwd_bf16(cfg, cots, saved, wk)
            outs2, grads2 = dc.dec_fwd_bf16(cfg, inputs), dc.dec_bwd_bf16(cfg, cots, saved, wk)
            want = dc.dec_chain_plain(x0, acts, macts, eps, w, ld=ld, k=k, compute_dtype=bf16)
            f32 = dc.dec_chain_plain(x0, acts, macts, eps, w, ld=ld, k=k)
            lv = lambda t: t.reshape(n_lvl, b, h, w_, -1).float()
            # each level's saves against its plain Blocks on the kernel's
            # level input and u
            shares = []
            for lvl in range(n_lvl):
                x_in = lv(outs["xout"])[lvl - 1] if lvl else x0
                wl = {n: w[n][lvl] for n in dc.NAMES}
                blk = lambda tag: {n: wl[f"{tag}_{n}"] for n in bc.NAMES}
                for tag, inp in (("p", torch.cat([x_in, acts], -1)),
                                 ("m", torch.cat([x_in, macts], -1)), ("q", x_in),
                                 ("r", lv(outs["u"])[lvl])):
                    hs = bc.bf16_sub_fwd(inp, blk(tag), k)
                    for i in range(3):
                        name = f"{tag}h{i + 1}"
                        shares.append(bf16_saves_check(outs[name][lvl], hs[i],
                                                       f"decoder_chain_fwd_bf16 res {h} {name}"))
            d_x0, d_acts, d_macts, d_w = dc.bf16_dec_chain_bwd(
                x0, acts, macts, eps, lv(outs["xout"]), [lv(outs[s]) for s in dc.SAVES], w,
                cot5, ld=ld, k=k)
        torch.cuda.synchronize()
        fwd_err, fwd_rel, fwd_mean, gap = 0.0, 0.0, 0.0, (0.0, 0.0)
        for name, ref, ref32 in zip(("xout", "post", "prior", "masked"), want, f32):
            got = outs[name][-1] if name == "xout" else outs[name]
            err, rel, mean = bf16_check(got, ref, f"decoder_chain_fwd_bf16 res {h} {name}")
            fwd_err, fwd_rel, fwd_mean = max(fwd_err, err), max(fwd_rel, rel), max(fwd_mean, mean)
            g_ = bf16_err(ref, ref32)
            gap = (max(gap[0], g_[1]), max(gap[1], g_[2]))
        plain = {"dx0": d_x0, "dacts": d_acts, "dmacts": d_macts,
                 **{"d" + n: d_w[n] for n in dc.NAMES}}
        bwd_err, worst = 0.0, ("", 0.0, 0.0)
        for name, ref in plain.items():
            err, rel, mean = bf16_check(grads[name], ref, f"decoder_chain_bwd_bf16 res {h} {name}")
            bwd_err, worst = max(bwd_err, err), max(worst, (name, rel, mean), key=lambda t: t[1])
        check(all(torch.equal(outs[n], outs2[n]) for n in outs)
              and all(torch.equal(grads[n], grads2[n]) for n in grads),
              f"decoder_chain bf16 res {h}: a relaunch changed the bits")
        with torch.no_grad():
            fwd_ms = time_ms(lambda: dc.dec_fwd_bf16(cfg, inputs), reps=5, warmup=1)
            bwd_ms = time_ms(lambda: dc.dec_bwd_bf16(cfg, cots, saved, wk), reps=5, warmup=1)
            fwd_plain = time_ms(lambda: dc.dec_chain_plain(x0, acts, macts, eps, w, ld=ld, k=k,
                                                           compute_dtype=bf16), reps=2)
            bwd_plain = time_ms(lambda: dc.bf16_dec_chain_bwd(
                x0, acts, macts, eps, lv(outs["xout"]), [lv(outs[s]) for s in dc.SAVES], w,
                cot5, ld=ld, k=k), reps=2)
        f16, f32_ = bf16_flops("decoder", b, h, w_, c, mid, k, n_lvl, ld)
        # the backward: every product twice but the masked Block's x-side
        # data gradient (bf16); it also rebuilds post and u (float32)
        b16 = 2 * f16 - 2.0 * n_lvl * R * c * mid
        b32 = 2 * f32_ + 2.0 * n_lvl * R * (mid * (2 * ld + c) + ld * c)
        read_w = [t for n, t in wk.items() if n != "bz" and "_b" not in n]
        fwd_bytes = nbytes(*inputs.values(), *outs.values())
        bwd_bytes = nbytes(*cots.values(), *saved.values(), *read_w, *grads.values())
        run = {"res": h, "levels": n_lvl, "k": k, "rows": R, "save_flips": max(shares),
               "bf16_vs_f32": gap, "fwd_err": (fwd_rel, fwd_mean), "bwd_err": worst,
               "fwd": (fwd_err, fwd_ms, fwd_plain, (f16, f32_), fwd_bytes),
               "bwd": (bwd_err, bwd_ms, bwd_plain, (b16, b32), bwd_bytes)}
        per_run.append(run)
        log(f"decoder_chain bf16 res {h} (L = {n_lvl}): 4 outputs {fwd_rel:.3e} / "
            f"{fwd_mean:.3e} of scale (max / mean) from the bf16 plain version, which lies "
            f"{gap[0]:.3e} / {gap[1]:.3e} from the float32 one; saves differing "
            f"{max(shares):.4f}; {len(plain)} gradients against the plain backward on the "
            f"kernel's saves worst {worst[1]:.3e} / {worst[2]:.3e} ({worst[0]}); relaunched bit "
            f"for bit; fwd "
            f"{fwd_ms:.4f} ms (plain {fwd_plain:.3f}, bound "
            f"{bound_bf16(f16, f32_, fwd_bytes)[0]:.4f}), bwd {bwd_ms:.4f} ms (plain "
            f"{bwd_plain:.3f}, bound {bound_bf16(b16, b32, bwd_bytes)[0]:.4f})")
        del outs, outs2, grads, grads2, saved
    return per_run


def bf16_chain_lines(name, replaces, kinds, per_run, f32_lines):
    """The kernels-line entries of a chain's two bf16 builds (per launch the
    mean over the runs) with the float32 forms' ms per launch beside."""
    mean = lambda vals: sum(vals) / len(vals)
    f32_ms = {ln["name"]: ln["ms"] for ln in f32_lines}
    out = []
    for kind, line in kinds:
        per = [r[kind] for r in per_run]
        work = (mean([p[3][0] for p in per]), mean([p[3][1] for p in per]),
                mean([p[4] for p in per]))
        b_ms, b_by = bound_bf16(*work)
        out.append({
            "name": f"{name}_{kind}_bf16", "route": "cuda",
            "source": f"posterior_matching_torch/ops/csrc/{name}_{kind}.cu",
            "replaces": f"{replaces}:{line}",
            "max_abs_err": max(p[0] for p in per),
            "ms": mean([p[1] for p in per]), "plain_ms": mean([p[2] for p in per]),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "f32_ms": f32_ms.get(f"{name}_{kind}"),
            "design": ("the float32 build's GEMM core with -DPM_CORE_BF16=1: c1..c3 and their "
                       "gradients as mma.sync m16n8k16 bf16 products with float32 sums (A "
                       "rounded as it is staged, bf16 weights by cp.async, the cotangent rows "
                       "rounded at the fragment load), bf16 saves beside float32 scratch, c4 "
                       "on 3xTF32"),
            "per_run": [{"res": r["res"], "levels": r["levels"], "k": r["k"],
                         "ms": r[kind][1], "plain_ms": r[kind][2],
                         "bound_ms": bound_bf16(*r[kind][3], r[kind][4])[0],
                         "gflop_bf16": r[kind][3][0] / 1e9, "gflop_f32": r[kind][3][1] / 1e9,
                         "mb": r[kind][4] / 1e6, "save_flips": r["save_flips"],
                         "err_max_mean": (r["fwd_err"] if kind == "fwd" else r["bwd_err"][1:]),
                         "bf16_vs_f32": r["bf16_vs_f32"]} for r in per_run],
        })
    return out


def bf16_counters():
    """The bf16 builds' wrappers, whose ``launches`` count them."""
    from posterior_matching_torch.ops import block_chain as bc
    from posterior_matching_torch.ops import decoder_chain as dc

    return {"block_chain_fwd_bf16": bc.chain_fwd_bf16, "block_chain_bwd_bf16": bc.chain_bwd_bf16,
            "decoder_chain_fwd_bf16": dc.dec_fwd_bf16, "decoder_chain_bwd_bf16": dc.dec_bwd_bf16}


def bf16_cli_launches(steps, validations, n_val, batch):
    """The bf16 builds' launches that ``train_pm_vdvae`` makes (fused
    decoder, ``pm_vdvae_mnist``): a step's and a validation batch's encoder
    and decoder runs that bf16 fuses at ``batch`` (rows a multiple of 16),
    and each validation's reconstruction callback, whose forward encodes
    and decodes 8 images and whose imputations encode them once more."""
    from posterior_matching_torch.ops.block_chain import chain_supported

    bf = torch.bfloat16
    runs = lambda n: sum(chain_supported(n, r, r, bf) for r in (28, 14, 7, 3, 1))
    enc, dec, enc8, dec8 = 2 * runs(batch), runs(batch), 2 * runs(8), runs(8)
    return {"block_chain_fwd_bf16": enc * steps + validations * (enc * n_val + enc8 + enc8 // 2),
            "block_chain_bwd_bf16": enc * steps,
            "decoder_chain_fwd_bf16": dec * steps + validations * (dec * n_val + dec8),
            "decoder_chain_bwd_bf16": dec * steps}


def remat_check(seed, gen, mask_fn):
    """One full-width bf16 step of the unfused model (every encoder Block a
    Block of its own) with ``remat`` off and on, cuDNN's deterministic
    algorithms asked for: the loss and every gradient bit for bit equal;
    each step's peak device memory."""
    from posterior_matching_torch import config, convert
    from posterior_matching_torch.train.trainer import pm_vdvae_loss

    tree = convert.random_pm_vdvae_tree(config.PM_VDVAE_MNIST, seed=seed)
    batch = mnist_batch(gen, DEVICE, VDVAE_TRAIN_BATCH, mask_fn)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for remat in (False, True):
            model = convert.pm_vdvae_from_jax(tree, dict(
                config.PM_VDVAE_MNIST, compute_dtype="bfloat16", fused_chain=False,
                remat=remat), device=DEVICE)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            loss = pm_vdvae_loss(model, batch, seed + 41)
            grads = torch.autograd.grad(loss, list(model.parameters()))
            torch.cuda.synchronize()
            out[remat] = (loss.detach(), grads, torch.cuda.max_memory_allocated())
            del model
    finally:
        torch.backends.cudnn.deterministic = det
    same = torch.equal(out[False][0], out[True][0]) and all(
        torch.equal(a, b) for a, b in zip(out[False][1], out[True][1]))
    worst = max(((a - b).abs().max().item() for a, b in zip(out[False][1], out[True][1])))
    check(same, f"remat changed the step's loss or gradients (worst {worst:.3e})")
    mem = {str(k): v[2] for k, v in out.items()}
    log(f"remat: a bf16 step of the unfused model with remat off and on, loss "
        f"{out[False][0].item():.6f}, every gradient bit for bit equal; peak device memory "
        f"{mem['False'] / 2**20:.1f} MiB without, {mem['True'] / 2**20:.1f} MiB with")
    return {"loss": out[False][0].item(), "max_memory_allocated": mem}


def bf16_phase(args, gen, work, f32_lines):
    """Phase 19: the bf16 builds at the full-width runs, ``train_pm_vdvae``
    with ``compute_dtype`` bfloat16 and ``flat_optimizer`` (the main path of
    the bf16 builds: every counter set to 0 just before and read just
    after) on phase 11's files in ``work``/data, its resume, both VDVAE evals
    on its run (phase 13's ``work``/eval_data), the remat step, and the bf16
    and float32 ms per launch side by side. Its runs go under
    ``work``/bf16."""
    from posterior_matching_torch import (
        config, convert, eval_pm_vdvae_imputation, eval_pm_vdvae_likelihood, masking,
        train_pm_vdvae,
    )
    from posterior_matching_torch.train.state import load_train_state

    t0 = time.perf_counter()
    mask_fn = masking.get_mask_generator("MNISTMaskGenerator", device=DEVICE)
    model_config = dict(config.PM_VDVAE_MNIST, compute_dtype="bfloat16", fused_chain=True)
    tree = convert.random_pm_vdvae_tree(model_config, seed=args.seed)
    model = convert.pm_vdvae_from_jax(tree, model_config, device=DEVICE)
    batch = mnist_batch(gen, DEVICE, VDVAE_TRAIN_BATCH, mask_fn)
    runs = capture_runs(model, batch["image"], batch["mask"])
    check([(r[0].shape[1], r[1]["w1"].shape[0], r[3]) for r in runs]
          == [(28, 6, 3), (14, 4, 3), (7, 2, 3), (3, 2, 3), (1, 2, 1)],
          "the bf16 encoder's runs are not the config's five")
    block_runs = bf16_block_phase(runs, args.seed)
    del runs
    dec_runs = capture_dec_runs(model, batch, gen)
    check([(r[0].shape[1], r[3].shape[0], r[7]) for r in dec_runs]
          == [(1, 2, 1), (3, 3, 3), (7, 3, 3), (14, 5, 3), (28, 7, 3)],
          "the bf16 decoder's fused runs are not the config's five")
    dec_runs_ = bf16_decoder_phase(dec_runs, args.seed)
    del dec_runs, model
    lines = (bf16_chain_lines("block_chain", "posterior_matching_tpu/ops/block_chain.py",
                              (("fwd", 270), ("bwd", 308)), block_runs, f32_lines)
             + bf16_chain_lines("decoder_chain", "posterior_matching_tpu/ops/decoder_chain.py",
                                (("fwd", 226), ("bwd", 291)), dec_runs_, f32_lines))
    for line in lines:
        log(f"{line['name']}: {line['ms']:.4f} ms per launch in bf16 against "
            f"{line['f32_ms']:.4f} in float32 (mean over the runs; plain bf16 "
            f"{line['plain_ms']:.3f}, bound {line['bound_ms']:.4f} by {line['bound_by']})")

    # ---- the main path: train_pm_vdvae in bf16 with flat_optimizer --------
    n_val = 64 // VDVAE_TRAIN_BATCH
    argv = ["--config", "pm_vdvae_mnist", "--config.seed", str(args.seed),
            "--config.model.fused_chain=True", "--config.model.compute_dtype", "bfloat16",
            "--config.flat_optimizer", "True", "--config.validation_freq", str(BF16_VAL_FREQ)]
    os.makedirs(f"{work}/bf16/first")
    counters = {**all_kernel_counters(), **bf16_counters()}
    for c in counters.values():
        c.launches = 0
    with cli_env(f"{work}/bf16/first", f"{work}/data"):
        _, cli_lines, wall = run_cli("train_pm_vdvae (bf16, flat_optimizer)",
                                     train_pm_vdvae.main,
                                     [*argv, "--config.steps", str(BF16_STEPS)])
    launched = {k: c.launches for k, c in counters.items()}
    want = dict.fromkeys(counters, 0)
    want.update(bf16_cli_launches(BF16_STEPS, BF16_STEPS // BF16_VAL_FREQ, n_val,
                                  VDVAE_TRAIN_BATCH))
    check(launched == want, f"train_pm_vdvae in bf16 launched {launched}, not {want}")
    (run_dir,) = glob.glob(f"{work}/bf16/first/runs/pm-vdvae-mnist-*")
    with open(f"{run_dir}/model_config.json") as fp:
        written = json.load(fp)
    check(written.get("compute_dtype") == "bfloat16",
          f"model_config.json holds compute_dtype {written.get('compute_dtype')!r}")
    ts = load_train_state(f"{run_dir}/train_state.pkl")
    adam = ts.opt_state[0][1]   # group_by_shape's (chain state,)
    check(isinstance(adam.args[1], list) and int(np.asarray(adam.args[0])) == BF16_STEPS,
          "the checkpoint's optimizer state is not flat_optimizer's layout")
    val = [ln for ln in cli_lines if ln.startswith("[step ")]
    check(len(val) == BF16_STEPS // BF16_VAL_FREQ
          and all(np.isfinite(line_value(ln, "val_loss")) for ln in val),
          "train_pm_vdvae in bf16 did not log a finite validation at each")
    log(f"train_pm_vdvae bf16 + flat_optimizer: {BF16_STEPS} steps in {wall:.1f} s, launches "
        f"{launched}; model_config.json compute_dtype bfloat16; the optimizer state in "
        f"group_by_shape's layout ({len(adam.args[1])} shape groups)")

    # ---- --resume_dir, then both evals on the first run --------------------
    os.makedirs(f"{work}/bf16/resumed")
    with cli_env(f"{work}/bf16/resumed", f"{work}/data"):
        _, res_lines, res_wall = run_cli("train_pm_vdvae --resume_dir", train_pm_vdvae.main, [
            *argv, "--config.steps", str(BF16_RESUME_STEPS), "--resume_dir", run_dir])
    (resumed,) = glob.glob(f"{work}/bf16/resumed/runs/pm-vdvae-mnist-*")
    ts2 = load_train_state(f"{resumed}/train_state.pkl")
    check(int(ts2.step) == BF16_RESUME_STEPS
          and int(np.asarray(ts2.opt_state[0][1].args[0])) == BF16_RESUME_STEPS,
          "the resumed run's checkpoint is not at its last step")
    evals = {}
    common = ["--run_dir", run_dir, "--dataset", "mnist", "--mask_generator",
              "MNISTMaskGenerator", "--num_trials", "1", "--num_instances", str(BATCH),
              "--batch_size", str(BATCH)]
    with cli_env(f"{work}/bf16", f"{work}/eval_data"):
        for stage, main, extra, results in (
                ("eval_pm_vdvae_imputation", eval_pm_vdvae_imputation.main,
                 ["--num_samples", "2"], "imputation_results"),
                ("eval_pm_vdvae_likelihood", eval_pm_vdvae_likelihood.main,
                 ["--num_samples", "4", "--batch_chunk", str(BATCH)], "likelihood_results")):
            for c in counters.values():
                c.launches = 0
            _, _, ewall = run_cli(f"{stage} (bf16 run)", main, [*common, *extra])
            fwd = counters["block_chain_fwd_bf16"].launches
            check(fwd > 0 and counters["block_chain_fwd"].launches == 0,
                  f"{stage} on the bf16 run did not go through the bf16 block chain")
            arrays = [np.load(f) for f in glob.glob(f"{run_dir}/{results}/*.npy")]
            check(bool(arrays) and all(np.isfinite(a).all() for a in arrays),
                  f"{stage} wrote no or non-finite results")
            evals[stage] = {"wall_s": ewall, "block_chain_fwd_bf16": fwd}
    log(f"resume to step {BF16_RESUME_STEPS} in {res_wall:.1f} s; evals on the bf16 run: {evals}")
    remat = remat_check(args.seed, gen, mask_fn)
    seconds = time.perf_counter() - t0
    return lines, {"seconds": seconds, "cli_launches": launched, "cli_wall_s": wall,
                   "resume_wall_s": res_wall, "evals": evals, "remat": remat,
                   "block_runs": [{k: v for k, v in r.items() if k not in ("fwd", "bwd")}
                                  for r in block_runs],
                   "decoder_runs": [{k: v for k, v in r.items() if k not in ("fwd", "bwd")}
                                    for r in dec_runs_]}


# ---------------------------------------------------------------------------
# Phase 20: the PM-VQVAE in bf16, the gated chain's bf16 builds
# ---------------------------------------------------------------------------

# The gated chain's bf16 builds against their plain bf16 versions. Here the
# residual stream itself is bf16 (every level's output rounded), so a value
# that the kernel's and the plain version's float32 sums put on the two
# sides of a bf16 boundary moves by one ulp (2^-8 of it) and the later
# levels carry that on: each output and gradient within GATED_BF16_TOL of
# its scale at the worst and GATED_BF16_MEAN on average (the JAX package's
# bf16 gradient tolerance is 2e-2); the saves, against the plain level on
# the kernel's own level input, equal but for at most SAVE_FLIPS of them;
# the backward against the plain backward on the kernel's own saves; a
# relaunch bit for bit.
GATED_BF16_TOL, GATED_BF16_MEAN = 2e-2, 2e-3
PMVQ_BF16_STEPS = 2
# bf16 against float32 from the same weights: the first step's loss (the
# log-likelihood of random weights moves ~1e-3 relative in bf16) within
# PMVQ_BF16_STEP_TOL, and, as a sanity bar only, the CLI's validation loss
# after 2 steps within PMVQ_BF16_LOSS_TOL: from this init the loss
# overshoots before it falls, and Adam's first steps move every weight by
# about the learning rate in its gradient's sign, which bf16 can flip where
# a gradient is near 0 (on an H100, 7-9% apart at step 2).
PMVQ_BF16_STEP_TOL, PMVQ_BF16_LOSS_TOL = 1e-2, 0.25
GATED_BF16_DESIGN = ("the float32 build's GEMM core with -DPM_CORE_BF16=1: every product "
                     "mma.sync m16n8k16 bf16 with float32 sums (A rounded as it is staged "
                     "after concat_elu and the mask, bf16 weights by cp.async, the cotangent "
                     "rows rounded at the fragment load); activations, saves and their "
                     "cotangents bf16 beside float32 scratch")
# (kind, fwd line, bwd line) of posterior_matching_tpu/ops/gated_chain.py
GATED_KINDS = (("stream", 1337, 1407), ("pair", 305, 368), ("segment", 801, 861))


def gated_bf16_counters():
    """The gated chain's bf16 builds' wrappers, whose ``launches`` count
    them."""
    from posterior_matching_torch.ops import gated_chain as gc

    return {"gated_stream_fwd_bf16": gc.stream_fwd_bf16,
            "gated_stream_bwd_bf16": gc.stream_bwd_bf16,
            "gated_pair_fwd_bf16": gc.pair_fwd_bf16, "gated_pair_bwd_bf16": gc.pair_bwd_bf16,
            "gated_segment_fwd_bf16": gc.seg_fwd_bf16,
            "gated_segment_bwd_bf16": gc.seg_bwd_bf16}


def gated_bf16_check(pcnn, codes, cond, kind, seed):
    """One bf16 chain kernel pair at the model's shapes, keep its dropout:
    the stream over the up pass, the pair at the first down level, the
    segment over the last SEGMENT-or-fewer down levels (a short tail where
    SEGMENT does not divide num_resnet), the down levels' skips and inputs
    the kernels' own up pass. Returns the forward's and backward's
    (max abs error, ms, plain ms, operations, bytes, float32 build ms) and
    the worst errors and save flips."""
    from posterior_matching_torch.ops import gated_chain as gc
    from posterior_matching_torch.ops.profiling import time_ms

    bf = torch.bfloat16
    n, f, rf = pcnn.num_resnet, pcnn.num_filters, pcnn.receptive_field_dims
    keep, taps = 1.0 - pcnn.dropout, gc.chain_taps(rf)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 43)
    with torch.no_grad():
        xv0, xh0 = (t.contiguous() for t in pcnn.init_stacks(codes))
        pack = lambda d, p: {k: v.detach().contiguous() for k, v in
                             gc.pack_level(pcnn.layers, d, p, f, d == "dn", rf).items()}
        up = [pack("up", p) for p in range(n)]
        cfg_up = gc.StreamConfig(xv0, cond, n, False, keep, seed, 0, taps, bf)
        up_out = gc.stream_fwd_bf16(cfg_up, xv0, xh0, None, cond,
                                    gc._kernel_weights(cfg_up, gc.stack_levels(up)))
    shape = xv0.shape
    xs_v = [xv0, *(t.view(shape) for t in up_out["xvo"])]
    xs_h = [xh0, *(t.view(shape) for t in up_out["xho"])]
    if kind == "stream":
        lv, base, ws, sk, (xv, xh) = range(n), 0, up, None, (xv0, xh0)
    else:
        first = 0 if kind == "pair" else (n - 1) // SEGMENT * SEGMENT
        lv = range(first, first + 1 if kind == "pair" else n)
        base, ws = n + first, [pack("dn", p) for p in lv]
        sk = [(xs_v[n - 1 - p].contiguous(), xs_h[n - 1 - p].contiguous()) for p in lv]
        xv, xh = xs_v[n - first], xs_h[n - first]
    n_lvl = len(ws)
    cfg = gc.StreamConfig(xv, cond, n_lvl, sk is not None, keep, seed, base, taps, bf)
    cfg32 = gc.StreamConfig(xv, cond, n_lvl, sk is not None, keep, seed, base, taps)
    masks = [tuple(gc.dropout_keep_mask(seed, 2 * (base + l) + s, *shape[:3], 2 * f, keep,
                                        DEVICE) for s in (0, 1)) for l in range(n_lvl)]
    gs = [tuple(torch.randn(shape, generator=gen, device=DEVICE).to(bf) for _ in range(2))
          for _ in range(n_lvl)]
    if kind == "stream":
        fwd_k, bwd_k = gc.stream_fwd_bf16, gc.stream_bwd_bf16
        fwd32, bwd32 = gc.stream_fwd, gc.stream_bwd
        w16 = gc._kernel_weights(cfg, gc.stack_levels(ws))
        w32 = gc.stack_levels(ws)
        gv, gh = (torch.stack([g[i] for g in gs]).reshape(n_lvl, cfg.rows, f) for i in (0, 1))

        def run_fwd(c, fn, w, x):
            return fn(c, x[0], x[1], None, cond, w)

        def run_bwd(c, fn, w, x, saves, g):
            saved = {"xv0": x[0], "xh0": x[1], "cond": cond, **saves}
            return fn(c, g[0], g[1], saved, {k: v for k, v in w.items() if k[0] != "b"})

        per_level = lambda o: [{k: o[k][l].view(*shape[:3], -1) for k in gc._SAVES}
                               for l in range(n_lvl)]
        gargs = (gv, gh)
    else:
        fwd_k, bwd_k = (gc.pair_fwd_bf16, gc.pair_bwd_bf16) if kind == "pair" else (
            gc.seg_fwd_bf16, gc.seg_bwd_bf16)
        fwd32, bwd32 = (gc.pair_fwd, gc.pair_bwd) if kind == "pair" else (gc.seg_fwd, gc.seg_bwd)
        w16 = [gc._kernel_weights(cfg, w) for w in ws]
        w32 = ws

        def run_fwd(c, fn, w, x):
            s = sk if c.bf16 else [tuple(t.float() for t in p) for p in sk]
            return fn(c, x[0], x[1], s, cond, w)

        def run_bwd(c, fn, w, x, saves, g):
            s = sk if c.bf16 else [tuple(t.float() for t in p) for p in sk]
            return fn(c, g, x[0], x[1], cond, s, saves, w)

        per_level = lambda o: o
        gargs = gs
    with torch.no_grad():
        outs = run_fwd(cfg, fwd_k, w16, (xv, xh))
        grads = run_bwd(cfg, bwd_k, w16, (xv, xh), outs, gargs)
        outs2 = run_fwd(cfg, fwd_k, w16, (xv, xh))
        grads2 = run_bwd(cfg, bwd_k, w16, (xv, xh), outs, gargs)
        flat = lambda t: ([v for v in t.values()] if isinstance(t, dict) else
                          [v for d in t for v in (d.values() if isinstance(d, dict) else
                                                  flat(d))])
        check(all(torch.equal(a, b) for a, b in zip(flat(outs), flat(outs2)))
              and all(torch.equal(a, b) for a, b in zip(flat(grads), flat(grads2))),
              f"gated_{kind} bf16 F {f}: a relaunch changed the bits")
        del outs2, grads2
        lvl_saves = per_level(outs)
        # the plain chain from the same inputs, and each level's saves
        # against the plain level on the kernel's own level input
        want = gc.gated_segment_plain(xv, xh, sk, cond, ws, keep=keep, masks=masks, taps=taps,
                                      compute_dtype=bf)
        fwd_err, fwd_rel, fwd_mean, shares = 0.0, 0.0, 0.0, []
        xs = [(xv, xh)] + [(s["xvo"], s["xho"]) for s in lvl_saves]
        for l in range(n_lvl):
            for i, name in enumerate(("xvo", "xho")):
                e = bf16_err(lvl_saves[l][name], want[l][i])
                fwd_err, fwd_rel, fwd_mean = max(fwd_err, e[0]), max(fwd_rel, e[1]), max(
                    fwd_mean, e[2])
            ref_v, ref_h, ref = gc.bf16_level_fwd(
                xs[l][0].float(), xs[l][1].float(),
                None if sk is None else tuple(t.float() for t in sk[l]), cond, ws[l],
                *masks[l], taps, keep)
            for name, r in zip(gc._SAVES, (ref_v, ref_h, *ref)):
                shares.append(bf16_saves_check(lvl_saves[l][name], r,
                                               f"gated_{kind}_fwd_bf16 F {f} level {l} {name}"))
        check(fwd_rel <= GATED_BF16_TOL and fwd_mean <= GATED_BF16_MEAN,
              f"gated_{kind}_fwd_bf16 F {f}: outputs {fwd_rel:.3e} / {fwd_mean:.3e} of scale "
              "from the plain bf16 chain")
        # the backward against the plain backward on the kernel's saves
        saves4 = [tuple(s[k] for k in ("a1v", "a1h", "b1v", "b1h")) for s in lvl_saves]
        (dxv, dxh), dsk, dcond, dws = gc.bf16_levels_bwd(
            gs, xs, sk, cond, ws, saves4, masks, keep, taps, kind == "stream")
        if kind == "stream":
            kd = {"dxv0": grads["dxv0"], "dxh0": grads["dxh0"], "dcond": grads["dcond"],
                  **{f"d{k}{l}": grads["d" + k][l] for l in range(n_lvl) for k in ws[0]}}
        else:
            head, per = grads
            kd = {**head, **{f"d{k}{l}": per[l]["d" + k] for l in range(n_lvl) for k in ws[0]},
                  **{f"dsk{i}{l}": per[l]["dsk" + "vh"[i]] for l in range(n_lvl)
                     for i in (0, 1) if sk is not None}}
        pd = {"dxv0": dxv, "dxh0": dxh, "dcond": dcond,
              **{f"d{k}{l}": dws[l][k] for l in range(n_lvl) for k in ws[0]},
              **{f"dsk{i}{l}": dsk[l][i] for l in range(n_lvl) for i in (0, 1)
                 if sk is not None}}
        bwd_err, worst = 0.0, ("", 0.0, 0.0)
        for name, ref in pd.items():
            e = bf16_err(kd[name], ref)
            bwd_err, worst = max(bwd_err, e[0]), max(worst, (name, e[1], e[2]),
                                                     key=lambda t: t[1])
        check(worst[1] <= GATED_BF16_TOL and worst[2] <= GATED_BF16_MEAN,
              f"gated_{kind}_bwd_bf16 F {f}: {worst[0]} {worst[1]:.3e} / {worst[2]:.3e} of "
              "scale from the plain backward on the kernel's saves")
        gap = max(bf16_err(want[-1][i], ref32) for i, ref32 in enumerate(
            gc.gated_segment_plain(xv.float(), xh.float(),
                                   None if sk is None else [tuple(t.float() for t in p)
                                                            for p in sk],
                                   cond, ws, keep=keep, masks=masks, taps=taps)[-1]))
        # times: the bf16 build, its plain version, the float32 build on the
        # same values in float32
        x32 = (xv.float(), xh.float())
        outs32 = run_fwd(cfg32, fwd32, w32, x32)
        g32 = [tuple(t.float() for t in g) for g in gs] if kind != "stream" else tuple(
            t.float() for t in gargs)
        fwd_ms = time_ms(lambda: run_fwd(cfg, fwd_k, w16, (xv, xh)), reps=10, warmup=2)
        bwd_ms = time_ms(lambda: run_bwd(cfg, bwd_k, w16, (xv, xh), outs, gargs), reps=10,
                         warmup=2)
        fwd32_ms = time_ms(lambda: run_fwd(cfg32, fwd32, w32, x32), reps=10, warmup=2)
        bwd32_ms = time_ms(lambda: run_bwd(cfg32, bwd32, w32, x32, outs32, g32), reps=10,
                           warmup=2)
        fwd_plain = time_ms(lambda: gc.gated_segment_plain(
            xv, xh, sk, cond, ws, keep=keep, masks=masks, taps=taps, compute_dtype=bf), reps=3)
        bwd_plain = time_ms(lambda: gc.bf16_levels_bwd(
            gs, xs, sk, cond, ws, saves4, masks, keep, taps, kind == "stream"), reps=3)
    ins = [xv, xh, cond, *flat(w16), *(t for p in (sk or ()) for t in p)]
    fwd_bytes = nbytes(*ins, *flat(outs))
    bwd_bytes = nbytes(*(t for g in gs for t in g), *ins, *flat(outs), *flat(grads))
    (ff, fb), (bfl, bb) = stream_work(cfg, fwd_bytes, bwd_bytes)
    log(f"gated_{kind} bf16 F {f} (L = {n_lvl}): outputs {fwd_rel:.3e} / {fwd_mean:.3e} of "
        f"scale (max / mean) from the bf16 plain chain, which lies {gap[1]:.3e} / {gap[2]:.3e} "
        f"from the float32 one; saves differing {max(shares):.4f}; {len(pd)} gradients "
        f"against the plain backward on the kernel's saves worst {worst[1]:.3e} / "
        f"{worst[2]:.3e} ({worst[0]}); relaunched bit for bit; fwd {fwd_ms:.4f} ms (float32 "
        f"build {fwd32_ms:.4f}, plain {fwd_plain:.3f}, bound "
        f"{bound_bf16(ff, 0.0, fb)[0]:.4f}), bwd {bwd_ms:.4f} ms (float32 build "
        f"{bwd32_ms:.4f}, plain {bwd_plain:.3f}, bound {bound_bf16(bfl, 0.0, bb)[0]:.4f})")
    return {"levels": n_lvl, "save_flips": max(shares), "fwd_err": (fwd_rel, fwd_mean),
            "bwd_err": worst, "bf16_vs_f32": gap[1:],
            "fwd": (fwd_err, fwd_ms, fwd_plain, ff, fb, fwd32_ms),
            "bwd": (bwd_err, bwd_ms, bwd_plain, bfl, bb, bwd32_ms)}


def pmvq_bf16_phase(args, gen, celeb_a, work):
    """Phase 20: the gated chain's bf16 builds (rows 4-9 of PERF.md's table)
    at the full widths, 128 filters (PM-VQVAE CelebA, 16 x 16 codes, 12 + 12
    levels, batch 32) and 64 (digits16, 4 x 4, 6 + 6), each against its
    plain bf16 version; then the main path: ``train_pm_vqvae --config
    pm_vqvae_celeb_a --config.compute_dtype bfloat16`` on phase 12's files
    and stage-1 run, in each chain mode (every counter set to 0 just
    before, the bf16 builds' launches exactly the expected ones and the
    float32 builds' none), its validation loss beside phase 12's float32
    run at the same step from the same seed and weights, and
    ``eval_pm_vqvae`` on the bf16 stream run. Runs go under ``work``."""
    from posterior_matching_torch import config, convert, eval_pm_vqvae, masking, train_pm_vqvae
    from posterior_matching_torch.train.trainer import pm_vqvae_loss

    t0 = time.perf_counter()
    bf = torch.bfloat16
    results = {}
    for name, (vq_cfg, pm) in {
            "celeb_a": (config.VQVAE_CELEB_A, config.CONFIGS["pm_vqvae_celeb_a"]()),
            "digits16": (config.CONFIGS["vqvae_digits16"]()["model"],
                         config.CONFIGS["pm_vqvae_digits16"]())}.items():
        pc_cfg = {**pm["pixel_cnn"], "num_indices": vq_cfg["num_embeddings"]}
        cd = pm["conditional_dim"]
        tree = convert.random_pm_vqvae_tree(cd, vq_cfg, pc_cfg, seed=args.seed)
        model = convert.pm_vqvae_from_jax(*tree, cd, vq_cfg, pc_cfg, device=DEVICE,
                                          compute_dtype="bfloat16")
        f32 = convert.pm_vqvae_from_jax(*tree, cd, vq_cfg, pc_cfg, device=DEVICE)
        pcnn = model.pixel_cnn
        check(pcnn.compute_dtype == bf, f"the {name} model is not bf16")
        shape = (BATCH, *(config.CELEB_A_IMAGE_SHAPE if name == "celeb_a" else DIGITS16_IMAGE))
        mask_fn = masking.get_mask_generator(pm["data"]["mask_generator"], device=DEVICE)
        batch = masking.add_mask({"image": torch.rand(shape, generator=gen, device=DEVICE)},
                                 gen, mask_fn)
        with torch.no_grad():
            codes = model.vqvae.encoding_indices(batch["image"])
            cond = model.conditional_latents(batch["image"], batch["mask"]).contiguous()
            kept = (codes == f32.vqvae.encoding_indices(batch["image"])).float().mean().item()
            step = [pm_vqvae_loss(m, batch, args.seed + 47, True).item() for m in (model, f32)]
        check(abs(step[0] - step[1]) <= PMVQ_BF16_STEP_TOL * abs(step[1]),
              f"{name}: the first step's loss {step[0]} in bf16 against {step[1]} in float32")
        log(f"{name}: the bf16 VQ-VAE's codes equal the float32 one's at {kept:.4f} of "
            f"{codes.numel()} positions (random weights from the seed); the first training "
            f"step's loss {step[0]:.4f} in bf16 against {step[1]:.4f} in float32")
        results[pcnn.num_filters] = {kind: gated_bf16_check(pcnn, codes, cond, kind, args.seed)
                                     for kind, _, _ in GATED_KINDS}
        results[pcnn.num_filters]["codes_kept"] = kept
        results[pcnn.num_filters]["first_step_loss"] = step
        del model, pcnn, f32
    kernel_s = time.perf_counter() - t0

    # ---- the main path: train_pm_vqvae in bf16, each chain mode ------------
    stage2 = config.CONFIGS["pm_vqvae_celeb_a"]()
    n, rows = stage2["pixel_cnn"]["num_resnet"], stage2["pixel_cnn"]["image_shape"][0]
    steps = PMVQ_BF16_STEPS
    n_val = 64 // stage2["data"]["val_batch_size"]
    vqvae_dir, data = celeb_a["train_vqvae"]["run_dir"], f"{work}/celeb_a/data"
    f32_line = [ln for ln in celeb_a["train_pm_vqvae"]["lines"] if ln.startswith("[step ")][0]
    check(f32_line.startswith(f"[step {steps}/"),
          f"phase 12's first validation is not at step {steps}: {f32_line}")
    f32_val = line_value(f32_line, "val_loss")
    counters = {**all_kernel_counters(), **bf16_counters(), **gated_bf16_counters()}
    out, launches = {}, {}
    for mode in ("stream", 1, SEGMENT):
        per_step = {f"{k}_bf16": v for k, v in mode_launches(mode, n).items()
                    if k != "vq_search"}
        fwd, bwd = sorted(per_step)[1], sorted(per_step)[0]   # ..._bwd_bf16 sorts first
        expected = dict.fromkeys(counters, 0)
        expected.update({"vq_search": steps + n_val, fwd: per_step[fwd] * (steps + n_val),
                         bwd: per_step[bwd] * steps, "sampler_vrow": rows,
                         "sampler_row": rows})
        cwd = f"{work}/pmvq_bf16_{mode}"
        os.makedirs(cwd)
        for c in counters.values():
            c.launches = 0
        with cli_env(cwd, data):
            _, lines, wall = run_cli(f"train_pm_vqvae bf16 chain_segment={mode}",
                                     train_pm_vqvae.main, [
                                         "--config", "pm_vqvae_celeb_a", "--config.steps",
                                         str(steps), "--config.validation_freq", str(steps),
                                         "--config.seed", str(args.seed),
                                         "--config.compute_dtype", "bfloat16",
                                         "--config.vqvae_dir", vqvae_dir,
                                         "--chain_segment", str(mode)])
        launched = {k: c.launches for k, c in counters.items()}
        check(launched == expected, f"train_pm_vqvae bf16 {mode} launched {launched}, "
                                    f"not {expected}")
        launches[str(mode)] = {k: v for k, v in launched.items() if v}
        (run_dir,) = glob.glob(f"{cwd}/runs/pm-vqvae-celeb_a-*")
        with open(f"{run_dir}/config.json") as fp:
            written = json.load(fp)
        check(written.get("compute_dtype") == "bfloat16",
              f"config.json holds compute_dtype {written.get('compute_dtype')!r}")
        val = [ln for ln in lines if ln.startswith("[step ")]
        loss = line_value(val[-1], "val_loss") if val else float("nan")
        check(len(val) == 1 and np.isfinite(loss)
              and abs(loss - f32_val) <= PMVQ_BF16_LOSS_TOL * abs(f32_val),
              f"train_pm_vqvae bf16 {mode}: validation loss {loss} against float32 {f32_val}")
        out[str(mode)] = {"run_dir": run_dir, "wall_s": wall, "val_loss": loss,
                          "launches": launches[str(mode)]}
        log(f"train_pm_vqvae bf16 chain_segment={mode}: {steps} steps in {wall:.1f} s; "
            f"validation loss {loss:.4f} at step {steps} against {f32_val:.4f} in float32 "
            f"(phase 12, same seed and weights); launches {launches[str(mode)]}")

    # ---- eval_pm_vqvae on the bf16 stream run -----------------------------
    run_dir = out["stream"]["run_dir"]
    loaded = convert.load_pm_vqvae(run_dir, device=DEVICE)
    check(loaded.pixel_cnn.compute_dtype == bf and loaded.vqvae.decoder.dec_1.dtype == bf
          and loaded.partial_encoder.encoder.enc_1.dtype == bf,
          "load_pm_vqvae did not build the bf16 run's bf16 model")
    del loaded
    for c in counters.values():
        c.launches = 0
    with cli_env(f"{work}/pmvq_bf16_stream", data):
        _, lines, ewall = run_cli("eval_pm_vqvae (bf16 run)", eval_pm_vqvae.main, [
            "--run_dir", run_dir, "--dataset", "celeb_a", "--mask_generator",
            "CelebAMaskGenerator", "--num_instances", str(BATCH), "--batch_size", str(BATCH),
            "--num_samples", "2", "--num_trials", "1"])
    launched = {k: c.launches for k, c in counters.items() if c.launches}
    check(launched == {"sampler_vrow": rows, "sampler_row": rows},
          f"eval_pm_vqvae on the bf16 run launched {launched}")
    res = imputation_results_check(run_dir, BATCH, 2, "eval_pm_vqvae bf16")
    seconds = time.perf_counter() - t0
    log(f"eval_pm_vqvae on the bf16 run: {ewall:.1f} s, PSNR {res['psnr_mean']:.3f}; phase 20 "
        f"kernels {kernel_s:.1f} s, CLIs {seconds - kernel_s:.1f} s")

    # the kernels-line entries: ms at 128 filters (the main path's width),
    # the 64-filter build's beside
    lines = []
    for kind, fl, bl in GATED_KINDS:
        run = "stream" if kind == "stream" else ("1" if kind == "pair" else str(SEGMENT))
        for fb, line in (("fwd", fl), ("bwd", bl)):
            r = results[128][kind][fb]
            b_ms, b_by = bound_bf16(r[3], 0.0, r[4])
            src = f"gated_stream_{fb}.cu" if kind == "stream" else f"gated_levels_{fb}.cu"
            lines.append({
                "name": f"gated_{kind}_{fb}_bf16", "route": "cuda",
                "source": f"posterior_matching_torch/ops/csrc/{src}",
                "replaces": f"posterior_matching_tpu/ops/gated_chain.py:{line}",
                "launches": out[run]["launches"][f"gated_{kind}_{fb}_bf16"],
                "launches_per_step": out[run]["launches"][f"gated_{kind}_{fb}_bf16"] / steps,
                "max_abs_err": max(results[w][kind][fb][0] for w in results),
                "ms": r[1], "plain_ms": r[2], "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None, "f32_ms": r[5], "design": GATED_BF16_DESIGN,
                "per_shape": {str(w): {
                    "levels": results[w][kind]["levels"], "ms": results[w][kind][fb][1],
                    "f32_ms": results[w][kind][fb][5], "plain_ms": results[w][kind][fb][2],
                    "bound_ms": bound_bf16(results[w][kind][fb][3], 0.0,
                                           results[w][kind][fb][4])[0],
                    "gflop": results[w][kind][fb][3] / 1e9, "mb": results[w][kind][fb][4] / 1e6,
                    "err_max_mean": (results[w][kind]["fwd_err"] if fb == "fwd" else
                                     results[w][kind]["bwd_err"][1:]),
                    "save_flips": results[w][kind]["save_flips"],
                    "bf16_vs_f32": results[w][kind]["bf16_vs_f32"]} for w in results},
            })
    for line in lines:
        log(f"{line['name']}: {line['ms']:.4f} ms per launch in bf16 against "
            f"{line['f32_ms']:.4f} in float32 at 128 filters (64: "
            f"{line['per_shape']['64']['ms']:.4f} against {line['per_shape']['64']['f32_ms']:.4f}"
            f"); plain bf16 {line['plain_ms']:.3f}, bound {line['bound_ms']:.4f} by "
            f"{line['bound_by']}; {line['launches']} launches in its CLI run")
    return lines, {"seconds": seconds, "kernel_s": kernel_s, "runs": out,
                   "f32_val_loss": f32_val, "eval_wall_s": ewall, "eval_psnr": res["psnr_mean"],
                   "checks": {str(w): {k: (v if k in ("codes_kept", "first_step_loss") else
                                           {kk: vv for kk, vv in v.items()
                                            if kk not in ("fwd", "bwd")})
                                       for k, v in per.items()} for w, per in results.items()}}


# ---------------------------------------------------------------------------
# Phase 21: the samplers' bf16 builds, PM_TPU_SAMPLER=rowkernel, the naive
# raster sampler
# ---------------------------------------------------------------------------

SAMPLER_BF16_DESIGN = {
    "vrow": "as sampler_vrow (12 warps, 3 x 32 KB cp.async.bulk ring refilled by the last "
            "warp done), bf16 weights unpacked in registers: a stage carries 128 F-wide "
            "rows, 32 K rows a warp; operands rounded to bf16 into float shared memory; "
            "float32 FMA sums; the carry float32 in registers, outputs stored bf16",
    "row": "as sampler_row (8 consumer warps + 1 producer warp a block of 8 samples, "
           "2 x 64 KB cp.async.bulk ring), bf16 weights unpacked in registers: a stage "
           "carries 256 F-wide rows (part stages where a matrix is not whole ones), 32 K "
           "rows a group; operands rounded to bf16 as gathered; float32 FMA sums; the "
           "chain rounded at the pixel's start and every lpg levels, outh/outm stored bf16",
}


def sampler_bf16_kernels(name, pcnn, cond, gen):
    """(a) at one shape: both bf16 builds against their plain bf16 versions
    at a request's image row 1 (row 0 through the plain bf16 versions),
    with ``sampler_chain.bf16_gate_ok``, each relaunched bit for bit, then
    timed with CUDA events beside its float32 build on the same row (in
    turns: float32, bf16, bf16, float32) and beside the plain bf16 version.
    Returns each kernel's numbers."""
    from posterior_matching_torch.ops import sampler_chain as sc
    from posterior_matching_torch.ops.profiling import time_ms

    n = cond.shape[0]
    f, n_lvl, k_idx = pcnn.num_filters, 2 * pcnn.num_resnet, pcnn.num_indices
    wid = pcnn.image_shape[1]
    lpg = sc.levels_per_group(n_lvl)
    out = {}
    with torch.no_grad():
        vin, rin = sc.row1_inputs(pcnn, cond, n, gen, "bfloat16", lpg)
        vin32, rin32 = sc.row1_inputs(pcnn, cond, n, gen, "float32")
        got_v = [sc.vrow_bf16(*vin) for _ in range(2)]
        got_r = [sc.row_bf16(*rin, with_logits=True, lpg=lpg) for _ in range(2)]
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip((*got_v[0], *got_r[0]),
                                                     (*got_v[1], *got_r[1]))),
              f"{name}: a sampler bf16 build differs from launch to launch")
        want_v = sc.vrow_plain(*vin, compute_dtype="bfloat16")
        want_r = sc.row_plain(*rin, with_logits=True, compute_dtype="bfloat16", lpg=lpg)
        reports = {"vrow": sc.vrow_bf16_report(got_v[0], want_v),
                   "row": sc.row_bf16_report(got_r[0], want_r, rin[10], lpg)}
        for kind, rep in reports.items():
            log(f"{name} {kind} bf16 (lpg {lpg}): {rep}")
            check(sc.bf16_gate_ok(rep), f"{name}: the {kind} bf16 build fails its gate: {rep}")
        calls = {"vrow": (lambda: sc.vrow_bf16(*vin), lambda: sc.vrow(*vin32),
                          lambda: sc.vrow_plain(*vin, compute_dtype="bfloat16")),
                 "row": (lambda: sc.row_bf16(*rin, lpg=lpg), lambda: sc.row(*rin32),
                         lambda: sc.row_plain(*rin, compute_dtype="bfloat16", lpg=lpg))}
        for kind, (bf16_call, f32_call, plain_call) in calls.items():
            f32a, bfa, bfb, f32b = (time_ms(fn, reps=10) for fn in
                                    (f32_call, bf16_call, bf16_call, f32_call))
            out[kind] = {"ms": (bfa + bfb) / 2, "f32_ms": (f32a + f32b) / 2,
                         "plain_ms": time_ms(plain_call, reps=2), **reports[kind]}
    flops = {"vrow": 2 * wid * n * (9 * f * f + n_lvl * 36 * f * f + n_lvl // 2 * 2 * f * f),
             "row": 2 * n * wid * (2 * f * f + n_lvl * 28 * f * f + f * k_idx)}
    byts = {"vrow": nbytes(*vin, *want_v), "row": nbytes(*rin, *want_r[:3])}
    for kind, d in out.items():
        d["bound_ms"], d["bound_by"] = bound(flops[kind], byts[kind], PEAK_BF16_FLOPS)
        d["gflop"], d["mb"] = flops[kind] / 1e9, byts[kind] / 1e6
        log(f"{name} {kind}: bf16 {d['ms']:.4f} ms a launch against float32 {d['f32_ms']:.4f} "
            f"({d['ms'] / d['f32_ms']:.3f}x); plain bf16 {d['plain_ms']:.2f}; bound "
            f"{d['bound_ms']:.4f} ms by {d['bound_by']} ({d['gflop']:.1f} GFLOP at the bf16 "
            f"rate, {d['mb']:.1f} MB), {d['ms'] / d['bound_ms']:.1f}x it")
    return out


def sampler_bf16_request(model, gen, counters):
    """(b) one CelebA request (BATCH x NUM_SAMPLES) through ``pm_vqvae_impute``
    with ``sampler_dtype`` float32 and bfloat16 in turns (float32, bf16,
    bf16, float32; each counter set to 0 before each and read after: the
    float32 request launches only the float32 builds, the bf16 one only the
    bf16 builds, one each an image row); then the request's codes in each
    dtype from the same draws, and the share of them that agree. Returns
    imgs/s of each and the bf16 request's launches."""
    from posterior_matching_torch import config, masking
    from posterior_matching_torch.models.pm_vqvae import pm_vqvae_impute
    from posterior_matching_torch.ops import sampler_chain as sc

    rows = model.pixel_cnn.image_shape[0]
    mask_fn = masking.get_mask_generator("CelebAMaskGenerator", device=DEVICE)
    x = torch.rand((BATCH, *config.CELEB_A_IMAGE_SHAPE), generator=gen, device=DEVICE)
    b = masking.add_mask({"image": x}, gen, mask_fn)["mask"]
    spans, psnr, launched = {"float32": [], "bfloat16": []}, {}, {}
    for dtype in ("float32", "bfloat16", "bfloat16", "float32"):
        for c in counters.values():
            c.launches = 0
        draws = torch.Generator(device=DEVICE).manual_seed(7)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imp = pm_vqvae_impute(model, x, b, NUM_SAMPLES, generator=draws, sampler_dtype=dtype)
        torch.cuda.synchronize()
        spans[dtype].append(time.perf_counter() - t0)
        suffix = "_bf16" if dtype == "bfloat16" else ""
        expected = dict.fromkeys(counters, 0)
        expected.update({f"sampler_vrow{suffix}": rows, f"sampler_row{suffix}": rows})
        launched[dtype] = {k: c.launches for k, c in counters.items()}
        check(launched[dtype] == expected,
              f"a {dtype} request launched {launched[dtype]}, not {expected}")
        check(bool(torch.isfinite(imp).all()) and imp.min() >= 0 and imp.max() <= 1,
              f"the {dtype} request's imputations are not finite values in [0, 1]")
        observed = (b != 0).expand_as(x)
        check(torch.equal(imp[:, 0][observed], x[observed]),
              f"the {dtype} request did not copy the observed pixels through")
        psnr[dtype] = (-10.0 * torch.log10(((imp.mean(1) - x) ** 2).mean((1, 2, 3)))).mean().item()
    with torch.no_grad():
        cond = model.conditional_latents(x, b)
        codes = {dtype: sc.pixelcnn_sample(model.pixel_cnn, NUM_SAMPLES, cond,
                                           generator=torch.Generator(device=DEVICE).manual_seed(7),
                                           compute_dtype=dtype)
                 for dtype in ("float32", "bfloat16")}
    agree = (codes["float32"] == codes["bfloat16"]).float().mean().item()
    rate = {k: BATCH * len(v) / sum(v) for k, v in spans.items()}
    log(f"request ({BATCH} x {NUM_SAMPLES}): float32 {rate['float32']:.3f} imgs/s, bf16 "
        f"{rate['bfloat16']:.3f} imgs/s ({rate['bfloat16'] / rate['float32']:.3f}x; "
        f"seconds {spans}); PSNR float32 {psnr['float32']:.3f}, bf16 {psnr['bfloat16']:.3f} "
        f"dB; the bf16 request launched {nonzero(launched['bfloat16'])}; its codes equal "
        f"float32's at {agree:.4f} of {codes['float32'].numel()} positions")
    return {"imgs_per_s": rate, "request_s": spans, "psnr": psnr, "codes_agree": agree,
            "launches": nonzero(launched["bfloat16"])}


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def sampler_bf16_eval(celeb_a, work, counters):
    """(c) ``eval_pm_vqvae`` on phase 12's run (its 64 test images, 10
    samples, one trial, the CLI's seed) without and then with
    ``PM_TPU_SAMPLER=rowkernel``: the first launches only the float32
    sampler builds, the second only the bf16 ones; each one's PSNR."""
    from posterior_matching_torch import config, eval_pm_vqvae

    run2, data = celeb_a["train_pm_vqvae"]["run_dir"], f"{work}/celeb_a/data"
    n_eval = 2 * BATCH
    rows = config.CONFIGS["pm_vqvae_celeb_a"]()["pixel_cnn"]["image_shape"][0]
    out = {}
    for sampler, suffix in (("fast", ""), ("rowkernel", "_bf16")):
        cwd = f"{work}/sampler_bf16_eval_{sampler}"
        os.makedirs(cwd)
        for c in counters.values():
            c.launches = 0
        old = os.environ.get("PM_TPU_SAMPLER")
        os.environ["PM_TPU_SAMPLER"] = sampler
        try:
            with cli_env(cwd, data):
                _, lines, wall = run_cli(f"eval_pm_vqvae PM_TPU_SAMPLER={sampler}",
                                         eval_pm_vqvae.main, [
                                             "--run_dir", run2, "--dataset", "celeb_a",
                                             "--mask_generator", "CelebAMaskGenerator",
                                             "--num_instances", str(n_eval), "--batch_size",
                                             str(BATCH), "--num_samples", str(NUM_SAMPLES),
                                             "--num_trials", "1"])
        finally:
            if old is None:
                os.environ.pop("PM_TPU_SAMPLER", None)
            else:
                os.environ["PM_TPU_SAMPLER"] = old
        expected = dict.fromkeys(counters, 0)
        expected.update({f"sampler_vrow{suffix}": n_eval // BATCH * rows,
                         f"sampler_row{suffix}": n_eval // BATCH * rows})
        launched = {k: c.launches for k, c in counters.items()}
        check(launched == expected, f"eval_pm_vqvae PM_TPU_SAMPLER={sampler} launched "
                                    f"{launched}, not {expected}")
        with open(f"{run2}/imputation_results/eval_summary.json") as fp:
            psnr = json.load(fp)["psnr_mean"]
        check(np.isfinite(psnr), f"eval_pm_vqvae PM_TPU_SAMPLER={sampler}: PSNR {psnr}")
        out[sampler] = {"psnr": psnr, "wall_s": wall, "wall_split": wall_split(lines),
                        "launches": nonzero(launched)}
    log(f"eval_pm_vqvae on phase 12's run (the CLI's seed): PSNR {out['fast']['psnr']:.4f} "
        f"with the float32 sampler, {out['rowkernel']['psnr']:.4f} under "
        f"PM_TPU_SAMPLER=rowkernel (bf16); requests {out['fast']['wall_split']['requests']:.3f}"
        f" s against {out['rowkernel']['wall_split']['requests']:.3f} s")
    return out


def naive_sampler_check(gen, counters):
    """(d) the topologies the row kernels do not take: a toy PM-VQVAE whose
    PixelCNN has two hierarchies and the (5, 5) receptive field imputes
    through the naive sampler (with JAX's warning) on the card and on the
    CPU with the same noise, and an unconditional PixelCNN of that topology
    samples so: equal codes, imputations within 1e-4, no kernel launched."""
    import warnings

    from posterior_matching_torch import convert
    from posterior_matching_torch.models.pixelcnn import (
        PixelCNN, gumbel_noise, pixelcnn_sample_naive,
    )
    from posterior_matching_torch.models.pm_vqvae import pm_vqvae_impute

    vq_cfg = {"output_channels": 3, "embedding_dim": 8, "num_embeddings": 16,
              "hidden_units": 8, "residual_blocks": 1, "residual_hidden_units": 4,
              "decay": 0.99, "use_ema": True, "commitment_cost": 0.25}
    pc_cfg = {"image_shape": [4, 4], "num_resnet": 1, "num_hierarchies": 2, "num_filters": 8,
              "dropout": 0.0, "num_indices": 16, "receptive_field_dims": [5, 5]}
    cd, s = 6, 2
    tree = convert.random_pm_vqvae_tree(cd, vq_cfg, pc_cfg, seed=3)
    models = {dev: convert.pm_vqvae_from_jax(*tree, cd, vq_cfg, pc_cfg, device=dev)
              for dev in (DEVICE, "cpu")}
    x = torch.rand(2, 16, 16, 3, generator=gen, device=DEVICE)
    b = (torch.rand(2, 16, 16, 1, generator=gen, device=DEVICE) > 0.5).float()
    noise = gumbel_noise((4, 4, 2 * s, 16), gen, DEVICE)
    for c in counters.values():
        c.launches = 0
    imps, codes = {}, {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for dev, m in models.items():
            xd, bd, nd = x.to(dev), b.to(dev), noise.to(dev)
            imps[dev] = pm_vqvae_impute(m, xd, bd, s, noise=nd).cpu()
            with torch.no_grad():
                cond = m.conditional_latents(xd, bd)
            codes[dev] = pixelcnn_sample_naive(m.pixel_cnn, s, cond,
                                               noise=nd.reshape(16, 2 * s, 16)).cpu()
    check(sum("naive full-forward raster sampler" in str(w.message) for w in caught)
          == len(models), "pm_vqvae_impute did not warn of the naive sampler on each device")
    torch.manual_seed(3)
    uncond = PixelCNN(num_indices=16, image_shape=(4, 4), dropout=0.0, num_resnet=1,
                      num_hierarchies=2, num_filters=8, receptive_field_dims=(5, 5))
    un_noise = gumbel_noise((16, 3, 16), gen, DEVICE)
    un = {"cpu": pixelcnn_sample_naive(uncond, 3, noise=un_noise.cpu())}
    un[DEVICE] = pixelcnn_sample_naive(uncond.to(DEVICE), 3, noise=un_noise).cpu()
    launched = {k: c.launches for k, c in counters.items() if c.launches}
    err = (imps[DEVICE] - imps["cpu"]).abs().max().item()
    log(f"naive sampler (2 hierarchies, (5, 5) field): codes equal on the card and the CPU "
        f"{torch.equal(codes[DEVICE], codes['cpu'])}, imputations max abs err {err:.3e}; "
        f"unconditional codes equal {torch.equal(un[DEVICE], un['cpu'])}; kernel launches "
        f"{launched}")
    check(torch.equal(codes[DEVICE], codes["cpu"]) and torch.equal(un[DEVICE], un["cpu"])
          and err <= 1e-4 and not launched,
          "the naive sampler on the card disagrees with the CPU")
    return {"imputation_max_abs_err": err, "codes_equal": True}


def sampler_bf16_phase(args, gen, model, celeb_a, work):
    """Phase 21: the samplers' bf16 builds (rows 1-2 of PERF.md's table) and
    the imputation's other sampler branches: (a) both bf16 builds at
    CelebA's shapes (n 320, W 16, F 128, L 24, K 512) and digits16's (n
    320, W 4, F 64, L 12, K 128); (b) a CelebA request in bf16 beside
    float32; (c) ``eval_pm_vqvae`` under ``PM_TPU_SAMPLER=rowkernel`` on
    phase 12's run; (d) the naive sampler. Returns the JSON lines of the two
    bf16 builds and the phase's numbers."""
    from posterior_matching_torch import config, convert, masking
    from posterior_matching_torch.ops import sampler_chain as sc

    t0 = time.perf_counter()
    counters = {**all_kernel_counters(), "sampler_vrow_bf16": sc.vrow_bf16,
                "sampler_row_bf16": sc.row_bf16}
    shapes = {}
    for name, (vq_cfg, pm) in {
            "celeb_a": (config.VQVAE_CELEB_A, config.CONFIGS["pm_vqvae_celeb_a"]()),
            "digits16": (config.CONFIGS["vqvae_digits16"]()["model"],
                         config.CONFIGS["pm_vqvae_digits16"]())}.items():
        pc_cfg = {**pm["pixel_cnn"], "num_indices": vq_cfg["num_embeddings"]}
        cd = pm["conditional_dim"]
        m = convert.pm_vqvae_from_jax(*convert.random_pm_vqvae_tree(cd, vq_cfg, pc_cfg,
                                                                    seed=args.seed),
                                      cd, vq_cfg, pc_cfg, device=DEVICE)
        shape = (BATCH, *(config.CELEB_A_IMAGE_SHAPE if name == "celeb_a" else DIGITS16_IMAGE))
        mask_fn = masking.get_mask_generator(pm["data"]["mask_generator"], device=DEVICE)
        batch = masking.add_mask({"image": torch.rand(shape, generator=gen, device=DEVICE)},
                                 gen, mask_fn)
        with torch.no_grad():
            cond = m.conditional_latents(batch["image"], batch["mask"])
            cond = cond[None].expand(NUM_SAMPLES, *cond.shape).reshape(BATCH * NUM_SAMPLES, -1)
        shapes[name] = sampler_bf16_kernels(name, m.pixel_cnn, cond.contiguous(), gen)
        del m
    kernel_s = time.perf_counter() - t0
    request = sampler_bf16_request(model, gen, counters)
    ev = sampler_bf16_eval(celeb_a, work, counters)
    naive = naive_sampler_check(gen, counters)
    lines = []
    for kind, replaces in (("vrow", 124), ("row", 215)):
        d = shapes["celeb_a"][kind]
        lines.append({
            "name": f"sampler_{kind}_bf16", "route": "cuda",
            "source": f"posterior_matching_torch/ops/csrc/sampler_{kind}.cu",
            "replaces": f"posterior_matching_tpu/ops/sampler_chain.py:{replaces}",
            "launches": request["launches"][f"sampler_{kind}_bf16"],
            "max_abs_err": d["abs_err"], "ms": d["ms"], "plain_ms": d["plain_ms"],
            "bound_ms": d["bound_ms"], "bound_by": d["bound_by"], "library_ms": None,
            "f32_ms": d["f32_ms"], "design": SAMPLER_BF16_DESIGN[kind],
            "per_shape": {n: {k: v for k, v in shapes[n][kind].items()} for n in shapes},
        })
    return lines, {"seconds": time.perf_counter() - t0, "kernel_s": kernel_s,
                   "shapes": shapes, "request": request, "eval": ev, "naive": naive}


# ---------------------------------------------------------------------------
# Phase 22: use_ema=False, packed_chain, steps_per_call, device_resident_data,
# the last mask generators
# ---------------------------------------------------------------------------

OPTIONS_STEPS = 4          # steps of each stage-2 and PM-VAE run of phase 22
PACKED_TOL = 1e-6          # packed vs canonical weights, of each tensor's scale
MASK_DRAWS = 400           # batch_level / update_freq calls of (d)
MASK_N = 2048              # masks a mixture draws on each device in (d)


@contextlib.contextmanager
def level_packing_counter():
    """Counts the calls of ``pack_level`` and ``stack_levels`` from the
    PixelCNN's chain while it is held: ``{"pack_level", "stack_levels"}``."""
    from posterior_matching_torch.models import pixelcnn

    seen = {"pack_level": 0, "stack_levels": 0}
    kept = {name: getattr(pixelcnn, name) for name in seen}

    def counting(name):
        def call(*a, **kw):
            seen[name] += 1
            return kept[name](*a, **kw)
        return call

    for name in seen:
        setattr(pixelcnn, name, counting(name))
    try:
        yield seen
    finally:
        for name, fn in kept.items():
            setattr(pixelcnn, name, fn)


def options_cli(label, main, argv, cwd, data, counters):
    """A training CLI in this process in ``cwd/label`` on ``data`` (every
    kernel counter set to 0 just before, read just after; each step waited
    for and timed; the PixelCNN's level packing counted), then one more
    step profiled: its run directory, launches, spans, the logged
    ``steps_per_sec`` and losses, and the profiled step's CUDA kernel
    launches."""
    os.makedirs(f"{cwd}/{label}")
    for c in counters.values():
        c.launches = 0
    with cli_env(f"{cwd}/{label}", data), step_clock() as clock, \
            level_packing_counter() as packing:
        _, lines, wall = run_cli(label, main, argv)
    launched = {k: c.launches for k, c in counters.items() if c.launches}
    (run_dir,) = glob.glob(f"{cwd}/{label}/runs/*")
    windows = [ln for ln in lines if ln.startswith("[step ")]
    losses = [line_value(ln, "loss") for ln in windows]
    rate = [line_value(ln, "steps_per_sec") for ln in windows]
    spans = clock["spans"]
    prof = profile_step(clock["trainer"], clock["batch"], VQVAE_GROUPS)
    out = {"run_dir": run_dir, "wall_s": wall, "launches": launched, "packing": dict(packing),
           "steps": len(spans), "step_ms": [s * 1e3 for s in spans], "losses": losses,
           "steps_per_sec_logged": rate,
           "launches_per_step": None if prof is None else prof["kernel_launches"],
           "idle_share": None if prof is None else prof["idle_share"]}
    log(f"{label}: {len(spans)} steps, step ms {[round(s * 1e3, 2) for s in spans]}, logged "
        f"steps/s {rate}, losses {losses}; kernels {launched}; pack_level / stack_levels "
        f"calls {packing}; {out['launches_per_step']} CUDA kernel launches in a profiled "
        f"step | {nvidia_smi_line()}")
    check(all(np.isfinite(losses)) and losses, f"{label}: losses {losses}")
    return out


def arrays_apart(a_dir, b_dir, prefix="params/"):
    """The worst difference of the ``prefix`` arrays of two run directories'
    checkpoints, of each array's scale, and whether all are equal bit for
    bit."""
    a, b = checkpoint_arrays(a_dir), checkpoint_arrays(b_dir)
    keys = sorted(k for k in a if k.startswith(prefix))
    check(keys and set(keys) == {k for k in b if k.startswith(prefix)},
          f"the checkpoints hold other {prefix} arrays")
    worst = max(float(np.abs(a[k].astype(np.float64) - b[k]).max()
                      / max(float(np.abs(b[k]).max()), 1e-30)) for k in keys)
    return worst, all(np.array_equal(a[k], b[k]) for k in keys)


def same_checkpoints(a_dir, b_dir, what):
    """Every array of the two checkpoints equal bit for bit."""
    a, b = checkpoint_arrays(a_dir), checkpoint_arrays(b_dir)
    differ = sorted(k for k in a if k not in b or not np.array_equal(a[k], b[k]))
    check(set(a) == set(b) and not differ, f"{what}: {len(differ)} arrays differ, "
                                           f"{differ[:3]}")
    log(f"{what}: {len(a)} arrays bit for bit equal")


def mask_distribution_check(seed):
    """(d): the Omniglot and CIFAR-10 mixtures drawn on the card and on the
    CPU (MASK_N masks each): mean hidden share within 5 sigma of the
    difference, each fixed half-image rectangle's share within 5 binomial
    sigma of the other device's; ``batch_level`` on the card (MASK_DRAWS
    batches of two extreme components at weights 0.3 / 0.7): every batch
    one component, the share within 4 sigma of 0.3; ``update_freq``'s pool
    on the card (3 canvases of 64 cropped whole): each canvas drawn within
    4 sigma of 1/3, the pool's canvases the CPU's."""
    from posterior_matching_torch import masking

    out = {}
    for name, dim in (("OmniglotMaskGenerator", 28), ("Cifar10MaskGenerator", 32)):
        draws = {}
        for dev in (DEVICE, "cpu"):
            fn = masking.get_mask_generator(name, dev)
            m = fn(torch.Generator(device=dev).manual_seed(seed), (MASK_N, dim, dim, 1))
            draws[dev] = m[..., 0].cpu().numpy()
        half = dim // 2
        shares = {}
        for dev, m in draws.items():
            hidden = 1 - m.mean((1, 2))
            rects = []
            for y1, x1, y2, x2 in ((0, 0, dim, half), (0, 0, half, dim), (0, half, dim, dim),
                                   (half, 0, dim, dim)):
                r = np.ones((dim, dim), np.float32)
                r[y1:y2, x1:x2] = 0
                rects.append(float((m == r).all((1, 2)).mean()))
            shares[dev] = (hidden, rects)
        (hg, rg), (hc, rc) = shares[DEVICE], shares["cpu"]
        sigma = np.sqrt(hg.var() / MASK_N + hc.var() / MASK_N)
        check(abs(hg.mean() - hc.mean()) < 5 * sigma,
              f"{name}: hidden share {hg.mean():.4f} on the card, {hc.mean():.4f} on the CPU")
        for g, c in zip(rg, rc):
            s = np.sqrt(0.1 * 0.9 / MASK_N * 2)
            check(abs(g - c) < 5 * s, f"{name}: a half rectangle's share {g} vs {c}")
        out[name] = {"hidden_card": float(hg.mean()), "hidden_cpu": float(hc.mean()),
                     "halves_card": rg, "halves_cpu": rc}
        log(f"{name}: hidden share {hg.mean():.4f} on the card, {hc.mean():.4f} on the CPU; "
            f"half-rectangle shares {np.round(rg, 4).tolist()} vs {np.round(rc, 4).tolist()}")

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    ones = lambda g, s: torch.ones(tuple(s), device=DEVICE)
    zeros = lambda g, s: torch.zeros(tuple(s), device=DEVICE)
    means = torch.stack([masking.mixture_mask(gen, (16, 4, 4, 1), [ones, zeros], [0.3, 0.7],
                                              batch_level=True).mean()
                         for _ in range(MASK_DRAWS)]).cpu().numpy()
    check(set(np.unique(means)) <= {0.0, 1.0}, "batch_level mixed components in a batch")
    sigma = np.sqrt(0.3 * 0.7 / MASK_DRAWS)
    check(abs(means.mean() - 0.3) < 4 * sigma, f"batch_level's share {means.mean()}")
    size, pool = 64, 3
    fn = masking.pattern_mask(DEVICE, canvas_size=size, update_freq=1.0, num_canvases=pool)
    canvases = [torch.from_numpy(masking.pattern_canvas(size, 0.06, 0.25, i)[0]).to(DEVICE)
                for i in range(pool)]
    check(all(torch.equal(fn.keywords["canvas"][i], canvases[i]) for i in range(pool)),
          "the card's pool holds other canvases than the CPU builds")
    picks = torch.stack([fn(gen, (1, size, size, 1))[0, ..., 0] for _ in range(MASK_DRAWS)])
    hits = torch.stack([(picks == 1 - c.float()).all(-1).all(-1) for c in canvases], 1)
    check(bool((hits.sum(1) == 1).all()), "an update_freq crop is no canvas of the pool")
    counts = hits.sum(0).cpu().numpy() / MASK_DRAWS
    sigma = np.sqrt((1 / pool) * (1 - 1 / pool) / MASK_DRAWS)
    check(bool(np.all(np.abs(counts - 1 / pool) < 4 * sigma)), f"update_freq's draws {counts}")
    log(f"batch_level: {MASK_DRAWS} batches, share {means.mean():.4f} (weight 0.3); "
        f"update_freq: canvas shares {np.round(counts, 4).tolist()} of {pool}")
    out.update(batch_level_share=float(means.mean()), update_freq_shares=counts.tolist())
    return out


def options_phase(args, celeb_a, work):
    """Phase 22, the modules ported last, on phase 12's CelebA files and
    stage-1 run, each CLI with every kernel counter set to 0 just before it
    and read just after:

    (a) ``train_vqvae --config vqvae_celeb_a --config.model.use_ema False``
        (4 steps): the codebook search's launches, the codebook a parameter
        that moved; ``train_pm_vqvae`` 2 steps on that run, ``eval_pm_vqvae``
        on 32 images, 1 trial;
    (b) ``train_pm_vqvae --config pm_vqvae_celeb_a`` 4 steps packed (the
        default on the card) and with ``--config.packed_chain False`` from
        one seed: the stream builds only, no level packed or stacked in the
        packed run, the weights within PACKED_TOL of scale, each run's CUDA
        kernel launches a step and step ms; a packed run to step 2 resumed
        to 4 equals the straight one bit for bit; packed and not again in
        bf16;
    (c) ``steps_per_call`` 4 against 1 on that CLI and on ``train_pm_vae
        --config pm_vae_gas``, bit for bit; with ``device_resident_data``
        too, finite losses; the logged steps/s;
    (d) :func:`mask_distribution_check`."""
    from posterior_matching_torch import (
        config,
        eval_pm_vqvae,
        train_pm_vae,
        train_pm_vqvae,
        train_vqvae,
    )
    from posterior_matching_torch.convert import init_vqvae_tree

    t0 = time.perf_counter()
    data, vqvae_dir = f"{work}/celeb_a/data", celeb_a["train_vqvae"]["run_dir"]
    counters = {**all_kernel_counters(), **bf16_counters(), **gated_bf16_counters()}
    os.makedirs(f"{work}/options/no_data")   # the PM-VAE runs read the stand-in
    stage1 = config.CONFIGS["vqvae_celeb_a"]()
    stage2 = config.CONFIGS["pm_vqvae_celeb_a"]()
    n, rows = stage2["pixel_cnn"]["num_resnet"], stage2["pixel_cnn"]["image_shape"][0]
    n_val1 = 64 // stage1["data"]["val_batch_size"]
    n_val2 = 64 // stage2["data"]["val_batch_size"]
    steps, seed = OPTIONS_STEPS, str(args.seed)
    out = {}

    # ---- (a) use_ema=False ---------------------------------------------------
    cwd = f"{work}/options"
    common = ["--config.seed", seed]
    a = options_cli("train_vqvae use_ema=False", train_vqvae.main, [
        "--config", "vqvae_celeb_a", "--config.steps", str(steps), "--config.validation_freq",
        str(steps), "--config.model.use_ema", "False", *common], cwd, data, counters)
    check(a["launches"] == {"vq_search": steps + n_val1 + 1},
          f"train_vqvae use_ema=False launched {a['launches']}")
    ts = checkpoint_arrays(a["run_dir"])
    start = init_vqvae_tree({**stage1["model"], "use_ema": False}, args.seed)[0]
    moved = float(np.abs(ts["params/vq/embeddings"] - start["vq"]["embeddings"]).max())
    check(not any(k.startswith("state/") for k in ts) and moved > 0,
          f"the codebook is not a parameter that moved ({moved})")
    a2 = options_cli("train_pm_vqvae on the use_ema=False run", train_pm_vqvae.main, [
        "--config", "pm_vqvae_celeb_a", "--config.steps", "2", "--config.validation_freq", "2",
        "--config.vqvae_dir", a["run_dir"], *common], cwd, data, counters)
    check(a2["launches"] == {"vq_search": 2 + n_val2, "gated_stream_fwd": 2 * (2 + n_val2),
                             "gated_stream_bwd": 2 * 2, "sampler_vrow": rows,
                             "sampler_row": rows}, f"launched {a2['launches']}")
    for c in counters.values():
        c.launches = 0
    with cli_env(cwd, data):
        run_cli("eval_pm_vqvae on the use_ema=False pipeline", eval_pm_vqvae.main, [
            "--run_dir", a2["run_dir"], "--dataset", "celeb_a", "--mask_generator",
            "CelebAMaskGenerator", "--num_instances", str(BATCH), "--batch_size", str(BATCH),
            "--num_samples", "2", "--num_trials", "1"])
    launched = {k: c.launches for k, c in counters.items() if c.launches}
    check(launched == {"sampler_vrow": rows, "sampler_row": rows},
          f"eval_pm_vqvae launched {launched}")
    res = imputation_results_check(a2["run_dir"], BATCH, 2, "eval_pm_vqvae use_ema=False")
    out["use_ema_false"] = {"train_vqvae": a, "codebook_moved": moved, "train_pm_vqvae": a2,
                            "eval_psnr": res["psnr_mean"]}
    log(f"(a) use_ema=False: the codebook moved by up to {moved:.3e}; the pipeline's PSNR "
        f"{res['psnr_mean']:.3f} on {BATCH} images")

    # ---- (b) packed_chain ------------------------------------------------------
    # one validation, at the last step, in every 4-step run
    base = ["--config", "pm_vqvae_celeb_a", "--config.vqvae_dir", vqvae_dir, *common]
    per_step = {"vq_search": steps + n_val2, "gated_stream_fwd": 2 * (steps + n_val2),
                "gated_stream_bwd": 2 * steps, "sampler_vrow": rows, "sampler_row": rows}
    run = lambda label, extra, dtype=(): options_cli(
        label, train_pm_vqvae.main, [*base, "--config.steps", str(steps),
                                     "--config.validation_freq", str(steps), *dtype, *extra],
        cwd, data, counters)
    b = {"packed": run("train_pm_vqvae packed", []),
         "unpacked": run("train_pm_vqvae packed_chain=False",
                         ["--config.packed_chain", "False"])}
    for label, r in b.items():
        check(r["launches"] == per_step, f"{label} launched {r['launches']}, not {per_step}")
    check(b["packed"]["packing"] == {"pack_level": 0, "stack_levels": 0}
          and b["unpacked"]["packing"]["pack_level"] > 0,
          f"level packing: {b['packed']['packing']} packed, {b['unpacked']['packing']} not")
    worst, bits = arrays_apart(b["packed"]["run_dir"], b["unpacked"]["run_dir"])
    check(worst <= PACKED_TOL, f"packed vs canonical weights {worst:.3e} of scale apart")
    b["weights_apart"], b["weights_bit_equal"] = worst, bits
    log(f"(b) packed vs canonical after {steps} steps: weights {worst:.3e} of scale apart "
        f"({'bit for bit equal' if bits else 'not bit for bit'}); launches a profiled step "
        f"{b['packed']['launches_per_step']} packed, {b['unpacked']['launches_per_step']} not")
    short = options_cli("train_pm_vqvae packed to step 2", train_pm_vqvae.main, [
        *base, "--config.steps", "2", "--config.validation_freq", "2"], cwd, data, counters)
    resumed = options_cli("train_pm_vqvae packed resumed to step 4", train_pm_vqvae.main, [
        "--config", "pm_vqvae_celeb_a", "--config.vqvae_dir", vqvae_dir, "--config.steps",
        str(steps), "--config.validation_freq", str(steps), "--resume_dir", short["run_dir"]],
        cwd, data, counters)
    same_checkpoints(b["packed"]["run_dir"], resumed["run_dir"],
                     "(b) the packed run resumed at step 2 against the straight one")
    b["resumed"] = resumed
    bf16 = ["--config.compute_dtype", "bfloat16"]
    per_step16 = {("gated_stream_fwd_bf16" if k == "gated_stream_fwd" else
                   "gated_stream_bwd_bf16" if k == "gated_stream_bwd" else k): v
                  for k, v in per_step.items()}
    b16 = {"packed": run("train_pm_vqvae bf16 packed", [], bf16),
           "unpacked": run("train_pm_vqvae bf16 packed_chain=False",
                           ["--config.packed_chain", "False"], bf16)}
    for label, r in b16.items():
        check(r["launches"] == per_step16, f"bf16 {label} launched {r['launches']}")
    worst16, bits16 = arrays_apart(b16["packed"]["run_dir"], b16["unpacked"]["run_dir"])
    check(worst16 <= PACKED_TOL, f"bf16 packed vs canonical: {worst16:.3e} of scale apart")
    b16["weights_apart"], b16["weights_bit_equal"] = worst16, bits16
    log(f"(b) bf16 packed vs canonical: weights {worst16:.3e} of scale apart "
        f"({'bit for bit equal' if bits16 else 'not bit for bit'})")
    out["packed_chain"], out["packed_chain_bf16"] = b, b16

    # ---- (c) steps_per_call, device_resident_data ------------------------------
    spc = ["--config.steps_per_call", str(steps)]
    c = {"pm_vqvae": {"spc1": b["packed"]}}
    c["pm_vqvae"]["spc4"] = run("train_pm_vqvae steps_per_call=4", spc)
    c["pm_vqvae"]["resident"] = run("train_pm_vqvae steps_per_call=4 device_resident_data",
                                    [*spc, "--config.device_resident_data", "True"])
    same_checkpoints(b["packed"]["run_dir"], c["pm_vqvae"]["spc4"]["run_dir"],
                     "(c) train_pm_vqvae steps_per_call=4 against 1")
    gas = ["--config", "pm_vae_gas", "--config.steps", str(steps), "--config.validation_freq",
           str(steps), *common]
    c["pm_vae_gas"] = {label: options_cli(f"train_pm_vae gas {label}", train_pm_vae.main,
                                          [*gas, *extra], f"{cwd}/gas", f"{cwd}/no_data",
                                          counters)
                       for label, extra in (("spc1", []), ("spc4", spc), ("resident", [
                           *spc, "--config.device_resident_data", "True"]))}
    same_checkpoints(c["pm_vae_gas"]["spc1"]["run_dir"], c["pm_vae_gas"]["spc4"]["run_dir"],
                     "(c) train_pm_vae gas steps_per_call=4 against 1")
    for name, runs in c.items():
        log(f"(c) {name}: logged steps/s " + ", ".join(
            f"{k} {v['steps_per_sec_logged']}" for k, v in runs.items())
            + f" | {nvidia_smi_line()}")
    out["steps_per_call"] = c

    # ---- (d) the mask generators -------------------------------------------------
    out["masks"] = mask_distribution_check(args.seed)
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Phase 23: the native host gather, the device rescale, snapshots
# ---------------------------------------------------------------------------

GATHER_BATCHES = 200       # batches each gather is timed over, native and numpy in turns
# (name, rows of the split, row shape, dtype, batch): CelebA's training split
# (162,770 images at 64x64x3), MNIST's (60,000) and gas's (852,174 rows of 8),
# at their configs' training batches
GATHER_CASES = (("celeb_a", 162_770, (64, 64, 3), np.uint8, "pm_vqvae_celeb_a"),
                ("mnist", 60_000, (28, 28, 1), np.uint8, "pm_vdvae_mnist"),
                ("pm_vae_gas", 852_174, (8,), np.float32, "pm_vae_gas"))
SNAPSHOT_EVERY = 2         # steps between the validations of (c)


def flat_tree(tree, prefix="", out=None):
    """A snapshot tree's leaves by path (containers as ``<type>`` entries)."""
    out = {} if out is None else out
    if isinstance(tree, dict):
        out[prefix + "<dict>"] = sorted(tree)
        for k, v in tree.items():
            flat_tree(v, f"{prefix}{k}/", out)
    elif isinstance(tree, list):
        out[prefix + "<list>"] = len(tree)
        for i, v in enumerate(tree):
            flat_tree(v, f"{prefix}{i}/", out)
    else:
        out[prefix] = tree
    return out


def same_tree(got, want, what):
    """Two snapshot trees equal: containers, keys, scalars, and every array
    bit for bit with its dtype."""
    g, w = flat_tree(got), flat_tree(want)
    check(set(g) == set(w), f"{what}: the trees hold other paths")
    for k, v in w.items():
        if isinstance(v, np.ndarray):
            check(isinstance(g[k], np.ndarray) and g[k].dtype == v.dtype
                  and g[k].shape == v.shape and g[k].tobytes() == v.tobytes(),
                  f"{what}: {k} differs")
        else:
            check(g[k] == v, f"{what}: {k} is {g[k]!r}, not {v!r}")
    return sum(isinstance(v, np.ndarray) for v in w.values())


def gather_check(args):
    """(a): each batch of GATHER_CASES through the native gather (fused
    with the rescale for uint8 images) against numpy's plain version on
    the same indices, bit for bit, GATHER_BATCHES shuffled batches, the two
    timed in turns on the host clock; the median ms of a batch of each."""
    from posterior_matching_torch import config, native

    rng = np.random.default_rng(args.seed)
    scale = np.float32(1.0 / 255.0)
    out = {"threads": native.THREADS, "cpu_count": os.cpu_count(),
           "library": native.build().name}
    for name, rows, shape, dtype, cfg in GATHER_CASES:
        batch = config.CONFIGS[cfg]()["data"]["train_batch_size"]
        if dtype == np.uint8:
            src = rng.integers(0, 256, (rows, *shape), dtype=np.uint8)
            fast = lambda idx: native.gather_u8_to_f32(src, idx, 1.0 / 255.0)
            plain = lambda idx: src[idx].astype(np.float32) * scale
        else:
            src = rng.standard_normal((rows, *shape), dtype=np.float32)
            fast = lambda idx: native.gather_rows(src, idx)
            plain = lambda idx: src[idx]
        order = rng.permutation(rows)[:batch * GATHER_BATCHES].reshape(GATHER_BATCHES, batch)
        times = {"native": [], "numpy": []}
        for i, idx in enumerate(order):
            res = {}
            for kind in (("native", "numpy") if i % 2 else ("numpy", "native")):
                fn = fast if kind == "native" else plain
                t = time.perf_counter_ns()
                res[kind] = fn(idx)
                times[kind].append((time.perf_counter_ns() - t) / 1e6)
            check(res["native"].dtype == res["numpy"].dtype
                  and res["native"].tobytes() == res["numpy"].tobytes(),
                  f"{name}: the native batch {i} differs from numpy's")
        med = {k: float(np.median(v)) for k, v in times.items()}
        out[name] = {"rows": rows, "row_shape": list(shape), "dtype": np.dtype(dtype).name,
                     "batch": batch, "batch_mb": res["numpy"].nbytes / 1e6,
                     "native_ms": med["native"], "numpy_ms": med["numpy"],
                     "native_over_numpy": med["native"] / med["numpy"],
                     "native_ms_p10_p90": np.percentile(times["native"], [10, 90]).tolist(),
                     "numpy_ms_p10_p90": np.percentile(times["numpy"], [10, 90]).tolist()}
        log(f"(a) {name}: {GATHER_BATCHES} batches of {batch} x {shape} {np.dtype(dtype).name} "
            f"from {rows} rows, bit for bit numpy's; median ms a batch native "
            f"{med['native']:.4f}, numpy {med['numpy']:.4f} "
            f"({med['native'] / med['numpy']:.3f}x; {native.THREADS} threads, "
            f"{os.cpu_count()} cores)")
        del src
    return out


def device_rescale_check(args):
    """(b): ``DeviceDataset.gather`` on the card against the host batch of
    the same indices (``ArrayDataset``'s fused gather), bit for bit, for a
    CelebA and an MNIST split of every byte value, and against numpy's
    float32 product."""
    from posterior_matching_torch.data.datasets import ArrayDataset, _make_batch_transform

    gen = torch.Generator(device=DEVICE).manual_seed(args.seed)
    out = {}
    for name, shape, batch in (("celeb_a", (64, 64, 3), 32), ("mnist", (28, 28, 1), 16)):
        n = 512
        x = np.resize(np.arange(256, dtype=np.uint8), (n, *shape))
        ds = ArrayDataset({"image": x}, batch, transform=_make_batch_transform(name, True))
        dds = ds.to_device_resident(DEVICE)
        check(dds.data["image"].dtype == torch.uint8
              and dds.data["image"].device.type == torch.device(DEVICE).type,
              f"{name}: the device split is not uint8 on the card")
        for _ in range(4):
            idx = torch.randint(0, n, (batch,), generator=gen, device=DEVICE)
            got = dds.gather(idx)["image"].cpu().numpy()
            sel = idx.cpu().numpy()
            host = ds._batch(sel)["image"]
            check(got.dtype == host.dtype and got.tobytes() == host.tobytes(),
                  f"{name}: the card's batch differs from the host batch")
            check(got.tobytes() == (x[sel].astype(np.float32) * np.float32(1 / 255)).tobytes(),
                  f"{name}: the card's batch is not float32(u8) * float32(1/255)")
        out[name] = {"batches": 4, "batch": batch, "bit_for_bit": True}
        log(f"(b) {name}: 4 device batches of {batch} bit for bit the host batches and "
            "float32(u8) * float32(1/255)")
    return out


def timed_callback(inner):
    """``inner`` wrapped: the host ms each ``on_validation_end`` blocks the
    training thread, in ``.ms``."""
    from posterior_matching_torch.train.callbacks import Callback

    class Timed(Callback):
        def __init__(self):
            self.inner, self.ms = inner, []

        def on_validation_end(self, train_state, step, logs):
            t0 = time.perf_counter()
            self.inner.on_validation_end(train_state, step, logs)
            self.ms.append((time.perf_counter() - t0) * 1e3)

    return Timed()


def snapshot_check(args, model, mask_fn, gen, work):
    """(c): ``pm_vqvae_trainer`` at the full width of
    ``configs/pm_vqvae_celeb_a.py`` fitted 3 x SNAPSHOT_EVERY steps,
    validating every SNAPSHOT_EVERY, with a ``SnapshotCallback``
    (``max_to_keep`` 2) and a ``CheckpointCallback``: exactly two whole
    snapshots left, ``restore_latest()`` the last ``train_state.pkl``
    array for array; the ms each callback blocks the training thread, the
    snapshot's MB, and one more save's blocking and writing ms."""
    from posterior_matching_torch import config
    from posterior_matching_torch.train.callbacks import (
        CheckpointCallback,
        SnapshotCallback,
        snapshot_tree,
    )
    from posterior_matching_torch.train.state import load_train_state
    from posterior_matching_torch.train.trainer import pm_vqvae_trainer

    root = f"{work}/snapshots"
    os.makedirs(root)
    snap = timed_callback(SnapshotCallback(f"{root}/snap", max_to_keep=2))
    ckpt = timed_callback(CheckpointCallback(f"{root}/train_state.pkl"))
    trainer = pm_vqvae_trainer(model, config.PM_VQVAE_CELEB_A_TRAIN, seed=args.seed,
                               mask_fn=mask_fn, device=DEVICE)
    batches = [{"image": torch.rand((BATCH, *config.CELEB_A_IMAGE_SHAPE), generator=gen,
                                    device=DEVICE)} for _ in range(SNAPSHOT_EVERY)]
    steps = 3 * SNAPSHOT_EVERY
    trainer.fit(batches, steps, validation_freq=SNAPSHOT_EVERY, callbacks=[snap, ckpt])
    t0 = time.perf_counter()
    got = snap.inner.restore_latest()
    restore_s = time.perf_counter() - t0
    kept = sorted(os.listdir(f"{root}/snap"))
    check(kept == [str(2 * SNAPSHOT_EVERY), str(steps)],
          f"the snapshot directory holds {kept}, not the newest two steps")
    want = snapshot_tree(load_train_state(f"{root}/train_state.pkl"), steps)
    n_arrays = same_tree(got, want, "restore_latest() against train_state.pkl")
    snap_mb = sum(f.stat().st_size for f in Path(f"{root}/snap/{steps}").iterdir()) / 1e6
    pkl_mb = os.path.getsize(f"{root}/train_state.pkl") / 1e6
    snap.inner.close()
    # one more save alone: its blocking and its writing
    state = trainer.train_state()
    extra = SnapshotCallback(f"{root}/extra", max_to_keep=1)
    t0 = time.perf_counter()
    extra.on_validation_end(state, steps, {})
    t1 = time.perf_counter()
    extra.close()
    t2 = time.perf_counter()
    out = {"steps": steps, "validations": len(snap.ms), "kept": kept, "arrays": n_arrays,
           "snapshot_mb": snap_mb, "pickle_mb": pkl_mb,
           "snapshot_block_ms": snap.ms, "checkpoint_block_ms": ckpt.ms,
           "restore_s": restore_s, "alone_block_ms": (t1 - t0) * 1e3,
           "alone_write_ms": (t2 - t1) * 1e3}
    log(f"(c) snapshots of the full-width PM-VQVAE CelebA trainer: {steps} steps, "
        f"{len(snap.ms)} validations, kept {kept}; restore_latest() the last "
        f"train_state.pkl in all {n_arrays} arrays ({restore_s:.3f} s); a snapshot "
        f"{snap_mb:.1f} MB (the pickle {pkl_mb:.1f} MB); on_validation_end blocks "
        f"{[round(v, 2) for v in snap.ms]} ms (SnapshotCallback) against "
        f"{[round(v, 2) for v in ckpt.ms]} ms (CheckpointCallback); one save alone blocks "
        f"{out['alone_block_ms']:.2f} ms and writes for {out['alone_write_ms']:.2f} ms "
        f"more | {nvidia_smi_line()}")
    return out


def host_modules_phase(args, model, mask_fn, gen, work):
    """Phase 23, the JAX package's last two modules in the port:
    (a) :func:`gather_check`, (b) :func:`device_rescale_check`, (c)
    :func:`snapshot_check`."""
    t0 = time.perf_counter()
    out = {"gather": gather_check(args), "device_rescale": device_rescale_check(args),
           "snapshots": snapshot_check(args, model, mask_fn, gen, work)}
    out["seconds"] = time.perf_counter() - t0
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--run_dir", default=None)
    parser.add_argument("--vdvae_run_dir", default=None)
    parser.add_argument("--out", default="chiprun_out/chip_smoke")
    parser.add_argument("--rank_mode", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--rank_spec", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    if args.rank_mode:
        return rank_main(args.rank_mode, args.rank_spec)
    from posterior_matching_torch import config, convert, masking
    from posterior_matching_torch.models.pm_vqvae import pm_vqvae_impute
    from posterior_matching_torch.ops import _build, sampler_chain as sc

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
    f = pcnn.num_filters
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

    with torch.no_grad():
        batch = request_batch()
        cond = model.conditional_latents(batch["image"], batch["mask"])
        cond = cond[None].expand(NUM_SAMPLES, *cond.shape).reshape(n, -1)
    sampler = sampler_phase(pcnn, cond, gen)
    vrow_err, row_err = sampler["vrow"]["max_abs_err"], sampler["row"]["max_abs_err"]
    vrow_ms, row_ms = sampler["vrow"]["ms"], sampler["row"]["ms"]

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

    small_request_check(model, x[:2], b[:2], gen, pm_cfg["conditional_dim"], vq_cfg, pc_cfg)

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

    with tempfile.TemporaryDirectory() as work:
        # ---- 9-11. PM-VDVAE --------------------------------------------------
        stamp("PM-VDVAE")
        vdvae_lines, vdvae = vdvae_phases(args, gen, work)

        # ---- 12. the PM-VQVAE CelebA pipeline from its CLIs -------------------
        stamp("the PM-VQVAE CelebA pipeline from its CLIs")
        os.makedirs(f"{work}/celeb_a")
        celeb_a = celeb_a_pipeline_phase(args, f"{work}/celeb_a")

        # ---- 13. the PM-VDVAE eval CLIs on phase 11's run ---------------------
        stamp("the PM-VDVAE eval CLIs")
        vdvae_eval = vdvae_eval_phase(vdvae["cli"]["run_dir"], work)

        # ---- 14. PM-VAE from its CLIs -------------------------------------------
        stamp("PM-VAE from its CLIs")
        os.makedirs(f"{work}/pm_vae")
        pm_vae = pm_vae_phase(args, f"{work}/pm_vae")

        # ---- 15. VaDE and greedy acquisition from their CLIs ---------------------
        stamp("VaDE and greedy acquisition from their CLIs")
        os.makedirs(f"{work}/vade")
        vade = vade_phase(args, f"{work}/vade")

        # ---- 16. resume, the run directory's logs, the cuDNN precision check ----
        stamp("resume, TensorBoard events and the cuDNN precision check")
        os.makedirs(f"{work}/resume/no_data")
        resume = resume_phase(args, f"{work}/resume", f"{work}/celeb_a/data",
                              celeb_a["train_vqvae"]["run_dir"], f"{work}/data")
        log(f"phase 16: {resume['seconds']:.1f} s | {smi}")

        # ---- 17. PM-VQVAE digits16: the kernels' 64-filter builds -------------
        stamp("PM-VQVAE digits16 at 64 filters")
        digits16_lines, digits16 = digits16_phase(args, gen, f"{work}/digits16")
        log(f"phase 17: {digits16['seconds']:.1f} s | {smi}")

        # ---- 18. ranks: train_pm_vdvae and the image evals over ranks ---------
        stamp("ranks: one NCCL rank, two gloo ranks on the one card")
        ranks = ranks_phase(args, f"{work}/ranks", celeb_a, vdvae["cli"]["run_dir"],
                            f"{work}/eval_data", f"{work}/celeb_a/data")
        log(f"phase 18: {ranks['seconds']:.1f} s | {smi}")

        # ---- 19. compute_dtype bfloat16, remat, flat_optimizer -----------------
        stamp("PM-VDVAE in bf16: the bf16 builds, the CLI with flat_optimizer, remat")
        bf16_lines, bf16 = bf16_phase(args, gen, work, vdvae_lines)
        for line in bf16_lines:
            line["launches"] = bf16["cli_launches"][line["name"]]
            line["launches_per_step"] = line["launches"] / BF16_STEPS
        log(f"phase 19: {bf16['seconds']:.1f} s | {smi}")

        # ---- 20. the PM-VQVAE in bf16: the gated chain's bf16 builds ----------
        stamp("PM-VQVAE in bf16: the gated chain's bf16 builds, train_pm_vqvae, eval")
        pmvq_bf16_lines, pmvq_bf16 = pmvq_bf16_phase(args, gen, celeb_a, work)
        log(f"phase 20: {pmvq_bf16['seconds']:.1f} s | {smi}")

        # ---- 21. the samplers' bf16 builds, rowkernel, the naive sampler ---
        stamp("the samplers' bf16 builds, PM_TPU_SAMPLER=rowkernel, the naive sampler")
        sampler_bf16_lines, sampler_bf16 = sampler_bf16_phase(args, gen, model, celeb_a, work)
        log(f"phase 21: {sampler_bf16['seconds']:.1f} s | {smi}")

        # ---- 22. use_ema=False, packed_chain, steps_per_call, the masks ------
        stamp("use_ema=False, packed_chain, steps_per_call, device_resident_data, masks")
        options = options_phase(args, celeb_a, work)
        log(f"phase 22: {options['seconds']:.1f} s | {smi}")
        new_paths = {"train_vqvae use_ema=False": options["use_ema_false"]["train_vqvae"],
                     "train_pm_vqvae packed": options["packed_chain"]["packed"],
                     "train_pm_vqvae steps_per_call=4":
                         options["steps_per_call"]["pm_vqvae"]["spc4"]}
        for line in (vq_line, *chain_lines):
            if line["name"] in ("vq_search", "gated_stream_fwd", "gated_stream_bwd"):
                line["launches_new_paths"] = {k: r["launches"].get(line["name"], 0)
                                              for k, r in new_paths.items()}

        # ---- 23. the native gather, the device rescale, snapshots ----------
        stamp("the native host gather, the device rescale, SnapshotCallback")
        host_modules = host_modules_phase(args, model, mask_fn, gen, work)
        log(f"phase 23: {host_modules['seconds']:.1f} s | {smi}")

    # ---- 24. results -------------------------------------------------------
    stamp("results")
    kernels = [
        {"name": "sampler_vrow", "route": "cuda",
         "source": "posterior_matching_torch/ops/csrc/sampler_vrow.cu",
         "replaces": "posterior_matching_tpu/ops/sampler_chain.py:124",
         "launches": launches["sampler_vrow"], "max_abs_err": vrow_err,
         "ms": vrow_ms, "plain_ms": sampler["vrow"]["plain_ms"],
         "bound_ms": sampler["vrow"]["bound_ms"], "bound_by": sampler["vrow"]["bound_by"],
         "library_ms": None,
         "design": f"{sampler['vrow']['blocks']} blocks of 12 warps; operands built in shared "
                   "memory once a GEMM (zero halo rows); weights streamed by "
                   "cp.async.bulk through 3 x 32 KB mbarrier slots, each refilled by "
                   "the last warp done with it; 16 rows x 4 or 8 x 8 columns a "
                   "thread, split-K reduced in fixed order"},
        {"name": "sampler_row", "route": "cuda",
         "source": "posterior_matching_torch/ops/csrc/sampler_row.cu",
         "replaces": "posterior_matching_tpu/ops/sampler_chain.py:215",
         "launches": launches["sampler_row"], "max_abs_err": row_err,
         "ms": row_ms, "plain_ms": sampler["row"]["plain_ms"],
         "bound_ms": sampler["row"]["bound_ms"], "bound_by": sampler["row"]["bound_by"],
         "library_ms": None,
         "design": "one block of 8 consumer warps + 1 producer warp per 8 samples; "
                   "operands gathered into shared memory once a GEMM; weights "
                   "streamed by cp.async.bulk through 2 x 64 KB mbarrier slots; "
                   "8 samples x 4 columns a lane, split-K reduced in fixed order"},
        vq_line, *chain_lines, *vdvae_lines, *digits16_lines, *bf16_lines, *pmvq_bf16_lines,
        *sampler_bf16_lines,
    ]
    summary = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "imgs_per_s": BATCH * len(steady) / sum(steady),
        "request_s": req_s, "psnr": psnrs, "modes_first_step": first_step,
        "training": train, "vqvae_cli": vqvae_cli, "vdvae": vdvae, "kernels": kernels,
        "celeb_a_pipeline": celeb_a, "vdvae_eval_clis": vdvae_eval, "pm_vae": pm_vae,
        "vade": vade, "resume": resume, "digits16": digits16, "ranks": ranks, "bf16": bf16,
        "pmvq_bf16": pmvq_bf16, "sampler_bf16": sampler_bf16, "options": options,
        "host_modules": host_modules,
    }
    (out_dir / "summary.json").write_text(json.dumps(summary, indent=1))
    log(smi)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("launches_per_step", "launches_new_paths", "bound_f32_ms", "f32_ms", "per_run",
             "per_pass", "per_shape", "design")
    log(json.dumps({"kernels": [{**{k: kd[k] for k in keys},
                                 **{k: kd[k] for k in extra if k in kd}} for kd in kernels]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

Runs the port's PM-VQVAE CelebA imputation path at the flagship's full width
and checks it, in four phases:

1. header: torch and CUDA versions, the card's name and power limit;
2. both row-sampler kernels (``posterior_matching_torch/ops/csrc``) are built
   from this checkout's sources, launched at the main path's shapes
   (n = 32 images x 10 samples, F = 128, L = 24, 16 x 16 codes, K = 512) and
   held against their plain PyTorch versions on the same inputs; each is
   timed with CUDA events beside its bound;
3. the slice: three imputation requests of 32 seeded 64x64x3 images with
   CelebA masks, 10 samples each, through ``pm_vqvae_impute`` with weights
   from ``--seed`` (a JAX-layout tree sent through ``convert.py``) or from
   ``--run_dir``; the kernels' launch counters must show the requests went
   through them; a small request is also checked against the plain path on
   the CPU with the same noise;
4. one JSON line of per-kernel numbers, the card's name and power limit, and
   the result line.

Usage: ``python3 chip_smoke.py [--seed 0] [--run_dir RUN] [--out DIR]``.
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
# Published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

BATCH, NUM_SAMPLES, REQUESTS = 32, 10, 3
DEVICE = "cuda"


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()]


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def rel_err(got: torch.Tensor, want: torch.Tensor):
    err = (got - want).abs().max().item()
    return err, err / max(1.0, want.abs().max().item())


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--run_dir", default=None)
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
        row_ms = time_ms(lambda: sc.row(*row_in), reps=5)
        row_plain_ms = time_ms(lambda: sc.row_plain(*row_in), reps=2)

    n_res = pcnn.num_resnet
    vrow_flops = 2 * wid * n * (9 * f * f + n_lvl * (12 * f * f + 24 * f * f) + n_res * 2 * f * f)
    row_flops = 2 * n * wid * (2 * f * f + n_lvl * (12 * f * f + 16 * f * f) + f * k_idx)
    vrow_bytes = nbytes(*vrow_in, *want_v)
    row_bytes = nbytes(*row_in, *want_r[:3])  # timed without the logits out

    def bound(flops, byts):
        t_op, t_by = flops / PEAK_F32_FLOPS * 1e3, byts / PEAK_BYTES * 1e3
        return max(t_op, t_by), ("operations" if t_op >= t_by else "bytes")

    vrow_bound, vrow_by = bound(vrow_flops, vrow_bytes)
    row_bound, row_by = bound(row_flops, row_bytes)
    log(f"vrow: {vrow_ms:.3f} ms/launch (plain {vrow_plain_ms:.3f}), bound "
        f"{vrow_bound:.3f} ms by {vrow_by} ({vrow_flops / 1e9:.1f} GFLOP, "
        f"{vrow_bytes / 1e6:.1f} MB)")
    log(f"row:  {row_ms:.3f} ms/launch (plain {row_plain_ms:.3f}), bound "
        f"{row_bound:.3f} ms by {row_by} ({row_flops / 1e9:.1f} GFLOP, "
        f"{row_bytes / 1e6:.1f} MB)")

    # ---- 3. the slice: three imputation requests ---------------------------
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

    # ---- 4. results --------------------------------------------------------
    kernels = [
        {"name": "sampler_vrow", "route": "cuda",
         "source": "posterior_matching_torch/ops/csrc/sampler_vrow.cu",
         "replaces": "posterior_matching_tpu/ops/sampler_chain.py:124",
         "launches": launches["sampler_vrow"], "max_abs_err": vrow_err,
         "ms": vrow_ms, "plain_ms": vrow_plain_ms, "bound_ms": vrow_bound,
         "bound_by": vrow_by, "library_ms": None},
        {"name": "sampler_row", "route": "cuda",
         "source": "posterior_matching_torch/ops/csrc/sampler_row.cu",
         "replaces": "posterior_matching_tpu/ops/sampler_chain.py:215",
         "launches": launches["sampler_row"], "max_abs_err": row_err,
         "ms": row_ms, "plain_ms": row_plain_ms, "bound_ms": row_bound,
         "bound_by": row_by, "library_ms": None},
    ]
    summary = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "imgs_per_s": BATCH * len(steady) / sum(steady),
        "request_s": req_s, "psnr": psnrs, "kernels": kernels,
    }
    (out_dir / "summary.json").write_text(json.dumps(summary, indent=1))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

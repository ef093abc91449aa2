"""Times the port's training steps at full width on one GPU: cuDNN's own
choice of convolution algorithms against its deterministic ones, turn by
turn in one process, or one tree of the repository against another, one
process each, on one card in one call.

For each model (PM-VQVAE CelebA through the chain's "stream", the CelebA
VQ-VAE, the PM-VDVAE MNIST unfused and fused; random weights from seed 0,
seeded batches, the CLIs' trainers) and each turn of ``--pattern`` (``c``:
cuDNN's own choice, ``d``: its deterministic algorithms): the weights reset
and the trainer's ``init``, one untimed step, then STEPS steps
(VDVAE_STEPS for the PM-VDVAE), each waited for. It logs each turn's mean
ms a step, each setting's mean over its turns and its steps/s, how many
tensors (weights, buffers, Adam's ``mu``) the first two turns of a setting
end with differently, and the card's name and power limit, and writes
them as JSON to ``--out``.

The package is imported from ``--root`` (this repository by default), so
that another tree of it, unpacked by ``git archive``, is timed the same way;
a tree whose trainers have no ``deterministic`` runs ``c`` turns only:

    python tools/step_timing.py --pattern cddccddc --out chiprun_out/change.json
    python tools/step_timing.py --root parent --pattern cccc --out chiprun_out/parent.json
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

BATCH, VDVAE_BATCH, DISTINCT_BATCHES = 32, 16, 4
STEPS, VDVAE_STEPS, SEED = 5, 3, 0


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def models(seed: int, dev: str):
    """``{name: (trainer, batches)}`` at the configs' full widths."""
    from posterior_matching_torch import config, convert, masking
    from posterior_matching_torch.config import CONFIGS
    from posterior_matching_torch.models.vdvae import PosteriorMatchingVDVAE
    from posterior_matching_torch.train import trainer as tr

    gen = torch.Generator(device=dev).manual_seed(seed)
    vq, pm = config.VQVAE_CELEB_A, config.PM_VQVAE_CELEB_A
    pm_vqvae = convert.pm_vqvae_from_jax(
        *convert.random_pm_vqvae_tree(pm["conditional_dim"], vq, pm["pixel_cnn"], seed=seed),
        pm["conditional_dim"], vq, pm["pixel_cnn"], device=dev)
    pm_vqvae.pixel_cnn.chain_segment = "stream"
    vqvae = convert.vqvae_from_jax(*convert.init_vqvae_tree(vq, seed), vq, device=dev)
    unfused = convert.pm_vdvae_from_jax(
        convert.random_pm_vdvae_tree(config.PM_VDVAE_MNIST, seed=seed), config.PM_VDVAE_MNIST,
        device=dev)
    fused = PosteriorMatchingVDVAE.from_config(dict(config.PM_VDVAE_MNIST, fused_chain=True),
                                               device=dev)
    fused.load_state_dict(unfused.state_dict())
    celeb_a = [{"image": torch.rand(BATCH, *config.CELEB_A_IMAGE_SHAPE, generator=gen,
                                    device=dev)} for _ in range(DISTINCT_BATCHES)]
    mnist = [{"image": torch.randint(0, 256, (VDVAE_BATCH, 28, 28, 1), generator=gen,
                                     device=dev).float()} for _ in range(DISTINCT_BATCHES)]
    celeb_a_masks = masking.get_mask_generator("CelebAMaskGenerator", device=dev)
    mnist_masks = masking.get_mask_generator("MNISTMaskGenerator", device=dev)
    vdvae = lambda model: tr.pm_vdvae_trainer(model, config.PM_VDVAE_MNIST_TRAIN, seed=seed,
                                              mask_fn=mnist_masks, device=dev)
    return {
        "pm_vqvae_celeb_a": (tr.pm_vqvae_trainer(pm_vqvae, config.PM_VQVAE_CELEB_A_TRAIN,
                                                 seed=seed, mask_fn=celeb_a_masks,
                                                 device=dev), celeb_a),
        "vqvae_celeb_a": (tr.vqvae_trainer(vqvae, CONFIGS["vqvae_celeb_a"](), seed=seed,
                                           device=dev), celeb_a),
        "pm_vdvae_mnist": (vdvae(unfused), mnist),
        "pm_vdvae_mnist_fused": (vdvae(fused), mnist),
    }


def turn(trainer, start, batches, steps, setting):
    """One turn from ``start``: ms of each timed step, and the end state."""
    trainer.model.load_state_dict(start)
    trainer.init()
    if hasattr(trainer, "deterministic"):
        trainer.deterministic = setting == "d"
    elif setting != "c":
        raise ValueError("this tree's trainers have no deterministic setting: use 'c' turns")
    trainer.train_step(batches[0])
    torch.cuda.synchronize()
    ms = []
    for i in range(steps):
        t0 = time.perf_counter()
        trainer.train_step(batches[(i + 1) % len(batches)])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    end = {**trainer.model.state_dict(),
           **{f"mu.{k}": v for k, v in trainer.optimizer.mu.items()}}
    return ms, {k: v.detach().cpu().clone() for k, v in end.items()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--pattern", default="cddccddc")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("step_timing: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    from posterior_matching_torch.ops import _build

    _build.build()
    smi = nvidia_smi_line()
    out = {"root": args.root, "pattern": args.pattern, "device": smi, "models": {}}
    built = models(SEED, "cuda")
    for name in list(built):
        trainer, batches = built[name]
        start = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
        steps = VDVAE_STEPS if name.startswith("pm_vdvae") else STEPS
        turns, ends = [], {}
        for setting in args.pattern:
            ms, end = turn(trainer, start, batches, steps, setting)
            turns.append({"setting": setting, "ms": ms, "mean_ms": sum(ms) / len(ms)})
            ends.setdefault(setting, []).append(end)
            print(f"{name} turn {len(turns)} ({setting}): "
                  + " ".join(f"{t:.2f}" for t in ms) + f" ms | {smi}", flush=True)
        res = {"turns": turns, "tensors": len(end), "mean_ms": {}, "steps_per_s": {},
               "differ": {}}
        for setting, got in ends.items():
            times = [t for tn in turns if tn["setting"] == setting for t in tn["ms"]]
            res["mean_ms"][setting] = sum(times) / len(times)
            res["steps_per_s"][setting] = 1e3 * len(times) / sum(times)
            if len(got) > 1:
                res["differ"][setting] = sum(not torch.equal(got[0][k], got[1][k])
                                             for k in got[0])
        print(f"{name}: mean ms a step " + ", ".join(
            f"{s} {v:.2f} ({res['steps_per_s'][s]:.3f} steps/s)" for s, v in
            res["mean_ms"].items()) + f"; of {len(end)} tensors, a setting's first two "
            f"turns differ in {res['differ']} | {smi}", flush=True)
        out["models"][name] = res
        del built[name], trainer, ends
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

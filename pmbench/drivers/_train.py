"""The training window that every family's training driver shares. Set-up builds
the family's trainer once and drives it through the traffic's ``check_steps``
(the window's own call and feed, on distinct rows) and ``warmup_steps``; the
window steps for ``seconds``, each batch fetched under a host span. After the
window, with the program freed, the first steps are held against the family's
reference: each step's loss, the first gradient (Adam's first moment after one
step, over 1 - b1), the parameters' change after the check steps and, where the
trainer keeps one, the EMA's."""
from __future__ import annotations

import gc
import statistics
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional

import torch

from pmbench.harness import HostReading, Outcome, Stamps, sync
from pmbench.profiling import profile_window

B1 = 0.9


@dataclass
class Setup:
    trainer: object                  # the program's Trainer
    batches: Iterator                # the window's feed
    initial: Dict[str, torch.Tensor]  # trainable leaves before the first step, by name
    canonical: Callable[[dict], dict]  # tensors keyed as the optimizer's -> by name
    data: object                     # what the reference needs to rebuild the rows


def norms(tensors: dict, scale: float = 1.0) -> dict:
    names = sorted(tensors)
    vals = torch.stack([tensors[n].detach().float().norm() for n in names]) * scale
    return dict(zip(names, vals.cpu().tolist()))


def forever(dataset):
    while True:
        yield from dataset


def run_training(cell, *, seed, seconds, trace, device, t_start, control, setup,
                 reference) -> Outcome:
    """``setup(cell, seed, dev, stamp) -> Setup``; ``reference(cell, seed, data, steps,
    dev, tf32) -> (losses, grad1, change, ema)``."""
    traffic, dev = cell.traffic, torch.device(device)
    bsz = cell.config["data"]["train_batch_size"]
    stamp = Stamps(t_start)
    s = setup(cell, seed, dev, stamp)
    trainer, batches = s.trainer, s.batches
    losses, grad1 = [], None
    for i in range(traffic["check_steps"]):
        losses.append(trainer.train_step(next(batches))["loss"])
        if i == 0:
            grad1 = norms(s.canonical(trainer.optimizer.mu), 1.0 / (1.0 - B1))
    trainer.sync_canonical()
    params = dict(trainer.model.named_parameters())
    change = norms({n: params[n].detach() - p for n, p in s.initial.items()})
    ema = None
    if trainer.ema_params is not None:
        e = s.canonical(trainer.ema_params)
        ema = norms({n: e[n] - p for n, p in s.initial.items()})
    got = ([float(v) for v in losses], grad1, change, ema)
    stamp("check steps")
    del params, s.initial
    for _ in range(traffic["warmup_steps"]):
        trainer.train_step(next(batches))
    sync(dev)
    stamp("warm-up steps")
    setup_s = time.time() - t_start

    fetch_s, step_losses = [], []
    host = HostReading()
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        batch = next(batches)
        fetch_s.append(time.perf_counter() - a)
        step_losses.append(trainer.train_step(batch)["loss"])
        if time.perf_counter() - t0 >= seconds:
            break
    sync(dev)
    window_s = time.perf_counter() - t0
    print(host.line(), file=sys.stderr)
    steps = len(step_losses)
    failed = int((~torch.isfinite(torch.stack(step_losses))).sum())
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    tw = None
    if trace and dev.type == "cuda":
        k = max(2, min(traffic["profile_steps"],
                       round(traffic["profile_seconds"] * steps / window_s)))
        tw = profile_window(lambda: [trainer.train_step(next(batches)) for _ in range(k)], k)
    data = s.data
    del trainer, batches, batch, step_losses, s
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    want = reference(cell, seed, data, traffic["check_steps"], dev, False)
    if control:   # the reference at the next lower precision in the program's place
        got = reference(cell, seed, data, traffic["check_steps"], dev, True)
    checks = compare(got, want, cell.limits)
    e2e = {"setup_s": setup_s, "train_imgs_per_s": steps * bsz / window_s}
    facts = {"batch_ms": [v * 1e3 for v in fetch_s], "steps": steps, "window_s": window_s}
    return Outcome(steps, failed, e2e, checks, peak, tw, facts, stamp.line())


def _leaf_gap(got: dict, want: dict, names) -> float:
    """The widest gap of a leaf's norm, against the reference's norm of that
    leaf or of the median leaf, whichever is larger."""
    med = statistics.median(want[n] for n in names)
    return max(abs(got[n] - want[n]) / max(want[n], med) for n in names)


def gaps(got, want) -> Dict[str, float]:
    """The numbers compared: the widest relative gap of a step's loss, and
    the leaf gaps of the first gradient, the change and the EMA's change.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's (moved by round-off alone under Adam) are left out of the changes."""
    (lp, gp, dp, ep), (lr, gr, dr, er) = got, want
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(lp, lr)),
           "grad_gap": _leaf_gap(gp, gr, list(gr))}
    med_g = statistics.median(gr.values())
    moved = [n for n in gr if gr[n] >= 1e-3 * med_g]
    out["change_gap"] = _leaf_gap(dp, dr, moved)
    if er is not None:
        out["ema_gap"] = _leaf_gap(ep, er, moved) if ep is not None else float("inf")
    return out


def compare(got, want, limits) -> dict:
    """``{name: (number, limit)}``; a program whose trainable leaves are not the
    reference's fails on ``leaves``."""
    if set(got[1]) != set(want[1]):
        return {"leaves": (float(len(set(got[1]) ^ set(want[1]))), 0.0)}
    return {k: (v, float(limits[k])) for k, v in gaps(got, want).items()}


def adam_steps(params: dict, names, step_loss, steps: int, lr_at, clip: Optional[float] = None,
               ema_rate: Optional[float] = None, eps: float = 1e-8):
    """The reference's optimizer: ``steps`` steps of Adam (optax's order, b1 0.9,
    b2 0.999) on the leaves ``names`` of ``params`` with the learning rate
    ``lr_at(count)``, the gradients clipped by their global norm first where
    ``clip`` is set, an EMA of every parameter after each update where
    ``ema_rate`` is set. ``step_loss(step)`` is the step's loss. Returns the
    losses, the first gradients (as Adam gets them), the change and the EMA's
    change of each leaf."""
    b2 = 0.999
    p0 = {n: params[n].detach().clone() for n in names}
    mu = {n: torch.zeros_like(params[n]) for n in names}
    nu = {n: torch.zeros_like(params[n]) for n in names}
    ema = {n: p.detach().clone() for n, p in params.items()} if ema_rate else None
    losses, grad1 = [], None
    for step in range(steps):
        loss = step_loss(step)
        grads = dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names])))
        losses.append(float(loss.detach()))
        if clip is not None:
            norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            grads = {n: torch.where(~(norm < clip), (g / norm) * clip, g)
                     for n, g in grads.items()}
        if step == 0:
            grad1 = norms(grads)
        lr, c1, c2 = lr_at(step), 1.0 - B1 ** (step + 1), 1.0 - b2 ** (step + 1)
        with torch.no_grad():
            for n in names:
                g = grads[n]
                mu[n].mul_(B1).add_((1.0 - B1) * g)
                nu[n].mul_(b2).add_((1.0 - b2) * (g * g))
                params[n].sub_(lr * ((mu[n] / c1) / (torch.sqrt(nu[n] / c2) + eps)))
            if ema is not None:
                for n, p in params.items():
                    ema[n].copy_(ema[n] * ema_rate + (1.0 - ema_rate) * p)
    change = norms({n: params[n].detach() - p0[n] for n in names})
    ema_change = norms({n: ema[n] - p0[n] for n in names}) if ema is not None else None
    return losses, grad1, change, ema_change

"""The greedy active-feature-acquisition engine.

Counterpart of ``posterior_matching_tpu/acquisition.py:20-111``: at each
step the information gains of every unobserved feature, from the PM-VAE's
sampling estimator and from the lookahead posteriors, pick the next
feature greedily, and a mean imputation scores the reconstruction; two
rollouts of ``episode_length`` steps, one driven by each estimator, make an
instance's trajectories.

The JAX engine jits one instance's episode (a ``lax.scan``) and vmaps it
over a chunk of instances. Here a Python loop runs the steps, each step
batched over the chunk's instances, all outside autograd. Draws come from
``noise`` in the order the JAX engine draws them for one instance: the
sampling rollout's steps, then the lookahead rollout's, and in each step
the sampling estimator's partial-posterior samples ``[S, N, L]``, then the
imputation's ``[S, N, L]``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch

from posterior_matching_torch.distributions import Noise
from posterior_matching_torch.models.lookahead import LookaheadPosterior

Step = Dict[str, torch.Tensor]


def rmse(true: torch.Tensor, pred: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The root mean squared error over the unobserved entries of each
    instance, its mean over all entries as the reference takes it
    (``acquisition.py:20-23``): ``[N]``."""
    se = (true - pred) ** 2 * (1.0 - b)
    return torch.sqrt(se.reshape(se.shape[0], -1).mean(-1))


def _logits(gains: torch.Tensor) -> torch.Tensor:
    return torch.where(gains == -math.inf, torch.full_like(gains, -1e10), gains)


def make_acquisition_eval_fn(model: LookaheadPosterior,
                             num_samples: int) -> Callable[..., Step]:
    """``eval_fn(x_o, b, noise)`` on ``N`` instances ``[N, D...]``: both
    estimators' greedy actions ``[N]`` (the argmax of the gains, ``-inf``
    replaced by ``-1e10``) and their softmaxes ``[N, F]``, and the mean of
    ``num_samples`` imputations ``[N, D...]`` (``acquisition.py:26-65``)."""

    @torch.no_grad()
    def eval_fn(x_o: torch.Tensor, b: torch.Tensor, noise: Noise) -> Step:
        sampling = _logits(model.pm_vae.batch_info_gains(x_o, b, noise, num_samples))
        lookahead = _logits(model.batch_lookahead_gains(x_o, b))
        reconstruction = model.impute(x_o, b, noise, num_samples).mean(0)
        return {
            "sampling_action": sampling.argmax(-1),
            "lookahead_action": lookahead.argmax(-1),
            "sampling_probs": torch.softmax(sampling, -1),
            "lookahead_probs": torch.softmax(lookahead, -1),
            "reconstruction": reconstruction,
        }

    return eval_fn


def make_collect_trajectory_fn(eval_fn: Callable[..., Step], episode_length: int
                               ) -> Callable[[torch.Tensor, Noise], Tuple[Step, Step]]:
    """``collect(x, noise)`` on ``N`` instances ``[N, D...]``: the sampling
    rollout's and the lookahead rollout's data, each a dict of ``[N,
    episode_length, ...]`` tensors (the outputs of ``eval_fn``, ``rmse``
    and the step's ``mask``), as the JAX engine's vmapped scans give them
    (``acquisition.py:68-111``). Each rollout starts from nothing observed
    and observes its action's feature after every step."""

    @torch.no_grad()
    def collect(x: torch.Tensor, noise: Noise) -> Tuple[Step, Step]:
        n, f = x.shape[0], math.prod(x.shape[1:])

        def rollout(action_key: str) -> Step:
            cur_b, steps = torch.zeros_like(x), []
            for _ in range(episode_length):
                data = eval_fn(x * cur_b, cur_b, noise)
                data["rmse"] = rmse(x, data["reconstruction"], cur_b)
                data["mask"] = cur_b
                step = torch.nn.functional.one_hot(data[action_key], f).to(x.dtype)
                cur_b = cur_b + step.reshape(cur_b.shape)
                steps.append(data)
            return {k: torch.stack([s[k] for s in steps], 1) for k in steps[0]}

        return rollout("sampling_action"), rollout("lookahead_action")

    return collect

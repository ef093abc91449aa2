"""Precision/Recall for Distributions (PRD, arXiv 1806.00035), clustering
on the device.

Counterpart of ``posterior_matching_tpu/eval/prd.py``: :func:`compute_prd`,
:func:`prd_to_max_f_beta_pair` and ``_f_beta`` are its numpy code as it
stands. Its clustering, ``sklearn.cluster.MiniBatchKMeans(n_clusters,
n_init=10)`` (``prd.py:46-47``), is replaced by :func:`kmeans` in torch,
on the eval's device: k-means++ seeding from an explicit
``torch.Generator``, ``n_init`` restarts, Lloyd steps in float64 until the
labels stop changing or 100 steps, the restart with the lowest inertia
kept. Every restart of every run goes in one batch.

Both clusterings are random, so :func:`compute_prd_from_embedding` equals
the JAX package's result only in distribution. The tests compare them where
both must find the same partition (well-separated Gaussian blobs, as many
clusters as blobs): PRD bins by cluster and does not depend on how the
clusters are numbered, so equal partitions give curves equal to float64
rounding.
"""
from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch

MAX_ITER = 100


def compute_prd(
    eval_dist: np.ndarray,
    ref_dist: np.ndarray,
    num_angles: int = 1001,
    epsilon: float = 1e-10,
) -> Tuple[np.ndarray, np.ndarray]:
    """PRD curve for two discrete distributions over the same states.

    precision(theta) = sum_i min(tan(theta) * ref_i, eval_i)
    recall(theta)    = precision(theta) / tan(theta)
    """
    if not 0 < epsilon <= 0.1:
        raise ValueError(f"epsilon must be in (0, 0.1], got {epsilon}")
    if not 3 <= num_angles <= 1e6:
        raise ValueError(f"num_angles must be in [3, 1e6], got {num_angles}")

    angles = np.linspace(epsilon, np.pi / 2 - epsilon, num=num_angles)
    slopes = np.tan(angles)[:, None]
    precision = np.minimum(ref_dist[None] * slopes, eval_dist[None]).sum(axis=1)
    recall = precision / slopes[:, 0]

    # numerical slack: values may land just above 1 when P == Q
    if max(precision.max(), recall.max()) > 1.001:
        raise ValueError("PRD value > 1.001; distributions are invalid")
    return np.clip(precision, 0, 1), np.clip(recall, 0, 1)


def _sq_dists(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """``x [n, d]``, ``centers [R, k, d]`` -> squared distances ``[R, n, k]``."""
    d = (x * x).sum(-1)[None, :, None] - 2.0 * x @ centers.transpose(1, 2) \
        + (centers * centers).sum(-1)[:, None, :]
    return d.clamp_min_(0.0)


def _kmeans_pp(x: torch.Tensor, k: int, restarts: int, gen: torch.Generator) -> torch.Tensor:
    """k-means++ seeding of ``restarts`` independent starts: ``[R, k, d]``."""
    n = x.shape[0]
    first = torch.randint(0, n, (restarts,), generator=gen, device=x.device)
    centers = x[first][:, None]
    closest = _sq_dists(x, centers)[..., 0]
    for _ in range(1, k):
        # every point at a chosen center (fewer distinct points than k):
        # draw uniformly
        weights = torch.where(closest.sum(-1, keepdim=True) > 0, closest,
                              torch.ones_like(closest))
        pick = torch.multinomial(weights, 1, generator=gen)[:, 0]
        new = x[pick][:, None]
        centers = torch.cat([centers, new], 1)
        closest = torch.minimum(closest, _sq_dists(x, new)[..., 0])
    return centers


def kmeans(x: torch.Tensor, k: int, runs: int = 1, n_init: int = 10,
           generator: Optional[torch.Generator] = None,
           max_iter: int = MAX_ITER) -> torch.Tensor:
    """Cluster labels ``[runs, n]`` of ``x [n, d]`` for ``runs``
    independent clusterings into ``k`` clusters, each the best of ``n_init``
    k-means++ / Lloyd restarts (at most ``max_iter`` steps) by inertia.
    Computes in float64 on ``x``'s device; ``generator`` lives there too."""
    x = x.double()
    restarts = runs * n_init
    centers = _kmeans_pp(x, k, restarts, generator)
    labels = None
    for _ in range(max_iter):
        new = _sq_dists(x, centers).argmin(-1)                       # [R, n]
        if labels is not None and torch.equal(new, labels):
            break
        labels = new
        onehot = torch.nn.functional.one_hot(labels, k).double()      # [R, n, k]
        counts = onehot.sum(1)[..., None]                             # [R, k, 1]
        sums = onehot.transpose(1, 2) @ x                             # [R, k, d]
        # an empty cluster keeps its center
        centers = torch.where(counts > 0, sums / counts.clamp_min(1.0), centers)
    dists = _sq_dists(x, centers)
    inertia = dists.min(-1).values.sum(-1).view(runs, n_init)
    best = inertia.argmin(-1) + torch.arange(runs, device=x.device) * n_init
    return dists.argmin(-1)[best]


def _histogram(labels: np.ndarray, k: int) -> np.ndarray:
    return np.histogram(labels, bins=k, range=[0, k], density=True)[0]


def compute_prd_from_embedding(
    eval_data: np.ndarray,
    ref_data: np.ndarray,
    num_clusters: int = 20,
    num_angles: int = 1001,
    num_runs: int = 10,
    enforce_balance: bool = True,
    generator: Optional[torch.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """PRD from embedding samples: cluster-bin the union, average the curve
    over ``num_runs`` independent clusterings (``prd.py:57-93``). The
    clustering runs on ``generator``'s device (the CPU without one)."""
    if enforce_balance and len(eval_data) != len(ref_data):
        raise ValueError(
            f"eval ({len(eval_data)}) and ref ({len(ref_data)}) sizes differ; "
            f"set enforce_balance=False to override (not recommended)"
        )
    total = len(eval_data) + len(ref_data)
    if total < num_clusters:
        # tiny smoke runs: k-means needs n_samples >= n_clusters; clamping
        # only changes behavior below protocol scale
        warnings.warn(
            f"clamping PRD num_clusters {num_clusters} -> {total} "
            f"(only {total} embeddings)"
        )
        num_clusters = total
    if generator is None:
        generator = torch.Generator()
        generator.seed()
    joint = np.vstack([np.asarray(eval_data, np.float64), np.asarray(ref_data, np.float64)])
    labels = kmeans(torch.from_numpy(joint).to(generator.device), num_clusters, num_runs,
                    generator=generator).cpu().numpy()
    precisions, recalls = [], []
    for run in labels:
        p, rec = compute_prd(_histogram(run[:len(eval_data)], num_clusters),
                             _histogram(run[len(eval_data):], num_clusters), num_angles)
        precisions.append(p)
        recalls.append(rec)
    return np.mean(precisions, axis=0), np.mean(recalls, axis=0)


def _f_beta(precision, recall, beta, epsilon=1e-10):
    if not ((precision >= 0).all() and (precision <= 1).all()):
        raise ValueError("precision values must be in [0, 1]")
    if not ((recall >= 0).all() and (recall <= 1).all()):
        raise ValueError("recall values must be in [0, 1]")
    if beta <= 0:
        raise ValueError(f"beta must be positive, got {beta}")
    b2 = beta**2
    return (1 + b2) * precision * recall / (b2 * precision + recall + epsilon)


def prd_to_max_f_beta_pair(
    precision: np.ndarray, recall: np.ndarray, beta: float = 8
) -> Tuple[float, float]:
    """(max F_beta, max F_{1/beta}): scalar summaries correlating with recall
    and precision respectively."""
    precision = np.asarray(precision)
    recall = np.asarray(recall)
    return (
        float(np.max(_f_beta(precision, recall, beta))),
        float(np.max(_f_beta(precision, recall, 1.0 / beta))),
    )

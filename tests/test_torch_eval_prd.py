"""PRD (``eval/prd.py``) against the JAX package's and sklearn's (split from
``tests/test_torch_eval.py``, so that the suite's workers run its k-means
beside the rest): the curves and F-beta scores from the same clusters, the
whole computation on separable blobs against sklearn's k-means, the labels
a partition into the blobs, and the cluster count clamped below the
protocol's scale.
"""
import numpy as np
import pytest
import torch

from posterior_matching_torch.eval import prd
from posterior_matching_tpu.eval import prd as jax_prd
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_prd_and_f_beta_match_jax(seed):
    rng = np.random.RandomState(seed)
    e, r = rng.rand(20), rng.rand(20)
    e, r = e / e.sum(), r / r.sum()
    got, want = prd.compute_prd(e, r), jax_prd.compute_prd(e, r)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
    np.testing.assert_allclose(prd.prd_to_max_f_beta_pair(*got),
                               jax_prd.prd_to_max_f_beta_pair(*want), rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="num_angles"):
        prd.compute_prd(e, r, num_angles=2)


@pytest.mark.parametrize("k", [5, 20])
def test_prd_from_embedding_on_blobs_matches_sklearn(k):
    rng = np.random.RandomState(k)
    centers = rng.randn(k, 64) * 50
    e = centers[rng.randint(0, k, 160)] + rng.randn(160, 64)
    r = centers[rng.randint(0, k, 160)] + rng.randn(160, 64)
    np.random.seed(0)   # MiniBatchKMeans draws from numpy's global stream
    want = jax_prd.compute_prd_from_embedding(e, r, num_clusters=k, num_runs=2)
    got = prd.compute_prd_from_embedding(e, r, num_clusters=k, num_runs=2,
                                         generator=torch.Generator().manual_seed(0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)


def test_kmeans_labels_are_a_partition_into_the_blobs():
    rng = np.random.RandomState(3)
    centers = rng.randn(6, 8) * 40
    truth = rng.randint(0, 6, 300)
    x = torch.from_numpy(centers[truth] + rng.randn(300, 8))
    labels = prd.kmeans(x, 6, runs=3, generator=torch.Generator().manual_seed(1))
    assert labels.shape == (3, 300)
    for run in labels.numpy():
        # one label per blob and one blob per label
        pairs = set(zip(truth.tolist(), run.tolist()))
        assert len(pairs) == 6 and len({t for t, _ in pairs}) == len({c for _, c in pairs}) == 6
    again = prd.kmeans(x, 6, runs=3, generator=torch.Generator().manual_seed(1))
    assert torch.equal(labels, again)


def test_prd_clamps_clusters_below_protocol_scale():
    rng = np.random.RandomState(0)
    with pytest.warns(UserWarning, match="clamping PRD num_clusters 20 -> 8"):
        p, r = prd.compute_prd_from_embedding(rng.randn(4, 3), rng.randn(4, 3),
                                              generator=torch.Generator().manual_seed(0))
    assert p.shape == r.shape == (1001,)
    with pytest.raises(ValueError, match="sizes differ"):
        prd.compute_prd_from_embedding(rng.randn(4, 3), rng.randn(5, 3))

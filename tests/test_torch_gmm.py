"""The port's Gaussian mixture fit and clustering accuracy, on the CPU.

- ``GaussianMixture`` (diagonal, 300 iterations, 10 k-means
  initialisations, sklearn's ``tol`` and ``reg_covar``) against
  ``sklearn.mixture.GaussianMixture`` with ``train_vade.py``'s settings:
  on well-separated blobs of unequal weights and spreads, the weights,
  means and variances up to a permutation of the components within 1e-4
  relative, and the predictions the same (after the permutation) on at
  least 99.9% of the rows; on overlapping data, where the fits are random
  (both draw their k-means seeding), the lower bounds within 1%.
- ``clustering_accuracy`` equals the JAX package's (sklearn's confusion
  matrix and scipy's assignment) on random label pairs, label sets of
  different sizes and values included.
- ``ClusteringAccuracyCallback`` through ``Trainer.fit``: the new
  ``on_validation_step`` hook sees every validation batch on the device
  and the callback logs ``val_clustering_accuracy``.
"""
import numpy as np
import pytest
import torch
from sklearn.mixture import GaussianMixture as SkGaussianMixture

from posterior_matching_tpu.eval.clustering import clustering_accuracy as jax_accuracy
from posterior_matching_torch.eval.clustering import (
    ClusteringAccuracyCallback,
    clustering_accuracy,
    confusion_matrix,
)
from posterior_matching_torch.eval.gmm import GaussianMixture
from posterior_matching_torch.train.optim import Adam
from posterior_matching_torch.train.trainer import Trainer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def blobs(seed, k=4, d=3, sep=12.0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d) * sep
    sizes = rng.randint(80, 200, size=k)
    spreads = 0.4 + rng.rand(k, d)
    x = np.concatenate([c + rng.randn(n, d) * s for c, n, s in zip(centers, sizes, spreads)])
    return x, np.repeat(np.arange(k), sizes)


def _sklearn(k, x, seed):
    return SkGaussianMixture(n_components=k, covariance_type="diag", max_iter=300, n_init=10,
                             random_state=seed).fit(x)


@pytest.mark.parametrize("seed", [0, 1])
def test_fit_matches_sklearn_on_separated_blobs(seed):
    x, labels = blobs(seed)
    k = 4
    want = _sklearn(k, x, seed)
    got = GaussianMixture(k, generator=torch.Generator().manual_seed(seed)).fit(x)
    assert got.converged_ and got.weights_.dtype == np.float64
    # match the components by their means
    perm = np.array([np.argmin(((want.means_ - m) ** 2).sum(-1)) for m in got.means_])
    assert sorted(perm) == list(range(k))
    np.testing.assert_allclose(got.weights_, want.weights_[perm], rtol=1e-4)
    np.testing.assert_allclose(got.means_, want.means_[perm], rtol=1e-4,
                               atol=1e-4 * np.abs(want.means_).max())
    np.testing.assert_allclose(got.covariances_, want.covariances_[perm], rtol=1e-4)
    np.testing.assert_allclose(got.lower_bound_, want.lower_bound_, rtol=1e-6)
    agree = np.mean(perm[got.predict(x)] == want.predict(x))
    assert agree >= 0.999, agree
    assert clustering_accuracy(labels, got.predict(x)) == 1.0


def test_lower_bound_matches_sklearn_on_overlapping_data():
    rng = np.random.RandomState(5)
    centers = np.array([[0.0, 0.0], [2.0, 0.5], [0.5, 2.5]])
    x = np.concatenate([c + rng.randn(300, 2) * (0.8, 1.1) for c in centers])
    want = _sklearn(3, x, 0).lower_bound_
    for seed in range(3):
        got = GaussianMixture(3, generator=torch.Generator().manual_seed(seed)).fit(x)
        assert abs(got.lower_bound_ - want) <= 0.01 * abs(want), (seed, got.lower_bound_, want)
        assert got.means_.shape == (3, 2) and np.all(got.covariances_ > 0)
        np.testing.assert_allclose(got.weights_.sum(), 1.0, rtol=1e-12)


def test_fit_takes_float32_tensors_and_refuses_too_few_rows():
    x, _ = blobs(2)
    got = GaussianMixture(4, generator=torch.Generator().manual_seed(0)).fit(
        torch.from_numpy(x.astype(np.float32)))
    assert got.predict(x.astype(np.float32)).shape == (len(x),)
    with pytest.raises(ValueError):
        GaussianMixture(4, generator=torch.Generator()).fit(x[:3])
    with pytest.raises(ValueError, match="generator on cpu"):
        GaussianMixture(4, generator=torch.Generator()).fit(torch.empty(64, 2, device="meta"))


@pytest.mark.parametrize("seed", range(6))
def test_clustering_accuracy_matches_jax(seed):
    rng = np.random.RandomState(seed)
    n = rng.randint(5, 200)
    y_true = rng.randint(0, rng.randint(1, 12), n)
    y_pred = rng.randint(0, rng.randint(1, 15), n) + rng.randint(0, 4)
    if seed == 0:
        y_pred = (y_true * 7 + 3) % 11          # a relabelling: accuracy 1
    assert clustering_accuracy(y_true, y_pred) == jax_accuracy(y_true, y_pred)
    if seed == 0:
        assert clustering_accuracy(y_true, y_pred) == 1.0
    cm = confusion_matrix(y_true, y_pred)
    assert cm.sum() == n and cm.shape[0] == len(np.union1d(y_true, y_pred))


class _Affine(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(2))


def test_callback_logs_accuracy_through_the_validation_hook(capsys):
    rng = np.random.RandomState(0)
    n = 24
    labels = rng.randint(0, 3, n)
    val = [{"features": rng.randn(8, 2).astype(np.float32), "label": labels[i:i + 8]}
           for i in range(0, n, 8)]
    seen = []

    def pred_fn(model, gen, batch):
        assert isinstance(gen, torch.Generator) and not model.training
        assert torch.is_tensor(batch["label"])
        seen.append(batch["label"])
        return (batch["label"] + 1) % 3          # a relabelling of the truth

    trainer = Trainer(_Affine(), lambda m, b, seed, training: (m.w * b["features"]).sum() ** 2,
                      optimizer=lambda p: Adam(p, lambda c: 1e-3), device="cpu")
    trainer.fit(val, 2, [ClusteringAccuracyCallback(pred_fn)], val_batches=val,
                validation_freq=1)
    assert len(seen) == 6
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[step ")]
    assert len(lines) == 2 and all("val_clustering_accuracy=1 " in ln for ln in lines)

"""Clustering accuracy and its validation callback.

Counterpart of ``posterior_matching_tpu/eval/clustering.py:14-52``, without
sklearn: the confusion matrix is built in numpy over the union of the two
label sets, sorted, as sklearn's ``confusion_matrix`` builds it, and the
best cluster-to-label matching is scipy's ``linear_sum_assignment`` on
``max(cm) - cm``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
from scipy.optimize import linear_sum_assignment

from posterior_matching_torch.train.callbacks import Callback


def confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray) -> np.ndarray:
    """``cm[i, j]``: the rows whose true label is the ``i``-th and whose
    predicted label is the ``j``-th of the sorted union of both label
    sets."""
    y_true, y_pred = np.asarray(y_true).ravel(), np.asarray(y_pred).ravel()
    labels = np.unique(np.concatenate([y_true, y_pred]))
    n = len(labels)
    idx = np.searchsorted(labels, y_true) * n + np.searchsorted(labels, y_pred)
    return np.bincount(idx, minlength=n * n).reshape(n, n)


def clustering_accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """The accuracy of the best one-to-one matching of clusters to labels
    (reference clustering.py:18-37)."""
    cm = confusion_matrix(y_true, y_pred)
    rows, cols = linear_sum_assignment(np.max(cm) - cm)
    return float(cm[rows, cols].sum()) / float(np.sum(cm))


class ClusteringAccuracyCallback(Callback):
    """Gathers cluster predictions over a validation and logs
    ``val_clustering_accuracy`` (``clustering.py:25-52``).

    Args:
        pred_fn: ``(model, generator, batch) -> cluster ids`` of the batch's
            rows; it runs under ``torch.no_grad``.
    """

    def __init__(self, pred_fn: Callable[..., Any]):
        self._pred_fn = pred_fn
        self._preds: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []

    def on_validation_step(self, model, generator, batch):
        preds = self._pred_fn(model, generator, batch)
        self._labels.append(batch["label"].detach().cpu().numpy())
        self._preds.append(preds.detach().cpu().numpy())

    def on_validation_end(self, train_state, step, logs: Dict[str, Any]):
        if not self._labels:
            return
        logs["val_clustering_accuracy"] = clustering_accuracy(np.hstack(self._labels),
                                                              np.hstack(self._preds))
        self._labels.clear()
        self._preds.clear()

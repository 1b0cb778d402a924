"""Metric objects (reference recman/metrics/logloss.py, roc_auc.py).

Framework-agnostic callables with a ``higher_the_better`` property, exactly
like the reference protocol. Host (sklearn-free) implementations — plus a
device-side streaming AUC in ``auc.py`` for datasets too large for exact
host evaluation (SURVEY.md §7 "AUC at scale").
"""

from __future__ import annotations

import numpy as np


class LogLoss:
    """Binary cross-entropy on probabilities (reference metrics/logloss.py:4-18,
    sklearn log_loss with eps=1e-7)."""

    def __init__(self, eps=1e-7):
        self.eps = eps

    def __call__(self, y_true, y_pred):
        y_true = np.asarray(y_true, dtype=np.float64)
        p = np.clip(np.asarray(y_pred, dtype=np.float64), self.eps, 1 - self.eps)
        return float(-np.mean(y_true * np.log(p) + (1 - y_true) * np.log(1 - p)))

    def __str__(self):
        return "logloss"

    __repr__ = __str__

    @property
    def higher_the_better(self):
        return False


class RocAucScore:
    """Exact ROC AUC via rank statistic (reference metrics/roc_auc.py:4-16).

    Equivalent to sklearn.roc_auc_score for binary labels: the
    Mann-Whitney U formulation with midrank tie handling.
    """

    def __call__(self, y_true, y_pred):
        y_true = np.asarray(y_true).astype(np.float64)
        y_pred = np.asarray(y_pred, dtype=np.float64)
        pos = y_true > 0.5
        n_pos = int(pos.sum())
        n_neg = len(y_true) - n_pos
        if n_pos == 0 or n_neg == 0:
            raise ValueError("ROC AUC undefined with a single class")
        order = np.argsort(y_pred, kind="mergesort")
        ranks = np.empty(len(y_pred), dtype=np.float64)
        sorted_pred = y_pred[order]
        # midranks for ties
        i = 0
        while i < len(sorted_pred):
            j = i
            while j + 1 < len(sorted_pred) and sorted_pred[j + 1] == sorted_pred[i]:
                j += 1
            ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
            i = j + 1
        sum_pos_ranks = ranks[pos].sum()
        return float((sum_pos_ranks - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))

    def __str__(self):
        return "roc_auc"

    __repr__ = __str__

    @property
    def higher_the_better(self):
        return True


class Gini:
    """Normalized Gini = 2*AUC - 1 (reference core/metric.py:5-44 keeps
    unused gini/gini_norm helpers; provided for parity)."""

    def __call__(self, y_true, y_pred):
        return 2.0 * RocAucScore()(y_true, y_pred) - 1.0

    def __str__(self):
        return "gini_norm"

    __repr__ = __str__

    @property
    def higher_the_better(self):
        return True

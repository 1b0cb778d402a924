"""Loss, regularization and sizing helpers, and the train/valid/test
split (counterpart of ``recman_tpu/utils/numerics.py``).
``split_train_test`` takes a dict of column arrays, since the port runs
where pandas is not installed, and picks the rows the reference's
``DataFrame.sample`` picks."""

from __future__ import annotations

import numpy as np
import torch


def l2_loss(x) -> torch.Tensor:
    """sum(x^2)/2 — tf.nn.l2_loss semantics, used by every layer's l2()."""
    return 0.5 * torch.sum(torch.square(x))


def bce_per_example(y_true, y_pred, eps=1e-7) -> torch.Tensor:
    """Per-example BCE over probabilities clipped to [eps, 1 - eps] (keras
    epsilon clipping) — BCE on probabilities, not on logits."""
    p = torch.clamp(y_pred, eps, 1.0 - eps)
    return -(y_true * torch.log(p) + (1.0 - y_true) * torch.log(1.0 - p))


def mse_per_example(y_true, y_pred) -> torch.Tensor:
    return torch.square(y_true - y_pred)


def _weighted_mean(per_ex, weights):
    if weights is None:
        return torch.mean(per_ex)
    return torch.sum(per_ex * weights) / torch.clamp(torch.sum(weights), min=1.0)


def binary_cross_entropy(y_true, y_pred, weights=None, eps=1e-7) -> torch.Tensor:
    """Mean BCE; ``weights`` (0 on padded rows) makes it the weighted mean
    sum(l * w) / max(sum(w), 1)."""
    return _weighted_mean(bce_per_example(y_true, y_pred, eps), weights)


def mean_squared_error(y_true, y_pred, weights=None) -> torch.Tensor:
    """Regression loss, weighted like ``binary_cross_entropy``."""
    return _weighted_mean(mse_per_example(y_true, y_pred), weights)


def compute_hidden_units_s1(num_hidden_layers, input_neurons, output_neurons=1):
    """Geometric-pyramid sizing (reference utils.py:126-132). Python's
    ``round``, which rounds halves to even, as the reference's."""
    r = (input_neurons + output_neurons) ** (1 / (num_hidden_layers + 1))
    return [round(output_neurons * (r**i)) for i in range(num_hidden_layers, 0, -1)]


def compute_hidden_units_s2(num_hidden_layers, input_neurons, output_neurons=1):
    """2/3-rule sizing of the ``None`` entries of a DNN's hidden_units
    (reference utils.py:135-139)."""
    return [round((input_neurons + output_neurons) * 2 / 3) for _ in range(num_hidden_layers)]


def count_parameters(params: dict) -> int:
    """Total parameter count over a flat params dict (reference utils.py:216-225)."""
    return sum(int(v.numel()) for v in params.values())


def _sample_rows(n: int, frac: float, random_seed: int) -> np.ndarray:
    """The positions ``DataFrame.sample(frac=frac, random_state=random_seed)``
    takes from n rows, in its order: pandas draws them with
    ``RandomState(random_seed).choice(n, round(frac * n), replace=False)``."""
    return np.random.RandomState(random_seed).choice(n, size=round(frac * n), replace=False)


def split_train_test(columns: dict, frac=0.8, random_seed=2019):
    """Train/valid/test split by sampling (reference numerics.py:65-71,
    utils.py:11-24): ``frac`` of the rows to train, half the rest to valid
    and the other half to test. ``columns``: {name: array} of equal
    length. Returns three such dicts with the rows, in order, that the
    reference's dataframes hold."""
    n = len(next(iter(columns.values())))
    train = _sample_rows(n, frac, random_seed)
    rest = np.setdiff1d(np.arange(n), train)  # ascending, as DataFrame.drop keeps them
    picked = _sample_rows(len(rest), 0.5, random_seed)
    valid = rest[picked]
    test = np.delete(rest, picked)

    def take(rows):
        return {k: np.asarray(v)[rows] for k, v in columns.items()}

    return take(train), take(valid), take(test)

"""Serving: batched scoring with a model and its params.

Counterpart of ``Predictor`` in ``recman_tpu/serving.py`` (:41-117):
``predict`` encodes a dataframe (or takes encoded arrays), pads the rows
into ``n // batch_size + 1`` batches of row indices (-1 marks padding,
reference ``training/trainer.py:44-57``), gathers each batch on the
device with the padding clamped to row 0 (``training.gather_batch``),
runs the eval forward and returns the first ``n`` predictions. The
inference-time linear overrides (``feat.set_weights``) apply unless
``apply_overrides=False``.

``from_checkpoint``, ``export`` and ``ExportedPredictor`` are not ported
yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .training import gather_batch


def batch_indices(n: int, batch_size: int, shuffle_seed=None) -> np.ndarray:
    """(num_batches, batch_size) int32 row indices, -1-padded at the tail,
    in the order ``np.random.RandomState(shuffle_seed).permutation(n)``
    when a seed is given.

    num_batches is the reference's ``n // batch_size + 1``: a full final
    slice yields one extra all-padding batch."""
    order = np.arange(n)
    if shuffle_seed is not None:
        order = np.random.RandomState(shuffle_seed).permutation(n)
    num_batches = n // batch_size + 1
    padded = np.full((num_batches * batch_size,), -1, dtype=np.int32)
    padded[:n] = order
    return padded.reshape(num_batches, batch_size)


class Predictor:
    """Inference-only wrapper around a model and its params, on one device
    (default CUDA; raises without a GPU unless ``device="cpu"``)."""

    def __init__(self, model, params, batch_size=4096, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.batch_size = batch_size

    def predict(self, X, apply_overrides=True) -> np.ndarray:
        """Batched scoring of a dataframe or an encoded-array dict."""
        data = dict(X) if isinstance(X, dict) else self.model.feat_dict.transform(X)
        data.pop("y", None)
        n = len(next(iter(data.values())))
        data = {k: torch.as_tensor(np.asarray(v)).to(self.device) for k, v in data.items()}

        override = None
        linear = getattr(self.model, "linear", None)
        if apply_overrides and linear is not None:
            override = torch.as_tensor(linear.override_vector()).to(self.device)

        idx = torch.as_tensor(batch_indices(n, self.batch_size)).to(self.device)
        with torch.inference_mode():
            outs = [
                self.model.apply(
                    self.params, gather_batch(data, idx[i])[0], training=False,
                    linear_override=override,
                )
                for i in range(idx.shape[0])
            ]
            return torch.cat(outs).cpu().numpy()[:n]

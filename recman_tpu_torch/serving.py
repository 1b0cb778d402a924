"""Serving: batched scoring with a model and its params.

Counterpart of ``Predictor`` in ``recman_tpu/serving.py`` (:41-117):
``predict`` encodes a dataframe (or takes encoded arrays), pads the rows
into ``n // batch_size + 1`` batches of row indices (-1 marks padding,
reference ``training/trainer.py:44-57``), gathers each batch on the
device with the padding clamped to row 0 (``training.gather_batch``),
runs the eval forward and returns the first ``n`` predictions. The
inference-time linear overrides (``feat.set_weights``) apply unless
``apply_overrides=False``.

``from_checkpoint`` rebuilds the model from a ``Trainer.save``
checkpoint's sidecars and reads its params alone, so a checkpoint written
on the card serves on the CPU and the other way round. ``export`` and
``ExportedPredictor`` are not ported yet (ROADMAP.md queue 1: the rest of
serving).
"""

from __future__ import annotations

import numpy as np
import torch

from .ckpt import load_feat_dict, load_hparams, restore_params
from .device import resolve_device
from .models import model_class
from .training import batch_indices, gather_batch

__all__ = ["Predictor", "batch_indices"]


class Predictor:
    """Inference-only wrapper around a model and its params, on one device
    (default CUDA; raises without a GPU unless ``device="cpu"``)."""

    def __init__(self, model, params, batch_size=4096, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.batch_size = batch_size

    @classmethod
    def from_checkpoint(cls, directory, model_name_or_cls, hparams=None, task="classification",
                        batch_size=4096, device=None):
        """Rebuild the model and its params from a ``Trainer.save`` or
        ``BestModelFinder`` checkpoint directory. ``hparams`` update the
        saved ones (the hparams sidecar keeps a tuple as its string)."""
        feat_dict = load_feat_dict(directory)
        try:
            saved_hp = load_hparams(directory)
        except FileNotFoundError:
            saved_hp = {}
        hp = dict(saved_hp)
        hp.update(hparams or {})
        model_cls = (model_class(model_name_or_cls) if isinstance(model_name_or_cls, str)
                     else model_name_or_cls)
        model = model_cls(feat_dict, hp, task=task)
        device = resolve_device(device)
        template = model.init_params(torch.Generator().manual_seed(0), device)
        return cls(model, restore_params(directory, template), batch_size=batch_size,
                   device=device)

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

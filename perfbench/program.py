"""The system under test: ``recman_tpu_torch``'s model, ``Trainer`` and
``Predictor``, built from a configuration file and handed the
benchmark's weights and rows. The only module of the benchmark that
imports the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import spec


def model(cfg):
    """The configuration's model class of ``recman_tpu_torch.models`` on
    its feature set (``recman_tpu_torch.data.<features>`` at its
    ``num_buckets``)."""
    from recman_tpu_torch import data, models

    feats = getattr(data, cfg["features"])(num_buckets=cfg["num_buckets"])
    return getattr(models, cfg["model"])(feats, dict(cfg["hparams"]))


def learning_rate(cfg, batch):
    """The optimizer's learning rate as the port takes it: a float, or
    ``training.large_batch_schedule`` over the file's horizon."""
    from recman_tpu_torch.training import large_batch_schedule

    s = cfg["optimizer"]["schedule"]
    if s["kind"] == "constant":
        return float(s["lr"])
    total = math.ceil(s["horizon_examples"] / batch)
    return large_batch_schedule(s["base_lr"], batch, s["base_batch"],
                                warmup_steps=max(int(total * s["warmup_frac"]), 1),
                                total_steps=total, decay="cosine")


def packed(cfg, rows):
    """The pool as ``Trainer.fit_on_batch`` takes it: (data, layout), the
    columns packed by dtype (``training.pack_dataset``'s layout)."""
    from recman_tpu_torch.training import pack_dataset

    cats, dense = spec.field_names(cfg)
    sample = {c: np.zeros(1, np.int32) for c in cats}
    sample.update({c: np.zeros(1, np.float32) for c in dense})
    sample["y"] = np.zeros(1, np.float32)
    _, layout = pack_dataset(sample)
    keys = {name: (key, start) for name, key, start, _, _ in layout}
    (ki,), (kf,) = {keys[c][0] for c in cats}, {keys[c][0] for c in dense}
    if [keys[c][1] for c in cats] != list(range(len(cats))) or \
            [keys[c][1] for c in dense] != list(range(len(dense))):
        raise ValueError("pack_dataset's column order is not the rows' order")
    return {ki: rows["cat"], kf: rows["dense"], "y": rows["y"]}, layout


class TrainProgram:
    """``Trainer.fit_on_batch`` on the pool, from the benchmark's weights:
    the model's ``init_params`` hands them to ``Trainer``, which builds its
    optimizer state on them (no weight is drawn on the host)."""

    def __init__(self, cfg, traffic, weights, rows, device):
        from recman_tpu_torch.training import Trainer

        batch = traffic["batch"]
        hp = dict(cfg["hparams"], optimizer=cfg["optimizer"]["name"],
                  learning_rate=learning_rate(cfg, batch))
        self.cfg = cfg
        m = model(cfg)
        m.init_params = lambda generator, device=None: weights
        self.trainer = Trainer(m, hp, batch_size=batch, device=device)
        self.data, self.layout = packed(cfg, rows)

    def step(self, idx):
        return self.trainer.fit_on_batch(self.data, idx, self.layout)

    @property
    def params(self):
        return self.trainer.state.params

    def first_grads(self, p0):
        """The first step's gradient as the optimizer got it, from its state
        after that step: Adam's first moment over (1 - b1); for SGD the
        change of the params over the first learning rate."""
        opt, state = self.trainer.optimizer, self.trainer.state
        if self.cfg["optimizer"]["name"] == "adam":
            return {k: m / (1 - opt.b1) for k, m in state.opt_state.mu.items()}
        lr = float(self.cfg["optimizer"]["schedule"]["lr"])
        return {k: (p0[k] - p) / lr for k, p in state.params.items()}


class ScoreProgram:
    """``serving.Predictor.predict`` with the benchmark's weights."""

    def __init__(self, cfg, traffic, weights, device):
        from recman_tpu_torch.serving import Predictor

        self.predictor = Predictor(model(cfg), weights, batch_size=traffic["batch"],
                                   device=device)

    def predict(self, chunk):
        return self.predictor.predict(chunk)


def set_precision(cfg):
    """Run the program as the configuration states: float32 matrix products
    with TF32 off (the CIN's bf16 products are its kernels' own)."""
    if cfg["precision"]["gemm"] == "f32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

"""What stands in the program's place to show that the check fails: the
control (the plain reference one precision step below the configuration's,
``control_precision``) and the faults a cell can have (a training step
that leaves its state unchanged, half of each batch left out with the mean
taken over the rest, the gradients of a few leaves off in size alone, an
answer altered where it is produced).
"""

from __future__ import annotations

import numpy as np
import torch

from . import spec
from .program import ScoreProgram, TrainProgram
from .reference import steps as ref_steps


class ControlTrain(ref_steps.Stepper):
    """The reference's training steps at the control precision."""

    def __init__(self, cfg, traffic, weights, rows, device):
        super().__init__(cfg, weights, rows, traffic["batch"], cfg["control_precision"])


class ControlScore:
    """The reference's scores at the control precision."""

    def __init__(self, cfg, traffic, weights, device):
        self.cfg, self.params, self.device = cfg, weights, device
        self.fam = ref_steps.family(cfg["reference"])

    def predict(self, chunk):
        cats, dense = spec.field_names(self.cfg)
        cat = torch.stack([torch.as_tensor(chunk[c]) for c in cats], 1).to(self.device)
        x = torch.stack([torch.as_tensor(chunk[c]) for c in dense], 1).to(self.device)
        return ref_steps.predict(self.fam, self.params, cat, x, self.cfg,
                                 self.cfg["control_precision"],
                                 self.cfg["reference_block_rows"]).cpu().numpy()


class FrozenState(TrainProgram):
    """A step that computes its loss and returns the state unchanged."""

    def step(self, idx):
        state = self.trainer.state
        loss = super().step(idx)
        self.trainer.state = state
        return loss


class HalfBatch(TrainProgram):
    """Each step on the first half of its batch, the rest padding."""

    def step(self, idx):
        half = idx.clone()
        half[idx.shape[0] // 2:] = -1
        return super().step(half)


class ScaledGrad(TrainProgram):
    """The gradient of each matrix other than the tables, as the optimizer
    gets it, ``SCALE`` times its size: a backward kernel's weight gradient
    off by a constant factor. Adam's first update does not change."""

    SCALE = 1.01

    def __init__(self, cfg, traffic, weights, rows, device):
        super().__init__(cfg, traffic, weights, rows, device)
        opt, tables = self.trainer.optimizer, cfg["num_buckets"] + 1
        update = opt.update
        scaled = {k for k, v in weights.items() if v.dim() == 2 and v.shape[0] != tables}

        def off(grads, state, params):
            return update({k: g * self.SCALE if k in scaled else g for k, g in grads.items()},
                          state, params)

        opt.update = off


class AlteredAnswer(ScoreProgram):
    """Each request's first score turned into its complement."""

    def predict(self, chunk):
        out = np.array(super().predict(chunk))
        out[0] = 1.0 - out[0]
        return out


PROGRAMS = {"control": {"train": ControlTrain, "score_closed": ControlScore},
            "frozen": {"train": FrozenState},
            "half_batch": {"train": HalfBatch},
            "scaled_grad": {"train": ScaledGrad},
            "altered": {"score_closed": AlteredAnswer}}

"""Batch normalization over 2-D activations.

Counterpart of ``recman_tpu/layers/batchnorm.py`` (which no model uses;
the JAX package exports it): the batch's moments in training, with an
EMA of them carried in a separate state dict, the EMA's moments at
inference. The variance is the population variance (ddof 0, as
``jnp.var``), eps 1e-3 is added inside the square root, and the EMA's
momentum is 0.99. Param names ``{prefix}scale`` / ``{prefix}beta``;
state ``{prefix}bn_mean`` / ``{prefix}bn_var``.
"""

from __future__ import annotations

import torch


class BatchNormalization:
    def __init__(self, units, epsilon=1e-3, momentum=0.99, prefix=""):
        self.units = units
        self.epsilon = epsilon
        self.momentum = momentum
        self.prefix = prefix

    def init(self, generator=None, device=None) -> dict:
        return {
            f"{self.prefix}scale": torch.ones((self.units,), dtype=torch.float32, device=device),
            f"{self.prefix}beta": torch.zeros((self.units,), dtype=torch.float32, device=device),
        }

    def init_state(self, device=None) -> dict:
        return {
            f"{self.prefix}bn_mean": torch.zeros((self.units,), dtype=torch.float32,
                                                 device=device),
            f"{self.prefix}bn_var": torch.ones((self.units,), dtype=torch.float32, device=device),
        }

    def apply(self, params, state, inputs, training=False):
        """-> (normalized, new_state); in eval mode the state is read and
        returned as it is."""
        assert inputs.dim() == 2
        p = self.prefix
        if training:
            mean = inputs.mean(dim=0)
            var = inputs.var(dim=0, correction=0)
            m = self.momentum
            state = {f"{p}bn_mean": m * state[f"{p}bn_mean"] + (1 - m) * mean,
                     f"{p}bn_var": m * state[f"{p}bn_var"] + (1 - m) * var}
        else:
            mean, var = state[f"{p}bn_mean"], state[f"{p}bn_var"]
        inv = torch.reciprocal(torch.sqrt(var + self.epsilon))
        return (inputs - mean) * inv * params[f"{p}scale"] + params[f"{p}beta"], state

"""Weight initializers on an explicit ``torch.Generator``.

The same distributions as ``recman_tpu/utils/initializers.py``: Glorot
and He normal are normals truncated at ±2σ (σ of the untruncated
distribution, as tf.random.truncated_normal), Glorot and He uniform are
U(-b, b). The draws differ from ``jax.random`` for the same seed, so
parity with the JAX package goes through ``convert.params_from_jax``, not
through the seed.

Values are drawn on the generator's device and then moved to ``device``.
A ``utils.jax_random.JaxKey`` in the generator's place draws the values
``jax.random`` draws from that key (on the host). On the ``meta`` device
nothing is drawn: the tensors have their shapes and no values.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .jax_random import JaxKey, truncated_normal, uniform


def calc_fan(weight_shape):
    """Fan-in/fan-out (reference utils.py:156-165)."""
    if len(weight_shape) == 2:
        fan_in, fan_out = weight_shape
    elif len(weight_shape) in (3, 4):
        in_ch, out_ch = weight_shape[-2:]
        kernel_size = int(np.prod(weight_shape[:-2]))
        fan_in, fan_out = in_ch * kernel_size, out_ch * kernel_size
    else:
        raise ValueError(f"unsupported weight shape {weight_shape}")
    return fan_in, fan_out


def _empty(generator, shape, device):
    meta = device is not None and torch.device(device).type == "meta"
    return torch.empty(tuple(shape), dtype=torch.float32,
                       device="meta" if meta else generator.device)


def _truncated_normal(generator, shape, std, device):
    """σ·N(0, 1) truncated at ±2 (the reference's ``std * truncated_normal``)."""
    if isinstance(generator, JaxKey):
        out = np.float32(std) * truncated_normal(generator, -2.0, 2.0, tuple(shape))
        return torch.from_numpy(out).to(device)
    out = _empty(generator, shape, device)
    torch.nn.init.trunc_normal_(
        out, mean=0.0, std=std, a=-2.0 * std, b=2.0 * std, generator=generator
    )
    return out.to(device) if device is not None else out


def _uniform(generator, shape, b, device):
    """U(-b, b)."""
    if isinstance(generator, JaxKey):
        return torch.from_numpy(uniform(generator, tuple(shape), -b, b)).to(device)
    out = _empty(generator, shape, device).uniform_(-b, b, generator=generator)
    return out.to(device) if device is not None else out


def glorot_normal(generator: torch.Generator, shape, gain=1.0, device=None):
    """Truncated-normal Glorot at ±2σ (reference utils.py:180-183)."""
    fan_in, fan_out = calc_fan(shape)
    return _truncated_normal(generator, shape, gain * math.sqrt(2.0 / (fan_in + fan_out)),
                             device)


def glorot_uniform(generator: torch.Generator, shape, gain=1.0, device=None):
    """Uniform Glorot (reference utils.py:186-189)."""
    fan_in, fan_out = calc_fan(shape)
    return _uniform(generator, shape, gain * math.sqrt(6.0 / (fan_in + fan_out)), device)


def he_normal(generator: torch.Generator, shape, device=None):
    """Truncated-normal He at ±2σ, σ = √(2/fan_in) (reference utils.py:174-177)."""
    fan_in, _ = calc_fan(shape)
    return _truncated_normal(generator, shape, math.sqrt(2.0 / fan_in), device)


def he_uniform(generator: torch.Generator, shape, device=None):
    """Uniform He, b = √(6/fan_in) (reference utils.py:168-171)."""
    fan_in, _ = calc_fan(shape)
    return _uniform(generator, shape, math.sqrt(6.0 / fan_in), device)

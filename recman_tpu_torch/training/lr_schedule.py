"""Large-batch learning-rate recipes.

Counterpart of ``recman_tpu/training/lr_schedule.py``: linear or sqrt
scaling of a small-batch learning rate, a linear warmup from 0 and a
constant, cosine or linear decay after it, and LAMB with its trust ratio
kept to the dense tower matrices.

A schedule is a plain function from an int step count to a float32
value, usable as the ``learning_rate`` of any optimizer from
``training.create_optimizer``. It reproduces optax's ``linear_schedule``,
``constant_schedule``, ``cosine_decay_schedule`` (alpha 0, exponent 1)
and ``join_schedules`` (which hands the later schedule ``step -
boundary``), computing in float32 where jnp does.
"""

from __future__ import annotations

import math

import numpy as np

_f32 = np.float32


def linear_schedule(init_value: float, end_value: float, transition_steps: int):
    """optax.linear_schedule: init -> end over ``transition_steps``, then
    end (a constant init when ``transition_steps <= 0``)."""
    if transition_steps <= 0:
        return lambda count: _f32(init_value)

    def schedule(count):
        c = min(max(int(count), 0), transition_steps)
        frac = _f32(1) - _f32(c) / _f32(transition_steps)
        return _f32(init_value - end_value) * frac + _f32(end_value)

    return schedule


def constant_schedule(value: float):
    """optax.constant_schedule."""
    return lambda count: _f32(value)


def cosine_decay_schedule(init_value: float, decay_steps: int):
    """optax.cosine_decay_schedule with alpha 0 and exponent 1: init *
    (1 + cos(pi * min(count, decay_steps) / decay_steps)) / 2."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, got {decay_steps}")

    def schedule(count):
        c = _f32(min(int(count), decay_steps))
        decayed = _f32(0.5) * (_f32(1) + np.cos(_f32(math.pi) * c / _f32(decay_steps)))
        return _f32(init_value) * decayed

    return schedule


def join_schedules(schedules, boundaries):
    """optax.join_schedules: the i-th schedule from boundary i-1 on, given
    ``step - boundary``."""

    def schedule(step):
        out = schedules[0](step)
        for boundary, later in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = later(step - boundary)
        return out

    return schedule


def linear_scaled_lr(base_lr: float, batch_size: int, base_batch_size: int = 256) -> float:
    """lr scaled linearly with batch size [Goyal et al.]."""
    return base_lr * (batch_size / base_batch_size)


def sqrt_scaled_lr(base_lr: float, batch_size: int, base_batch_size: int = 256) -> float:
    """lr scaled with sqrt(batch), the softer rule for Adam-family
    optimizers."""
    return base_lr * (batch_size / base_batch_size) ** 0.5


def warmup_schedule(peak_lr: float, warmup_steps: int, total_steps: int | None = None,
                    decay: str = "none"):
    """Linear warmup 0 -> peak, then constant, cosine or linear decay."""
    warm = linear_schedule(0.0, peak_lr, max(warmup_steps, 1))
    if decay == "none" or total_steps is None:
        return join_schedules([warm, constant_schedule(peak_lr)], [warmup_steps])
    rest = max(total_steps - warmup_steps, 1)
    if decay == "cosine":
        tail = cosine_decay_schedule(peak_lr, rest)
    elif decay == "linear":
        tail = linear_schedule(peak_lr, 0.0, rest)
    else:
        raise ValueError(f"unknown decay {decay!r}")
    return join_schedules([warm, tail], [warmup_steps])


def large_batch_schedule(base_lr: float, batch_size: int, base_batch_size: int,
                         warmup_steps: int, total_steps: int | None = None,
                         decay: str = "cosine"):
    """The whole recipe: linear scaling, warmup, decay."""
    return warmup_schedule(linear_scaled_lr(base_lr, batch_size, base_batch_size),
                           warmup_steps, total_steps, decay)


def lamb_partitioned(learning_rate, exclude_1d: bool = True, exclude_tables: bool = True,
                     weight_decay: float = 0.0):
    """LAMB with the trust ratio kept to the dense tower matrices: every
    1-D param (``exclude_1d``) and every ``*_feat_embed`` table
    (``exclude_tables``) takes plain Adam at the same schedule, since a
    large, batch-sparsely updated param's norm would rescale its update
    wildly."""
    from .train_step import Adam, Lamb, MultiTransform

    def label(params):
        return {
            k: "adam" if (exclude_1d and v.dim() <= 1)
            or (exclude_tables and k.endswith("_feat_embed")) else "lamb"
            for k, v in params.items()
        }

    return MultiTransform({"lamb": Lamb(learning_rate, weight_decay=weight_decay),
                           "adam": Adam(learning_rate)}, label)

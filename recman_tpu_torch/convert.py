"""Carry a reference param dict or train state into the port.

The port keeps the reference's flat parameter names and shapes
(vocab-length vectors stay 1-D), so a dict from the JAX package's
``init_params`` or checkpoint — converted to numpy on the JAX side, since
this package never imports JAX — maps name for name onto torch tensors.
``state_from_jax`` carries a whole TrainState (params, optimizer state,
step): the migration path from a TPU run to the card.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .device import resolve_device


def _tensor(value, device) -> torch.Tensor:
    """A numpy array (ml_dtypes' bfloat16 included) as a torch tensor."""
    arr = np.array(value, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_jax(np_params: Mapping[str, np.ndarray], device=None) -> dict:
    """{name: numpy array} -> {name: torch tensor} on ``device`` (default
    CUDA; raises without a GPU unless ``device="cpu"``), same names,
    shapes and dtypes."""
    device = resolve_device(device)
    return {name: _tensor(value, device) for name, value in np_params.items()}


# the port's name of an optax state field where the two differ
_OPTAX_FIELDS = {"acc": ("sum_of_squares", "trace")}


def _optax_fields(node) -> dict:
    """Field name -> value over an optax state with numpy leaves: a chain's
    tuple of states, ``MaskedState`` wrappers (``inner_state``) and the
    states' NamedTuples, the first occurrence of a name kept (an Adam
    count before a schedule's: both count the same updates)."""
    out = {}
    if hasattr(node, "_fields"):
        for f in node._fields:
            v = getattr(node, f)
            for k, x in (_optax_fields(v).items() if f == "inner_state" else [(f, v)]):
                out.setdefault(k, x)
    elif isinstance(node, (tuple, list)):
        for x in node:
            for k, v in _optax_fields(x).items():
                out.setdefault(k, v)
    return out


def _param_tree(template: dict, src, where: str) -> dict:
    """A param-keyed dict of the port's state from the optax one: tensors on
    the template's devices, the port's MaskedNode where the template has
    it."""
    from .training.train_step import MASKED

    out = {}
    for k, t in template.items():
        if t is MASKED:
            out[k] = MASKED
            continue
        v = _tensor(src[k], t.device)
        if v.shape != t.shape or v.dtype != t.dtype:
            raise ValueError(f"{where}/{k}: JAX gives {tuple(v.shape)} {v.dtype}, the port "
                             f"expects {tuple(t.shape)} {t.dtype}")
        out[k] = v
    return out


def _opt_state_from_jax(template, node, step: int, where="opt_state"):
    """The port's optimizer state (``template``'s structure) filled from an
    optax state by field name. A count optax does not keep (a float
    learning rate's adagrad or sgd) is the step: the port's count is the
    number of updates."""
    fields = _optax_fields(node)
    values = []
    for f in template._fields:
        t = getattr(template, f)
        if f == "inner_states":
            values.append({label: _opt_state_from_jax(sub, fields[f][label], step,
                                                      f"{where}/{label}")
                           for label, sub in t.items()})
        elif f == "count":
            values.append(torch.tensor(int(np.asarray(fields.get("count", step))),
                                       dtype=t.dtype, device=t.device))
        elif t is None:
            values.append(None)
        else:
            name = next(n for n in _OPTAX_FIELDS.get(f, (f,)) if n in fields)
            values.append(_param_tree(t, fields[name], f"{where}/{f}"))
    return type(template)(*values)


def state_from_jax(np_params: Mapping[str, np.ndarray], np_opt_state, step, optimizer,
                   device=None, seed=0):
    """A JAX TrainState's leaves as numpy -> the port's ``TrainState`` on
    ``device`` (default CUDA).

    ``np_opt_state`` is the JAX state's ``opt_state`` with numpy leaves
    (``jax.tree.map(np.asarray, state.opt_state)``): the optax state of
    ``optimizer``'s counterpart in the reference's menu (adam, adam_bf16m,
    adagrad, sgd, momentum, lamb, rowwise_adam, lamb_partitioned), read by
    field name into the structure ``optimizer.init`` gives. ``step`` is the
    JAX step. JAX's PRNG key has no torch counterpart: the dropout
    generator is fresh, seeded ``seed`` on ``device``."""
    from .training.train_step import TrainState

    device = resolve_device(device)
    params = params_from_jax(np_params, device)
    step = int(np.asarray(step))
    opt_state = _opt_state_from_jax(optimizer.init(params), np_opt_state, step)
    return TrainState(params, opt_state, step, torch.Generator(device=device).manual_seed(seed))

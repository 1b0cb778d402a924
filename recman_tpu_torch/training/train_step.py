"""Optimizer, train state and train steps.

Counterpart of ``recman_tpu/training/train_step.py``: one step is

    state, loss = step(state, data, idx)

with ``data`` the whole encoded dataset on the device and ``idx`` one
batch of row indices, -1-padded to a fixed batch size (padded rows get
loss weight 0). The reference jits and donates the step; here it runs
eagerly, and an unrolled step, an epoch and an eval scan are Python
loops over index rows.

Stacked storage (reference :227-356): the packed layer's same-shape
tables live as ONE (T, V, k) leaf under ``STACKED_KEY``; the stacked step
runs the loss inside ``ops.embedding.stacked_tables``, so the lookups'
backward (one K3 launch) reaches the leaf unsplit and Adam updates the
tables as one tensor.

The optimizer is Adam written with plain PyTorch ops (the reference
leaves it to XLA): optax's ``scale_by_adam`` exactly, then -lr.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.embedding import stacked_tables


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: an int32 step count and the first and
    second moments, param-shaped dicts."""

    count: torch.Tensor
    mu: dict
    nu: dict


# optax.adam's defaults, fixed: scale_by_adam(b1, b2, eps, eps_root)
B1 = 0.9
B2 = 0.999
EPS = 1e-8
EPS_ROOT = 0.0


class Adam:
    """optax.adam(learning_rate) with its defaults (B1, B2, EPS, EPS_ROOT
    above), bias correction by the int32 count, and the update
    -lr * m_hat / (sqrt(v_hat + eps_root) + eps). Each line rounds where
    optax's does, in the params' dtype."""

    def __init__(self, learning_rate):
        self.learning_rate = learning_rate

    def init(self, params: dict) -> AdamState:
        device = next(iter(params.values())).device
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu={k: torch.zeros_like(v) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()},
        )

    def update(self, grads: dict, state: AdamState, params=None):
        """(grads, state) -> (updates, new state), as optax's update_fn."""
        del params
        mu = {k: (1 - B1) * g + B1 * state.mu[k] for k, g in grads.items()}
        nu = {k: (1 - B2) * (g * g) + B2 * state.nu[k] for k, g in grads.items()}
        count = state.count + 1
        one = torch.ones((), dtype=torch.float32, device=count.device)
        bc1 = 1 - (one * B1) ** count
        bc2 = 1 - (one * B2) ** count
        step = -self.learning_rate
        updates = {
            k: (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2 + EPS_ROOT) + EPS) * step
            for k in grads
        }
        return updates, AdamState(count, mu, nu)


def apply_updates(params: dict, updates: dict) -> dict:
    """params + updates, leaf by leaf (optax.apply_updates)."""
    return {k: p + updates[k].to(p.dtype) for k, p in params.items()}


def create_optimizer(optimizer, learning_rate):
    """Name -> optimizer. Only "adam" is ported; an optimizer object passes
    through."""
    if not isinstance(optimizer, str):
        return optimizer
    if optimizer.lower() == "adam":
        return Adam(learning_rate)
    raise NotImplementedError(
        f"optimizer {optimizer!r} not ported yet (ROADMAP.md queue 1, item 8)"
    )


class TrainState(NamedTuple):
    """Carried training state. ``generator`` draws the dropout masks, on
    the params' device."""

    params: dict
    opt_state: AdamState
    step: int
    generator: torch.Generator | None


def init_state(model, optimizer, generator: torch.Generator, device=None) -> TrainState:
    """Params from ``generator`` on ``device`` (default CUDA; raises without
    a GPU unless ``device="cpu"``), zero optimizer state, step 0, and a
    dropout generator on ``device`` seeded from ``generator``."""
    device = resolve_device(device)
    params = model.init_params(generator, device)
    seed = int(torch.randint(0, 2**62, (), generator=generator))
    dropout_gen = torch.Generator(device=device).manual_seed(seed)
    return TrainState(params, optimizer.init(params), 0, dropout_gen)


def gather_batch(data: dict, idx: torch.Tensor) -> tuple[dict, torch.Tensor]:
    """Rows ``idx`` of every tensor in ``data``. idx < 0 is padding: those
    rows read row 0 and get weight 0. Returns (batch, weights)."""
    weights = (idx >= 0).to(torch.float32)
    safe = idx.clamp_min(0)
    return {k: v.index_select(0, safe) for k, v in data.items()}, weights


# -- dataset packing --------------------------------------------------------
# All int columns in one (N, Ci) matrix and all float columns in one
# (N, Cf) matrix: two gathers a batch instead of one per feature.

PACKED_I32 = "__packed_i32"
PACKED_F32 = "__packed_f32"


def pack_dataset(data: dict) -> tuple[dict, tuple]:
    """Host-side: concat feature columns by dtype (numpy). Returns (packed
    dict, layout), layout a tuple of (name, key, start, width, squeeze)
    for ``unpack_batch``."""
    packed: dict = {}
    layout = []
    cols_by_key = {PACKED_I32: [], PACKED_F32: []}
    n = None
    for name, arr in data.items():
        arr = np.asarray(arr)
        if name == "y" or arr.ndim > 2:
            packed[name] = arr
            continue
        n = arr.shape[0]
        key = PACKED_I32 if np.issubdtype(arr.dtype, np.integer) else PACKED_F32
        width = 1 if arr.ndim == 1 else arr.shape[1]
        start = sum(w for _, w in cols_by_key[key])
        cols_by_key[key].append((arr, width))
        layout.append((name, key, start, width, arr.ndim == 1))
    for key, cols in cols_by_key.items():
        if not cols:
            continue
        dtype = np.int32 if key == PACKED_I32 else np.float32
        if all(w == 1 for _, w in cols):
            packed[key] = np.stack([arr.astype(dtype, copy=False) for arr, _ in cols], axis=1)
            continue
        out = np.empty((n, sum(w for _, w in cols)), dtype=dtype)
        s = 0
        for arr, w in cols:
            if arr.ndim == 1:
                out[:, s] = arr
            else:
                out[:, s: s + w] = arr
            s += w
        packed[key] = out
    return packed, tuple(layout)


def unpack_batch(batch: dict, layout) -> dict:
    """Column slices back to the per-feature batch dict."""
    out = {k: v for k, v in batch.items() if k not in (PACKED_I32, PACKED_F32)}
    for name, key, start, width, squeeze in layout:
        col = batch[key][:, start: start + width]
        out[name] = col[:, 0] if squeeze else col
    return out


# -- loss, gradients, steps --------------------------------------------------

STACKED_KEY = "__stacked_feat_embed"


def loss_and_grads(model, params: dict, batch: dict, weights=None, generator=None,
                   names: tuple | None = None) -> tuple[torch.Tensor, dict]:
    """The training loss and the gradient of every param (zeros for a
    param the loss does not use). With ``names`` the params are in
    stacked storage and the loss runs under ``stacked_tables``."""
    keys = list(params)
    leaves = [params[k].detach().requires_grad_(True) for k in keys]
    live = dict(zip(keys, leaves))
    ctx = stacked_tables(names, live[STACKED_KEY]) if names else contextlib.nullcontext()
    with ctx:
        loss = model.loss(live, batch, training=True, generator=generator, weights=weights)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), {
        k: torch.zeros_like(p) if g is None else g for k, p, g in zip(keys, leaves, grads)
    }


def _one_step(model, optimizer, state: TrainState, data: dict, idx, layout=(),
              names=None) -> tuple[TrainState, torch.Tensor]:
    batch, weights = gather_batch(data, idx)
    if layout:
        batch = unpack_batch(batch, layout)
    loss, grads = loss_and_grads(model, state.params, batch, weights, state.generator, names)
    with torch.no_grad():
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = apply_updates(state.params, updates)
    return TrainState(params, opt_state, state.step + 1, state.generator), loss


def make_train_step(model, optimizer):
    """(state, data, idx (B,), layout=()) -> (state, loss): one step
    (reference :191-200)."""

    def step_fn(state: TrainState, data: dict, idx, layout=()):
        return _one_step(model, optimizer, state, data, idx, layout)

    return step_fn


def make_train_epoch(model, optimizer):
    """(state, data, idx_mat (steps, B), layout=()) -> (state, (steps,)
    losses): the steps of a whole epoch (the reference's lax.scan,
    :359-377, is a loop here)."""

    def epoch_fn(state: TrainState, data: dict, idx_mat, layout=()):
        losses = []
        for idx in idx_mat:
            state, loss = _one_step(model, optimizer, state, data, idx, layout)
            losses.append(loss)
        return state, torch.stack(losses)

    return epoch_fn


def _eval_forward(model, params, data, idx, override, training, layout, generator):
    batch, _ = gather_batch(data, idx)
    if layout:
        batch = unpack_batch(batch, layout)
    return model.apply(params, batch, training=training, generator=generator,
                       linear_override=override)


def _eval_generator(params, training):
    """Dropout generator of an eval with ``training=True``: seeded 0 on the
    params' device, where the reference passes PRNGKey(0)."""
    if not training:
        return None
    return torch.Generator(device=next(iter(params.values())).device).manual_seed(0)


def make_eval_step(model):
    """(params, data, idx (B,), override, training, layout=()) -> (B,)
    predictions (reference :409-425). ``training=True`` keeps dropout live
    (the reference's in-fit eval quirk)."""

    def step_fn(params, data, idx, override, training: bool, layout=()):
        with torch.no_grad():
            return _eval_forward(model, params, data, idx, override, training, layout,
                                 _eval_generator(params, training))

    return step_fn


def make_eval_scan(model):
    """(params, data, idx_mat (batches, B), override, training, layout=())
    -> flat (batches * B,) predictions: the reference's lax.scan
    (:379-406) as a loop over the index rows; the caller drops the
    padding tail."""

    def scan_fn(params, data, idx_mat, override, training: bool, layout=()):
        generator = _eval_generator(params, training)
        with torch.no_grad():
            return torch.cat([
                _eval_forward(model, params, data, idx, override, training, layout, generator)
                for idx in idx_mat
            ])

    return scan_fn


def _unrolled(model, optimizer, unroll: int, names):
    assert unroll >= 1

    def step_fn(state: TrainState, data: dict, idx_mat, layout=()):
        losses = []
        for i in range(unroll):
            state, loss = _one_step(model, optimizer, state, data, idx_mat[i], layout, names)
            losses.append(loss)
        return state, torch.stack(losses)

    return step_fn


def make_train_step_unrolled(model, optimizer, unroll: int):
    """(state, data, idx_mat (unroll, B), layout=()) -> (state, (unroll,)
    losses): ``unroll`` consecutive steps."""
    return _unrolled(model, optimizer, unroll, None)


def make_train_step_stacked(model, optimizer, unroll: int, names: tuple):
    """``make_train_step_unrolled`` over stacked-storage params (start the
    state from ``stack_table_params`` or ``stack_train_state``)."""
    return _unrolled(model, optimizer, unroll, tuple(names))


# -- stacked same-shape table storage ---------------------------------------


def stack_table_params(model, params) -> tuple[dict, tuple] | None:
    """Per-table params -> (stacked-storage params, names), or None if the
    model has no eligible packed group (PackedEmbeddingLinear.stackable)."""
    packed = getattr(model, "packed", None)
    names = packed.stackable() if packed is not None else None
    if not names:
        return None
    prefix = model.embeddings.prefix
    keys = {f"{prefix}{n}_feat_embed" for n in names}
    out = {k: v for k, v in params.items() if k not in keys}
    out[STACKED_KEY] = torch.stack([params[f"{prefix}{n}_feat_embed"] for n in names])
    return out, names


def unstack_table_params(model, params) -> dict:
    """Stacked-storage params -> the reference-parity per-table dict. A
    no-op for per-table params."""
    if STACKED_KEY not in params:
        return dict(params)
    names = model.packed.stackable()
    prefix = model.embeddings.prefix
    out = {k: v for k, v in params.items() if k != STACKED_KEY}
    stack = params[STACKED_KEY]
    for i, n in enumerate(names):
        out[f"{prefix}{n}_feat_embed"] = stack[i]
    return out


def stack_train_state(model, state: TrainState) -> TrainState:
    """Per-table -> stacked storage for the params and Adam's moments.
    Pure reshaping."""
    res = stack_table_params(model, state.params)
    if res is None:
        return state
    opt = state.opt_state
    opt = AdamState(opt.count, stack_table_params(model, opt.mu)[0],
                    stack_table_params(model, opt.nu)[0])
    return TrainState(res[0], opt, state.step, state.generator)


def unstack_train_state(model, state: TrainState) -> TrainState:
    """Inverse of ``stack_train_state`` (a no-op on per-table states)."""
    if STACKED_KEY not in state.params:
        return state
    opt = state.opt_state
    opt = AdamState(opt.count, unstack_table_params(model, opt.mu),
                    unstack_table_params(model, opt.nu))
    return TrainState(unstack_table_params(model, state.params), opt, state.step,
                      state.generator)

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

The optimizers are the reference's menu (``create_optimizer``) written
with plain PyTorch ops (the reference leaves them to optax and XLA), each
rounding where optax rounds; every one takes a float or a schedule
(``training/lr_schedule.py``) as its learning rate.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.embedding import stacked_tables
from ..utils import JaxKey
from ..utils.sharded_run import current_run


class MaskedNode(NamedTuple):
    """optax's MaskedNode: the entry of a param that a partitioned
    optimizer (``MultiTransform``) leaves to another of its transforms."""


MASKED = MaskedNode()


def _tmap(fn, tree, *rest):
    """fn over the tensor entries of param-keyed dicts, MASKED passed
    through (jax.tree.map over a tree holding optax MaskedNodes)."""
    return {k: MASKED if v is MASKED else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def _zero_count() -> torch.Tensor:
    """An optimizer's int32 step count. It lives on the CPU whatever the
    params' device: a schedule reads it on the host every step, which a
    count on the card would make wait for the card, and the bias
    corrections computed from it enter the card's kernels as scalars."""
    return torch.zeros((), dtype=torch.int32)


def _f32(x, count) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=count.device)


def _lr_scale(learning_rate, count: torch.Tensor):
    """optax.scale_by_learning_rate's factor, -lr: a schedule is read at
    the transform's count before it increments (so the first update of a
    warmup from 0 is exactly 0), as a float32 value."""
    if callable(learning_rate):
        return -_f32(float(learning_rate(int(count))), count)
    return -learning_rate


def _scale(updates: dict, factor) -> dict:
    """updates * factor, a tensor factor cast to each update's dtype (optax
    scale / scale_by_schedule)."""
    if isinstance(factor, torch.Tensor):
        return _tmap(lambda u: factor.to(u.dtype) * u, updates)
    return _tmap(lambda u: factor * u, updates)


def _weak(x: float, t: torch.Tensor):
    """A Python scalar as jnp takes it beside a tensor of another float
    dtype: rounded to that dtype (a float stays a Python float for f32,
    where PyTorch rounds it the same way)."""
    return x if t.dtype == torch.float32 else torch.tensor(x, dtype=t.dtype, device=t.device)


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """1 - decay ** count in float32 (optax.tree.bias_correction)."""
    return 1 - _f32(decay, count) ** count


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: an int32 step count and the first and
    second moments, param-shaped dicts. The count is also the schedule's:
    both start at 0 and increment once an update."""

    count: torch.Tensor
    mu: dict
    nu: dict


# optax.adam's defaults: scale_by_adam(b1, b2, eps, eps_root)
B1 = 0.9
B2 = 0.999
EPS = 1e-8
EPS_ROOT = 0.0


def _scale_by_adam(grads, state: AdamState, b1, b2, eps, eps_root, mu_dtype):
    """optax.scale_by_adam: (updates, new state). mu is updated in the
    gradients' dtype and stored in ``mu_dtype`` only afterwards. With a
    bf16 mu, b1 * mu is a bf16 product of bf16(b1), as jnp takes a Python
    scalar in the array's dtype."""
    mu = _tmap(lambda g, m: (1 - b1) * g + _weak(b1, m) * m, grads, state.mu)
    nu = _tmap(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, state.nu)
    count = state.count + 1
    bc1, bc2 = _bias_correction(b1, count), _bias_correction(b2, count)
    updates = _tmap(lambda m, v: (m / bc1.to(m.dtype)) / (torch.sqrt(v / bc2.to(v.dtype) + eps_root)
                                                          + eps), mu, nu)
    if mu_dtype is not None:
        mu = _tmap(lambda m: m.to(mu_dtype), mu)
    return updates, AdamState(count, mu, nu)


class Adam:
    """optax.adam(learning_rate, b1, b2, eps, eps_root, mu_dtype):
    scale_by_adam (bias correction by the int32 count, update m_hat /
    (sqrt(v_hat + eps_root) + eps)) then -lr, with ``learning_rate`` a
    float or a schedule. ``mu_dtype=torch.bfloat16`` stores the first
    moment in bf16 (optax's ``mu_dtype``). Each line rounds where optax's
    does, in the params' dtype."""

    def __init__(self, learning_rate, b1=B1, b2=B2, eps=EPS, eps_root=EPS_ROOT, mu_dtype=None):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.mu_dtype = mu_dtype

    def init(self, params: dict) -> AdamState:
        return AdamState(
            count=_zero_count(),
            mu=_tmap(lambda v: torch.zeros_like(v, dtype=self.mu_dtype or v.dtype), params),
            nu=_tmap(torch.zeros_like, params),
        )

    def update(self, grads: dict, state: AdamState, params=None):
        """(grads, state) -> (updates, new state), as optax's update_fn."""
        del params
        lr = _lr_scale(self.learning_rate, state.count)
        updates, state = _scale_by_adam(grads, state, self.b1, self.b2, self.eps,
                                        self.eps_root, self.mu_dtype)
        return _scale(updates, lr), state


class CountState(NamedTuple):
    """The schedule's int32 count and the transform's param-shaped state
    (adagrad's sum of squares, momentum's trace; None for plain sgd)."""

    count: torch.Tensor
    acc: dict | None


class Adagrad:
    """optax.adagrad(learning_rate, initial_accumulator_value=0.1,
    eps=1e-7): scale_by_rss then -lr. The sum of squares starts at the
    initial value; the update is g * rsqrt(sum + eps) where sum > 0."""

    def __init__(self, learning_rate, initial_accumulator_value=0.1, eps=1e-7):
        self.learning_rate = learning_rate
        self.initial, self.eps = initial_accumulator_value, eps

    def init(self, params: dict) -> CountState:
        return CountState(_zero_count(),
                          _tmap(lambda v: torch.full_like(v, self.initial), params))

    def update(self, grads: dict, state: CountState, params=None):
        del params
        lr = _lr_scale(self.learning_rate, state.count)
        acc = _tmap(lambda g, t: g * g + t, grads, state.acc)
        updates = _tmap(lambda t, g: torch.where(t > 0, torch.rsqrt(t + self.eps), 0.0) * g,
                        acc, grads)
        return _scale(updates, lr), CountState(state.count + 1, acc)


class Sgd:
    """optax.sgd(learning_rate, momentum): with a momentum, the trace g +
    momentum * trace (optax.trace, not Nesterov) is the update; then -lr."""

    def __init__(self, learning_rate, momentum=None):
        self.learning_rate = learning_rate
        self.momentum = momentum

    def init(self, params: dict) -> CountState:
        trace = None if self.momentum is None else _tmap(torch.zeros_like, params)
        return CountState(_zero_count(), trace)

    def update(self, grads: dict, state: CountState, params=None):
        del params
        lr = _lr_scale(self.learning_rate, state.count)
        trace = None
        if self.momentum is not None:
            trace = _tmap(lambda g, t: g + self.momentum * t, grads, state.acc)
            grads = trace
        return _scale(grads, lr), CountState(state.count + 1, trace)


def _leaf_norms(updates: dict, params: dict) -> dict:
    """{name: (||param||, ||update||)} per leaf of ``updates``. In a sharded
    run (``utils.sharded_run``) a leaf that the rank holds a block of
    takes the whole leaf's norms: the root of its squares summed over the
    blocks (``MeshRun.sum_over_blocks``)."""
    norms = {k: (torch.linalg.vector_norm(params[k]), torch.linalg.vector_norm(u))
             for k, u in updates.items() if u is not MASKED}
    run = current_run()
    blocked = [k for k in norms if run is not None and run.blocked(k)]
    if blocked:
        sq = torch.stack([torch.stack([params[k].square().sum(), updates[k].square().sum()])
                          for k in blocked])
        summed = torch.sqrt(run.sum_over_blocks(sq))
        norms.update({k: (s[0], s[1]) for k, s in zip(blocked, summed)})
    return norms


class Lamb:
    """optax.lamb(learning_rate, b1=0.9, b2=0.999, eps=1e-6, eps_root=0,
    weight_decay=0): scale_by_adam, + weight_decay * param, the trust
    ratio ||param|| / ||update|| per leaf (1 where either norm is 0), then
    -lr. Under stacked storage the leaf is the whole (T, V, k) stack, as
    in the reference; in a sharded run a blocked leaf's norms are the
    whole leaf's."""

    def __init__(self, learning_rate, b1=B1, b2=B2, eps=1e-6, eps_root=0.0, weight_decay=0.0):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.weight_decay = weight_decay

    def init(self, params: dict) -> AdamState:
        return Adam(self.learning_rate).init(params)

    def update(self, grads: dict, state: AdamState, params=None):
        if params is None:
            raise ValueError("Lamb.update needs the params (trust ratio, weight decay)")
        lr = _lr_scale(self.learning_rate, state.count)
        updates, state = _scale_by_adam(grads, state, self.b1, self.b2, self.eps,
                                        self.eps_root, None)
        updates = _tmap(lambda u, p: u + self.weight_decay * p, updates, params)
        norms = _leaf_norms(updates, params)

        def trust(k, u):
            p_norm, u_norm = norms[k]
            ratio = torch.where((p_norm == 0) | (u_norm == 0), 1.0, p_norm / u_norm)
            return u * ratio

        return _scale({k: u if u is MASKED else trust(k, u) for k, u in updates.items()},
                      lr), state


class MultiTransformState(NamedTuple):
    """optax's MultiTransformState: one inner state per label, each over
    the whole param dict with MASKED where another label's params sit."""

    inner_states: dict


class MultiTransform:
    """optax.multi_transform: each param goes to the transform of its label
    (``label_fn(params)`` -> {name: label}, read from the updates at every
    update, as optax reads it)."""

    def __init__(self, transforms: dict, label_fn):
        self.transforms = transforms
        self.label_fn = label_fn

    def _masked(self, tree: dict, labels: dict, label) -> dict:
        return {k: v if labels[k] == label else MASKED for k, v in tree.items()}

    def init(self, params: dict) -> MultiTransformState:
        labels = self.label_fn(params)
        return MultiTransformState({
            name: t.init(self._masked(params, labels, name))
            for name, t in self.transforms.items()
        })

    def update(self, grads: dict, state: MultiTransformState, params=None):
        labels = self.label_fn(grads)
        updates, inner = {}, {}
        for name, t in self.transforms.items():
            sub_params = None if params is None else self._masked(params, labels, name)
            u, inner[name] = t.update(self._masked(grads, labels, name),
                                      state.inner_states[name], sub_params)
            updates.update({k: v for k, v in u.items() if v is not MASKED})
        return updates, MultiTransformState(inner)


def apply_updates(params: dict, updates: dict) -> dict:
    """params + updates, leaf by leaf (optax.apply_updates)."""
    return {k: p + updates[k].to(p.dtype) for k, p in params.items()}


def create_optimizer(optimizer, learning_rate):
    """Name -> optimizer (the reference's menu, :26-57): adam, adam_bf16m
    (Adam with a bf16 first moment), adagrad, gd / sgd, momentum (sgd with
    0.9), lamb, rowwise_adam. ``learning_rate`` is a float or a schedule.
    An optimizer object passes through."""
    if not isinstance(optimizer, str):
        return optimizer
    name = optimizer.lower()
    if name == "adam":
        return Adam(learning_rate)
    if name == "adam_bf16m":
        return Adam(learning_rate, mu_dtype=torch.bfloat16)
    if name == "adagrad":
        return Adagrad(learning_rate)
    if name in ("gd", "sgd"):
        return Sgd(learning_rate)
    if name == "momentum":
        return Sgd(learning_rate, momentum=0.9)
    if name == "lamb":
        return Lamb(learning_rate)
    if name == "rowwise_adam":
        from .rowwise_adam import rowwise_adam

        return rowwise_adam(learning_rate)
    raise ValueError(f"unknown optimizer {optimizer!r}")


class TrainState(NamedTuple):
    """Carried training state. ``generator`` draws the dropout masks, on
    the params' device."""

    params: dict
    opt_state: NamedTuple
    step: int
    generator: torch.Generator | None


def init_state(model, optimizer, generator, device=None) -> TrainState:
    """Params from ``generator`` on ``device`` (default CUDA; raises without
    a GPU unless ``device="cpu"``), zero optimizer state, step 0, and a
    dropout generator on ``device`` seeded from ``generator``. A
    ``utils.JaxKey`` is split as the reference's ``init_state`` splits its
    key, so the params are the reference's for the same key."""
    device = resolve_device(device)
    params, seed = init_params_and_seed(model, generator, device)
    dropout_gen = torch.Generator(device=device).manual_seed(seed)
    return TrainState(params, optimizer.init(params), 0, dropout_gen)


def init_params_and_seed(model, generator, device):
    """``init_state``'s params on ``device`` and its dropout generator's
    seed, from a torch.Generator or a ``utils.JaxKey``."""
    if isinstance(generator, JaxKey):
        init_key, state_key = generator.split(2)
        hi, lo = state_key.words
        return model.init_params(init_key, device), ((hi << 32) | lo) % 2**62
    params = model.init_params(generator, device)
    return params, int(torch.randint(0, 2**62, (), generator=generator))


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


def value_and_grads(objective, params: dict) -> tuple[torch.Tensor, dict]:
    """(objective(live params), {name: gradient}), zeros for a param the
    objective does not use."""
    keys = list(params)
    leaves = [params[k].detach().requires_grad_(True) for k in keys]
    value = objective(dict(zip(keys, leaves)))
    grads = torch.autograd.grad(value, leaves, allow_unused=True)
    return value.detach(), {
        k: torch.zeros_like(p) if g is None else g for k, p, g in zip(keys, leaves, grads)
    }


def loss_and_grads(model, params: dict, batch: dict, weights=None, generator=None,
                   names: tuple | None = None) -> tuple[torch.Tensor, dict]:
    """The training loss and the gradient of every param (zeros for a
    param the loss does not use). With ``names`` the params are in
    stacked storage and the loss runs under ``stacked_tables``."""

    def loss(live):
        ctx = stacked_tables(names, live[STACKED_KEY]) if names else contextlib.nullcontext()
        with ctx:
            return model.loss(live, batch, training=True, generator=generator, weights=weights)

    return value_and_grads(loss, params)


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
    keys = [f"{prefix}{n}_feat_embed" for n in names]
    for k in keys:
        if params[k] is MASKED:
            # the reference's jnp.stack fails on optax's MaskedNode here
            raise TypeError(
                f"{k} is masked out of this state: a partitioned optimizer "
                "(rowwise_adam, lamb_partitioned) has no stacked-storage form, "
                "as in the reference (ROADMAP.md section 3)")
    out = {k: v for k, v in params.items() if k not in set(keys)}
    out[STACKED_KEY] = torch.stack([params[k] for k in keys])
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


def _map_param_shaped(tree, param_keys: frozenset, fn):
    """``fn`` on every dict whose key set is ``param_keys``: the
    param-shaped trees inside an optimizer state (Adam's mu and nu,
    adagrad's sum of squares, ...); other nodes recurse (reference
    :266-285)."""
    if isinstance(tree, dict):
        if frozenset(tree) == param_keys:
            return fn(tree)
        return {k: _map_param_shaped(v, param_keys, fn) for k, v in tree.items()}
    if hasattr(tree, "_fields"):  # NamedTuple states
        return type(tree)(*(_map_param_shaped(getattr(tree, f), param_keys, fn)
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_param_shaped(v, param_keys, fn) for v in tree)
    return tree


def stack_train_state(model, state: TrainState) -> TrainState:
    """Per-table -> stacked storage for the params and every param-shaped
    tree of the optimizer state. Pure reshaping."""
    res = stack_table_params(model, state.params)
    if res is None:
        return state
    opt = _map_param_shaped(state.opt_state, frozenset(state.params),
                            lambda d: stack_table_params(model, d)[0])
    return TrainState(res[0], opt, state.step, state.generator)


def unstack_train_state(model, state: TrainState) -> TrainState:
    """Inverse of ``stack_train_state`` (a no-op on per-table states)."""
    if STACKED_KEY not in state.params:
        return state
    opt = _map_param_shaped(state.opt_state, frozenset(state.params),
                            lambda d: unstack_table_params(model, d))
    return TrainState(unstack_table_params(model, state.params), opt, state.step,
                      state.generator)

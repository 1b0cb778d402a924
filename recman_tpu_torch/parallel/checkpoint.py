"""Sharded checkpoints, and one agreed preemption for a mesh of ranks.

The reference's ``ShardedTrainer`` inherits ``save``/``restore`` and the
resilient ``fit``: Orbax writes its sharded TrainState as global arrays
and places them back. The port writes what Orbax holds, in
``ckpt.save_checkpoint``'s layout:

- ``global_state``: every blocked param (``sharding.param_specs``, row or
  tensor-parallel) gathered over the model axis on its spec's dim, row
  padding included, and every optimizer-state leaf that mirrors a blocked
  param (Adam's moments, Adagrad's sums, row-wise Adam's per-row second
  moment) gathered on that param's spec;
- ``save``: global rank 0 of the mesh alone writes; a barrier over the
  mesh ends the save, so no rank goes on before the files are complete;
- ``restore``: every rank reads the global arrays and keeps its blocks.

``MeshResilience`` is the ``training.Resilience`` that every rank of a
mesh runs (``ShardedTrainer.fit`` and ``fit_stream`` take a plain
``Resilience`` as one of its settings). ``training/resilient.py`` is the
reference's file and knows nothing of ranks: each rank would write
``LATEST.json`` and prune, and a SIGTERM that reaches one rank, or reaches
the ranks at different steps, would set the preemption flag on some ranks
only; they would enter the save's gather while the others entered the next
step's collectives, and the world would hang until the group timeout.
``MeshResilience`` agrees on the flag at every step and epoch boundary
with one max all-reduce over the mesh (so every rank checkpoints at the
same step and raises ``Preempted``), and lets global rank 0 alone write
``LATEST.json`` and prune, after the checkpoint's barrier; a second
barrier keeps every rank in the save until ``LATEST.json`` names the new
checkpoint.
"""

from __future__ import annotations

import logging

import torch
import torch.distributed as dist

from ..training.resilient import Resilience
from ..training.train_step import TrainState, _map_param_shaped
from .collectives import _all_reduce
from .mesh import MODEL_AXIS, Sharding
from .sharding import gather_params, global_shape

log = logging.getLogger(__name__)


def is_writer(mesh) -> bool:
    """Whether this rank is the mesh's global rank 0, its one writer."""
    return dist.get_rank() == mesh.ranks[0]


def barrier(mesh, device):
    """Every rank of the mesh reaches this point before any goes on (a
    one-element all-reduce on ``device``, which NCCL and Gloo both take)."""
    _all_reduce(torch.zeros(1, device=device), mesh, "mesh", "barrier")


def _opt_map(state: TrainState, fn):
    return _map_param_shaped(state.opt_state, frozenset(state.params), fn)


def global_state(state: TrainState, mesh, specs: dict) -> TrainState:
    """The TrainState with every blocked leaf whole (module docstring).
    Every rank of the mesh must call it."""
    return TrainState(gather_params(state.params, mesh, specs),
                      _opt_map(state, lambda d: gather_params(d, mesh, specs)),
                      state.step, state.generator)


def _leaves(tree: dict, specs: dict, fn) -> dict:
    return {k: fn(v, specs[k]) if isinstance(v, torch.Tensor) else v for k, v in tree.items()}


def global_template(state: TrainState, mesh, specs: dict) -> TrainState:
    """A TrainState of ``global_state``'s shapes (empty tensors on the CPU;
    no collective), the template ``ckpt.restore_checkpoint`` checks a
    checkpoint against."""
    n = mesh.shape[MODEL_AXIS]

    def empty(v, spec):
        return torch.empty(global_shape(v.shape, spec, n), dtype=v.dtype)

    return TrainState(_leaves(state.params, specs, empty),
                      _opt_map(state, lambda d: _leaves(d, specs, empty)),
                      state.step, state.generator)


def place_state(full: TrainState, mesh, specs: dict, device) -> TrainState:
    """This rank's blocks of a whole TrainState, on ``device``."""
    def local(v, spec):
        return Sharding(mesh, spec).local(v).clone().to(device) if spec else v.to(device)

    return TrainState(_leaves(full.params, specs, local),
                      _opt_map(full, lambda d: _leaves(d, specs, local)),
                      full.step, full.generator)


class MeshResilience(Resilience):
    """A ``Resilience`` that every rank of a mesh runs (the module
    docstring), with the same settings. A captured signal only counts up:
    the flag is set at a boundary, from the max over the mesh of every
    rank's flag, so a signal that lands after one boundary's all-reduce
    counts at the next on every rank alike. A subclass may set
    ``_preempted`` in a boundary method before it calls this class's, where
    the agreement reads it; a signal handler that set it directly could
    set it between the agreement and the boundary's check, on one rank."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._signals = 0
        self._signals_seen = 0

    def _on_signal(self, signum, frame):
        log.warning("Resilience: captured signal %s — the mesh checkpoints at the "
                    "next step boundary and stops", signum)
        self._signals += 1

    def _agree(self, trainer):
        mine = self._preempted or self._signals > self._signals_seen
        self._signals_seen = self._signals
        flag = torch.tensor([int(mine)], device=trainer.device)
        self._preempted = bool(_all_reduce(flag, trainer.mesh, "mesh", "preempt", op="max"))

    def step_boundary(self, trainer, step, epoch, extra=None):
        self._agree(trainer)
        super().step_boundary(trainer, step, epoch, extra)

    def epoch_boundary(self, trainer, step, epoch, mean_loss, extra=None):
        self._agree(trainer)
        super().epoch_boundary(trainer, step, epoch, mean_loss, extra)

    def save(self, trainer, step, epoch, extra=None):
        if step == self._last_saved_step:
            return
        if is_writer(trainer.mesh):
            super().save(trainer, step, epoch, extra)  # trainer.save, LATEST, prune
        else:
            trainer.save(self._step_dir(step))  # the gather and the barrier
            self._last_saved_step = int(step)
        # no rank reads LATEST.json (a resume, a rollback) before it is written
        barrier(trainer.mesh, trainer.device)


def on_mesh(resilience):
    """``resilience`` as every rank of a mesh runs it: None stays None, a
    ``MeshResilience`` is used as it is, and a plain ``Resilience`` is
    replaced by a ``MeshResilience`` of its settings (the caller's object
    does not see the run's state; pass a ``MeshResilience`` to read it).
    Any other ``Resilience`` subclass is refused: derive it from
    ``MeshResilience``, whose boundaries and save it must run through."""
    if resilience is None or isinstance(resilience, MeshResilience):
        return resilience
    if type(resilience) is not Resilience:
        raise TypeError(f"resilience is a {type(resilience).__name__}: on a mesh, pass a "
                        "training.Resilience or a subclass of parallel.MeshResilience")
    r = resilience
    return MeshResilience(r.directory, every_steps=r.every_steps, every_epochs=r.every_epochs,
                          keep=r.keep, preempt_signals=r.preempt_signals,
                          halt_on_nonfinite=r.halt_on_nonfinite)

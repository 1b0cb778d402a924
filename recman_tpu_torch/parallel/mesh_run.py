"""``MeshRun``: what a row-sharded step's layers need of the mesh.

A row-sharded step opens ``utils.sharded_run(MeshRun(...))`` around its
forward (``train_pjit.sharded_forward``) and its optimizer update; the
code below ``parallel/`` reads it with ``utils.current_run()`` and calls
its methods:

- ``exchange``: the lookups' exchange against this rank's row blocks
  (``ops.embedding.lookup_exchange``), or None;
- ``specs``: the params' resolved specs (``sharding.resolve_specs``),
  which the DNNs' tensor-parallel layers (``layers/dnn.py``) and Lamb's
  norms over blocks (``training/train_step.py``) read, with the model
  axis' collectives below;
- ``batch_moments``: Dice's moments over the data group's whole batch
  (``layers/common.py``), when ``data_moments`` is on.
"""

from __future__ import annotations

import torch

from ..ops.embedding import lookup_exchange
from .collectives import all_reduce, all_reduce_summed, block_of, copy_to_blocks, gather_blocks
from .mesh import DATA_AXIS, MODEL_AXIS


class MeshRun:
    """A sharded run on ``mesh`` (module docstring). ``blocks``: {name: this
    rank's block} of the row-sharded params whose lookups take the
    ``exchange`` ("psum" or "dedup", at ``capacity``), or None for a run
    with no lookups (the optimizer update). ``data_moments``: Dice takes
    its training moments over the data group (a one-wide data axis takes
    them on the rank's rows, which are the whole batch)."""

    def __init__(self, mesh, specs: dict, blocks=None, exchange="psum", capacity=None,
                 data_moments=False):
        self.mesh = mesh
        self.specs = specs
        self.exchange = (None if blocks is None
                         else lookup_exchange(mesh, blocks, capacity=capacity, exchange=exchange))
        self.data_moments = data_moments and mesh.shape[DATA_AXIS] > 1

    # -- Dice ----------------------------------------------------------------
    def batch_moments(self, x):
        """Per-unit mean and population variance of ``x`` over the rows of
        the data group, every rank holding an equal block of them, padded
        rows included, as the reference's partitioner reduces
        ``jnp.mean(x, axis=0)`` over the global batch. Both are sums over
        the data group (``all_reduce_summed``, whose backward sums the
        ranks' cotangents: their objectives are summed)."""
        n = x.shape[0] * self.mesh.shape[DATA_AXIS]
        mean = all_reduce_summed(x.sum(dim=0), self.mesh, DATA_AXIS, "moments") / n
        var = all_reduce_summed(torch.square(x - mean).sum(dim=0), self.mesh, DATA_AXIS,
                                "moments") / n
        return mean, var

    # -- tensor-parallel layers over the model axis --------------------------
    @property
    def model_n(self) -> int:
        return self.mesh.shape[MODEL_AXIS]

    @property
    def model_index(self) -> int:
        return self.mesh.model_index

    def copy_to_blocks(self, x):
        """Megatron's f (``collectives.copy_to_blocks``)."""
        return copy_to_blocks(x, self.mesh, MODEL_AXIS, "tp")

    def reduce_blocks(self, x):
        """Megatron's g: the sum over the model group, its backward the
        pass-through (``collectives.all_reduce``)."""
        return all_reduce(x, self.mesh, MODEL_AXIS, "tp")

    def block_of(self, x, dim):
        """This rank's block of a replicated ``x`` along ``dim``."""
        return block_of(x, self.mesh, MODEL_AXIS, dim, "tp")

    def gather_blocks(self, x, dim):
        """The model group's blocks of ``x`` whole along ``dim``."""
        return gather_blocks(x, self.mesh, MODEL_AXIS, dim, "tp")

    # -- Lamb ----------------------------------------------------------------
    def blocked(self, name) -> bool:
        """Whether this rank holds a block of the param ``name``."""
        return bool(self.specs.get(name))

    def sum_over_blocks(self, x):
        """``x`` summed over the model group (Lamb's squared norms of the
        blocked leaves)."""
        return all_reduce(x, self.mesh, MODEL_AXIS, "norms")

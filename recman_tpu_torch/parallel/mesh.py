"""The (data, model) mesh over the ranks of a torch.distributed world.

Counterpart of ``recman_tpu/parallel/mesh.py``. JAX runs one process that
sees every device of a 2-D ``(data, model)`` mesh; the port runs one
process per rank, and a rank takes the place of one JAX device:

- ``data``  : the batch dimension (DP); gradients all-reduce over it
- ``model`` : the vocabulary rows of large embedding tables

Rank numbering is ``rank = d * model + m``, the row-major order that
``jax.make_mesh((data, model))`` gives CPU devices, so rank r holds what
JAX device r holds. Ranks with the same ``m`` form a data group, ranks with
the same ``d`` a model group. ``torch.distributed.new_group`` must be
called by every rank, in the same order, for every group (also groups the
rank is not in), so ``make_mesh`` builds all of them, once.

``Sharding(mesh, spec)`` stands for ``NamedSharding``: ``local(x)`` is the
block of ``x`` that the named sharding would place on this rank's device.
"""

from __future__ import annotations

import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """A ``(data, model)`` grid of world ranks and this rank's place in it.

    ``shape`` is keyed by ``DATA_AXIS``/``MODEL_AXIS``, as the reference's
    ``mesh.shape[MODEL_AXIS]``. ``coords`` is this rank's ``(d, m)`` (None
    for a rank outside the mesh); ``groups`` maps ``DATA_AXIS``,
    ``MODEL_AXIS`` and ``"mesh"`` to this rank's process groups."""

    def __init__(self, data: int, model: int, ranks: tuple, groups: dict, coords):
        self.shape = {DATA_AXIS: data, MODEL_AXIS: model}
        self.ranks = ranks
        self.groups = groups
        self.coords = coords

    @property
    def data_index(self) -> int:
        return self.coords[0]

    @property
    def model_index(self) -> int:
        return self.coords[1]

    def group(self, axis: str):
        return self.groups[axis]

    def __repr__(self) -> str:
        return visualize(self)


def _check_mesh(data, model, n):
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return data


def make_mesh(data=None, model=1, ranks=None, device=None) -> Mesh:
    """Build a (data, model) mesh over ``ranks`` (default: the whole world).
    ``data=None`` uses all remaining ranks. Without a process group (and no
    launcher environment) this starts a one-rank group first
    (``initialize_cluster``), as JAX's mesh works on one host; ``device``
    picks that group's backend (NCCL for CUDA, Gloo for the CPU)."""
    from .distributed import initialize_cluster

    if not dist.is_initialized():
        initialize_cluster(device=device)
    world = dist.get_world_size()
    ranks = tuple(range(world)) if ranks is None else tuple(ranks)
    data = _check_mesh(data, model, len(ranks))
    me = dist.get_rank()
    coords = None
    groups = {}
    # every rank creates every group, in one order
    for m in range(model):
        members = [ranks[d * model + m] for d in range(data)]
        g = dist.new_group(members)
        if me in members:
            groups[DATA_AXIS] = g
    for d in range(data):
        members = [ranks[d * model + m] for m in range(model)]
        g = dist.new_group(members)
        if me in members:
            groups[MODEL_AXIS] = g
    g = dist.new_group(list(ranks))
    if me in ranks:
        groups["mesh"] = g
        pos = ranks.index(me)
        coords = (pos // model, pos % model)
    return Mesh(data, model, ranks, groups, coords)


class Sharding:
    """A NamedSharding's placement for this rank: ``spec`` names, per
    leading dim, the mesh axis it splits over (a tuple of ``DATA_AXIS``,
    ``MODEL_AXIS`` or None; () is replicated)."""

    def __init__(self, mesh: Mesh, spec: tuple = ()):
        self.mesh = mesh
        self.spec = tuple(spec)

    def local(self, x):
        """This rank's block of ``x`` (a tensor or numpy array); each split
        dim must divide its axis."""
        index = []
        for dim, axis in enumerate(self.spec):
            if axis is None:
                index.append(slice(None))
                continue
            n = self.mesh.shape[axis]
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide {axis}={n}")
            size = x.shape[dim] // n
            i = self.mesh.coords[0 if axis == DATA_AXIS else 1]
            index.append(slice(i * size, (i + 1) * size))
        return x[tuple(index)]

    def __repr__(self) -> str:
        return f"Sharding({visualize(self.mesh)}, {self.spec})"


def replicated(mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharding(mesh) -> Sharding:
    """Leading (batch) dim over the data axis."""
    return Sharding(mesh, (DATA_AXIS,))


def row_sharding(mesh) -> Sharding:
    """Vocabulary rows over the model axis (embedding tables, linear_w)."""
    return Sharding(mesh, (MODEL_AXIS,))


def visualize(mesh) -> str:
    return f"Mesh(data={mesh.shape[DATA_AXIS]}, model={mesh.shape[MODEL_AXIS]})"

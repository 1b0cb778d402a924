"""The parallel layer (counterpart of ``recman_tpu/parallel``): a (data,
model) mesh of torch.distributed ranks, explicit data parallelism,
row-sharded embedding tables with the psum and dedup exchanges,
tensor-parallel DNN towers, and ``ShardedTrainer`` with sharded
checkpoints, one agreed preemption and the stream methods.

Three rules run through it. An all-reduce has two backwards
(``collectives.py``): over the model axis the ranks are replicas of one
objective and the cotangent passes through; over the data axis their
objectives are summed and a shared value's cotangents are summed too
(Dice's batch moments, DIEN's rolled negatives). A resilient run agrees
on the preemption flag with one all-reduce at every step boundary, so
every rank checkpoints at the same step (``checkpoint.MeshResilience``),
and every layer below reads the mesh from one sharded run
(``mesh_run.MeshRun``). Global rank
0 alone writes a checkpoint and ``LATEST.json``; barriers keep the other
ranks from going on, or reading, before it has."""

from .checkpoint import MeshResilience
from .distributed import enable_debug_checks, initialize_cluster
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    make_mesh,
    replicated,
    row_sharding,
)
from .shard_lookup import (
    capacity_from_sample,
    dedup_embedding_lookup,
    sharded_embedding_lookup,
)
from .sharding import pad_vocab_for_mesh, param_specs, place_params
from .train_pjit import (
    ShardedTrainer,
    make_sharded_eval_step,
    make_sharded_train_step,
    shard_init_state,
)

__all__ = [
    "DATA_AXIS",
    "enable_debug_checks",
    "initialize_cluster",
    "MODEL_AXIS",
    "MeshResilience",
    "ShardedTrainer",
    "batch_sharding",
    "capacity_from_sample",
    "dedup_embedding_lookup",
    "make_mesh",
    "make_sharded_eval_step",
    "make_sharded_train_step",
    "pad_vocab_for_mesh",
    "param_specs",
    "place_params",
    "replicated",
    "row_sharding",
    "shard_init_state",
    "sharded_embedding_lookup",
]

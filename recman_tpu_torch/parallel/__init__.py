"""The parallel layer: a (data, model) mesh of torch.distributed ranks,
explicit data parallelism, row-sharded embedding tables with the psum and
dedup exchanges, and ``ShardedTrainer`` (counterpart of
``recman_tpu/parallel``)."""

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

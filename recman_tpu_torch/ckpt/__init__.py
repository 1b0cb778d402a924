"""Checkpoints (``checkpoint.py``) and the cross-vocabulary warm start.

``transfer.py`` is a byte copy of ``recman_tpu/ckpt/transfer.py`` and works
on numpy arrays: hand ``warm_start_embeddings`` host params
(``{k: v.cpu().numpy()}``, for the new and the old side) and load its
result back with ``convert.params_from_jax``. It cannot take CUDA
tensors: it copies a table with ``np.array``, which a CUDA tensor
refuses.
"""

from .checkpoint import (
    load_feat_dict,
    load_hparams,
    restore_checkpoint,
    restore_params,
    save_checkpoint,
)
from .transfer import warm_start_embeddings

__all__ = [
    "load_feat_dict",
    "load_hparams",
    "restore_checkpoint",
    "restore_params",
    "save_checkpoint",
    "warm_start_embeddings",
]

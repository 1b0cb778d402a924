"""recman_tpu_torch — the PyTorch/CUDA port of ``recman_tpu``.

The JAX package ``recman_tpu`` stays beside this one as the reference;
this package imports ``torch`` and never ``jax`` or ``recman_tpu``. Host
modules that are pure numpy (``features``, ``config``, ``data``) are
copies, so the port runs where JAX is not installed.

Module names mirror the reference so each counterpart is easy to find:

- serving: ``serving.Predictor`` over the zoo's models in eval mode, and
  artifacts (``Predictor.export``, ``ExportedPredictor``, int8
  ``ops.QuantTable`` tables);
- training: the stacked-storage step (``training.make_train_step_stacked``)
  with the reference's optimizer menu and schedules, the ``Trainer`` with
  checkpoints (``ckpt``, ``Trainer.save``/``restore``), resilient training
  (``training.Resilience``) and streaming (``Trainer.fit_stream`` over
  ``data.streaming``), and the examples (``examples``);
- the model zoo (``models.MODEL_REGISTRY``, the reference's 19 names) and
  QR embeddings (``qr_collisions``);
- the parallel layer (``parallel``): explicit data parallelism,
  row-sharded tables with the psum and dedup exchanges, tensor-parallel
  DNN towers and ``ShardedTrainer`` with sharded checkpoints and one
  agreed preemption over torch.distributed ranks;
- the tools (``tools``): the bench entry with its numerics check
  (``tools.bench``), a torch.profiler step profile (``tools.profile_step``),
  the ABAB harness (``tools.abab``), the two-process demo
  (``tools.multiprocess_demo``) and readings of the kernels.

The kernels are hand-written CUDA (sources in ``csrc/``): the CIN tower
forward (K1) and backward (K2, with its recompute form) in
``ops/cin_chain.py``, one CIN layer's forward (K4) and backward (K5) in
``ops/cin_interact.py``, and the embedding tables' segment-sum gradients
in ``ops/segment_matmul.py``: batched (K3), per table (K6), and batched
into the row-major table layout (K7).

Entry points run on the GPU unless the caller passes ``device="cpu"``;
with no GPU they raise instead of falling back to the CPU.
"""

import logging

__version__ = "0.1.0"


def config_logger(level=logging.INFO):
    """Configure root stdlib logging as the reference's ``config_logger``."""
    logging.basicConfig(
        level=level,
        format="%(levelname)s:%(asctime)s:%(name)s:%(lineno)d: %(message)s",
    )


from .device import resolve_device  # noqa: E402,F401
from .features import (  # noqa: E402,F401
    DenseFeat,
    FeatureSet,
    HashedSparseFeat,
    MultiValCsvFeat,
    MultiValSparseFeat,
    SequenceFeat,
    SparseFeat,
    SparseValueFeat,
    schema_from_json,
    schema_to_json,
)

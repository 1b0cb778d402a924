"""recman_tpu_torch — the PyTorch/CUDA port of ``recman_tpu``.

The JAX package ``recman_tpu`` stays beside this one as the reference;
this package imports ``torch`` and never ``jax`` or ``recman_tpu``. Host
modules that are pure numpy (``features``, ``config``, ``data``) are
copies, so the port runs where JAX is not installed.

Module names mirror the reference so each counterpart is easy to find.
The slices ported so far are xDeepFM serving (``serving.Predictor`` over
``models.XDeepFM`` in eval mode), its stacked-storage train step
(``training.make_train_step_stacked`` with Adam), the ``Trainer`` with
the ML-100K example (``examples.xdeepfm_ml``) and the per-layer CIN path
with the Criteo example (``examples.criteo_xdeepfm``), large-batch
training, and checkpoints (``ckpt``, ``Trainer.save``/``restore``),
resilient training (``training.Resilience``) and streaming
(``Trainer.fit_stream`` over ``data.streaming``), the model zoo
(``models.MODEL_REGISTRY``), QR embeddings (``qr_collisions``) and
serving artifacts (``serving.Predictor.export``, ``ExportedPredictor``,
int8 ``ops.QuantTable`` tables). Their kernels are
hand-written CUDA (sources in ``csrc/``): the CIN tower forward (K1) and
backward (K2) in ``ops/cin_chain.py``, one CIN layer's forward (K4) and
backward (K5) in ``ops/cin_interact.py``, and the embedding tables'
segment-sum gradients, batched (K3) and per table (K6), in
``ops/segment_matmul.py``.

Entry points run on the GPU unless the caller passes ``device="cpu"``;
with no GPU they raise instead of falling back to the CPU.
"""

import logging


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
)

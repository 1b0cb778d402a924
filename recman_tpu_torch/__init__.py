"""recman_tpu_torch — the PyTorch/CUDA port of ``recman_tpu``.

The JAX package ``recman_tpu`` stays beside this one as the reference;
this package imports ``torch`` and never ``jax`` or ``recman_tpu``. Host
modules that are pure numpy (``features``, ``config``, ``data``) are
copies, so the port runs where JAX is not installed.

Module names mirror the reference so each counterpart is easy to find.
The slices ported so far are xDeepFM serving (``serving.Predictor`` over
``models.XDeepFM`` in eval mode) and its stacked-storage train step
(``training.make_train_step_stacked`` with Adam). Their kernels are
hand-written CUDA (sources in ``csrc/``): the CIN tower forward (K1) and
backward (K2) in ``ops/cin_chain.py`` and the embedding tables' segment-sum
gradient (K3) in ``ops/segment_matmul.py``.

Entry points run on the GPU unless the caller passes ``device="cpu"``;
with no GPU they raise instead of falling back to the CPU.
"""

from .device import resolve_device  # noqa: F401
from .features import (  # noqa: F401
    DenseFeat,
    FeatureSet,
    HashedSparseFeat,
    MultiValCsvFeat,
    MultiValSparseFeat,
    SequenceFeat,
    SparseFeat,
    SparseValueFeat,
)

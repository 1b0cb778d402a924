"""Data pipelines. ``criteo.py`` and ``streaming.py`` are verbatim copies
of the reference's (``recman_tpu/data/``); ``native_loader.py`` is one but
for where it caches the built parser (the checkout's ``build/native/``, not
``/tmp``). All three use numpy, ctypes and subprocess only; the native
loader builds the repository's ``native/criteo_parser.cpp`` with g++, the
same source the reference builds. ``ml_100k.py`` reimplements the
reference's pandas loader in numpy, the ML-100K sequence features
(``add_history_feature``, ``create_ml_sequence_features``) with it."""

from .criteo import (
    CAT_NAMES,
    INT_NAMES,
    calibrated_criteo_arrays,
    create_criteo_features,
    load_criteo_tsv,
    synthetic_criteo_arrays,
)
from .ml_100k import (
    add_history_feature,
    concat_rows,
    create_ml_features,
    create_ml_sequence_features,
    get_data,
    get_ml_dataset,
)
from .native_loader import load_criteo_tsv_native, load_criteo_tsv_range_native
from .streaming import iter_array_chunks, iter_criteo_chunks

__all__ = [
    "CAT_NAMES",
    "INT_NAMES",
    "add_history_feature",
    "calibrated_criteo_arrays",
    "concat_rows",
    "create_criteo_features",
    "create_ml_features",
    "create_ml_sequence_features",
    "get_data",
    "get_ml_dataset",
    "iter_array_chunks",
    "iter_criteo_chunks",
    "load_criteo_tsv",
    "load_criteo_tsv_native",
    "load_criteo_tsv_range_native",
    "synthetic_criteo_arrays",
]

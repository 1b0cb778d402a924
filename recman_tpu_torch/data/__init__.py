"""Data pipelines. ``criteo.py`` is a verbatim copy of
``recman_tpu/data/criteo.py`` (numpy only); ``ml_100k.py`` reimplements
the reference's pandas loader in numpy. The other loaders of the
reference are not ported yet."""

from .criteo import (
    CAT_NAMES,
    INT_NAMES,
    calibrated_criteo_arrays,
    create_criteo_features,
    load_criteo_tsv,
    synthetic_criteo_arrays,
)
from .ml_100k import concat_rows, create_ml_features, get_data, get_ml_dataset

__all__ = [
    "CAT_NAMES",
    "INT_NAMES",
    "calibrated_criteo_arrays",
    "concat_rows",
    "create_criteo_features",
    "create_ml_features",
    "get_data",
    "get_ml_dataset",
    "load_criteo_tsv",
    "synthetic_criteo_arrays",
]

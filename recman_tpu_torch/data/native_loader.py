"""ctypes bindings for the native Criteo parser (native/criteo_parser.cpp).

``load_criteo_tsv_native(path, num_buckets, ...)`` parses a Criteo TSV
straight into the ENCODED arrays the trainer consumes — float32 y,
log1p'd float32 dense columns, siphash-bucketed int32 categorical ids —
in one multithreaded C++ pass, bit-identical to the Python route
(load_criteo_tsv + FeatureSet.transform; equality is enforced by
tests/test_native_loader.py).

The shared library is compiled on first use with g++ (no pybind11 in
this image; plain C ABI + ctypes) and cached under build/native/ at the
checkout's root with a content-hash suffix so source edits rebuild
automatically.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading

import numpy as np

log = logging.getLogger(__name__)

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "criteo_parser.cpp",
)
_lock = threading.Lock()
_lib = None


class NativeBuildError(RuntimeError):
    pass


def _build() -> str:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    out = os.path.join(os.path.dirname(os.path.dirname(_SRC)), "build", "native",
                       f"libcriteo_parser_{tag}.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if os.path.exists(out):
        return out
    # compile to a private temp name and rename atomically: concurrent
    # processes (parallel pytest workers, multiple trainers) must never
    # CDLL a half-written .so, and a killed build must not leave a
    # truncated file behind the exists() check
    tmp = f"{out}.build-{os.getpid()}"
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-pthread", "-std=c++17",
        "-o", tmp, _SRC,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    except (subprocess.CalledProcessError, FileNotFoundError, OSError) as e:
        detail = getattr(e, "stderr", str(e))
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise NativeBuildError(f"native parser build failed: {detail}") from e
    return out


def get_lib():
    """Load (building if needed) the parser library; raises NativeBuildError
    when no toolchain is available — callers fall back to the Python path."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            lib.criteo_count_rows.restype = ctypes.c_int64
            lib.criteo_count_rows.argtypes = [ctypes.c_char_p, ctypes.c_int64]
            lib.criteo_parse.restype = ctypes.c_int64
            lib.criteo_parse.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.criteo_parse_range.restype = ctypes.c_int64
            lib.criteo_parse_range.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.pack_columns_32.restype = ctypes.c_int64
            lib.pack_columns_32.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_int32,
                ctypes.c_int64, ctypes.c_int32,
                ctypes.c_void_p,
            ]
            _lib = lib
    return _lib


def pack_columns_32(cols: list, n_threads: int = 0) -> np.ndarray:
    """Interleave same-length 1-D 4-byte columns into (N, n_cols) with the
    threaded native kernel. Columns must share one 4-byte dtype (int32 or
    float32); raises NativeBuildError when no toolchain exists (callers
    fall back to np.stack)."""
    lib = get_lib()
    n = len(cols[0])
    dtype = cols[0].dtype
    cols = [np.ascontiguousarray(c) for c in cols]
    out = np.empty((n, len(cols)), dtype=dtype)
    ptrs = (ctypes.c_void_p * len(cols))(
        *[c.ctypes.data_as(ctypes.c_void_p).value for c in cols]
    )
    r = lib.pack_columns_32(
        ptrs, len(cols), n, int(n_threads),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    assert r == n, r
    return out


def load_criteo_tsv_native(
    path, num_buckets, max_rows=None, n_threads=0
) -> dict[str, np.ndarray]:
    """Parse + encode a Criteo TSV natively.

    Returns {'y': f32 (N,), 'I1'..'I13': f32 (N,), 'C1'..'C26': i32 (N,)}
    — the same dict FeatureSet.transform produces for
    create_criteo_features(num_buckets), ready for pack_dataset.
    """
    from .criteo import CAT_NAMES, INT_NAMES, NUM_CAT_FEATURES, NUM_INT_FEATURES

    lib = get_lib()
    p = os.fsencode(path)
    n = lib.criteo_count_rows(p, -1 if max_rows is None else int(max_rows))
    if n < 0:
        raise FileNotFoundError(path)
    y = np.empty(n, dtype=np.float32)
    dense = np.empty((n, NUM_INT_FEATURES), dtype=np.float32)
    cats = np.empty((n, NUM_CAT_FEATURES), dtype=np.int32)
    parsed = lib.criteo_parse(
        p, n, int(num_buckets), int(n_threads),
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        dense.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cats.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if parsed != n:  # pragma: no cover - read error mid-file
        raise IOError(f"parsed {parsed} of {n} rows from {path}")
    out = {"y": y}
    for j, name in enumerate(INT_NAMES):
        out[name] = np.ascontiguousarray(dense[:, j])
    for j, name in enumerate(CAT_NAMES):
        out[name] = np.ascontiguousarray(cats[:, j])
    return out


def load_criteo_tsv_range_native(
    path, start_row, n_rows, num_buckets, n_threads=0
) -> dict[str, np.ndarray]:
    """Parse + encode rows [start_row, start_row + n_rows) of a Criteo TSV
    (the chunk read behind the streaming input pipeline,
    data/streaming.py). Returns the same dict shape as
    load_criteo_tsv_native, possibly shorter at EOF."""
    from .criteo import CAT_NAMES, INT_NAMES, NUM_CAT_FEATURES, NUM_INT_FEATURES

    lib = get_lib()
    n = int(n_rows)
    y = np.empty(n, dtype=np.float32)
    dense = np.empty((n, NUM_INT_FEATURES), dtype=np.float32)
    cats = np.empty((n, NUM_CAT_FEATURES), dtype=np.int32)
    parsed = lib.criteo_parse_range(
        os.fsencode(path), int(start_row), n, int(num_buckets),
        int(n_threads),
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        dense.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cats.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if parsed < 0:
        raise FileNotFoundError(path)
    parsed = int(parsed)
    out = {"y": y[:parsed]}
    for j, name in enumerate(INT_NAMES):
        out[name] = np.ascontiguousarray(dense[:parsed, j])
    for j, name in enumerate(CAT_NAMES):
        out[name] = np.ascontiguousarray(cats[:parsed, j])
    return out

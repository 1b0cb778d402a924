"""Chunked dataset streams for training beyond device-memory residency.

The reference (and this repo's default fit loop) keeps the WHOLE encoded
dataset in memory / HBM (reference DeepModel.py:141; Trainer._to_device).
That caps dataset size at a few hundred million rows — full Criteo
(~4.4B rows, 45 GB/day TSVs) needs streaming. These iterators produce
encoded host chunks; ``Trainer.fit_stream`` double-buffers them through
the device so training never holds more than two chunks in HBM.

Chunk sources:
- ``iter_array_chunks``: row-chunks of an in-memory encoded dict (tests,
  synthetic data, datasets that fit in host RAM but not HBM).
- ``iter_criteo_chunks``: chunk-at-a-time native parse of a Criteo TSV
  (native/criteo_parser.cpp criteo_parse_range — the mmap'd skip+parse
  never materializes the file).
"""

from __future__ import annotations

import numpy as np


def iter_array_chunks(data: dict, chunk_rows: int, shuffle_seed=None):
    """Yield encoded row-chunks of ``data`` (a {name: (N, ...) array} dict).

    With ``shuffle_seed`` the rows are globally permuted first, so chunk
    contents re-mix every epoch (pass seed+epoch) — the host-RAM analogue
    of the resident fit loop's epoch shuffle.
    """
    n = int(len(next(iter(data.values()))))
    order = (np.random.RandomState(shuffle_seed).permutation(n)
             if shuffle_seed is not None else None)
    for s in range(0, n, chunk_rows):
        if order is not None:
            sl = order[s: s + chunk_rows]
        else:
            sl = slice(s, min(s + chunk_rows, n))
        yield {k: np.asarray(v)[sl] for k, v in data.items()}


def iter_criteo_chunks(path, num_buckets, chunk_rows, max_rows=None,
                       n_threads=0):
    """Stream a Criteo TSV as encoded chunks via the native parser.

    Each chunk is the standard {'y', 'I1'.., 'C1'..} dict of
    ``chunk_rows`` rows (shorter at EOF). Host memory: one chunk; the
    native range read mmaps and skips, so no whole-file buffers exist.
    """
    from .native_loader import load_criteo_tsv_range_native

    start = 0
    while True:
        take = chunk_rows
        if max_rows is not None:
            take = min(take, max_rows - start)
            if take <= 0:
                return
        chunk = load_criteo_tsv_range_native(
            path, start, take, num_buckets, n_threads
        )
        got = len(chunk["y"])
        if got == 0:
            return
        yield chunk
        if got < take:
            return
        start += got

"""Operations and bytes of DLRM's work, from the configuration's shapes.

As ``costs/xdeepfm.py``: each function takes the configuration and a count
of rows ``n`` and returns (operations, bytes) for that work on ``n`` rows.
"""

from __future__ import annotations

F32 = 4


def segment_sum(cfg, n):
    """The tables' gradients from one batch's lookups: per hashed field the
    n rows of k columns summed by id into a dense (buckets + 1, k)
    gradient. Reads the sorted ids and the rows, writes every table's
    gradient."""
    k, f = cfg["hparams"]["embedding_size"], cfg["data"]["n_cat"]
    v = cfg["num_buckets"] + 1
    return f * n * k, F32 * (f * n + f * n * k) + F32 * f * k * v


def model_flops(cfg, n):
    """The model's forward operations on n rows: the bottom and top MLPs'
    matrix products and the dot product of each pair of fields (2 a
    multiply-add); the embedding gathers count none."""
    hp, d = cfg["hparams"], cfg["data"]
    k, fields = hp["embedding_size"], d["n_cat"] + 1
    bot = [d["n_dense"], *hp["bot_hidden_units"], k]
    pairs = fields * (fields - 1) // 2
    top = [k + pairs, *hp["top_hidden_units"], 1]
    mlp = sum(2 * a * b for dims in (bot, top) for a, b in zip(dims, dims[1:]))
    return n * (mlp + 2 * pairs * k), 0

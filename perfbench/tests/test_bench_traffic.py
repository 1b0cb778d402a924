"""The traffic generator: the same seed gives the same rows and weights,
another seed other ones, and the ids follow Zipf(a) taken mod buckets."""

from __future__ import annotations

import numpy as np
import torch

from perfbench import gen, spec

SEED = 2**31 + 12_345  # wider than 32 signed bits


def _rows(cfg, seed, n=4096):
    return gen.criteo_rows(cfg, n, gen.generator(seed, gen.ROWS, "cpu"), "cpu")


def test_same_seed_same_rows(tiny):
    cfg = spec.config("xdeepfm_bench_criteo")
    a, b, c = _rows(cfg, SEED), _rows(cfg, SEED), _rows(cfg, SEED + 1)
    for k in ("cat", "dense", "y"):
        assert torch.equal(a[k], b[k])
        assert not torch.equal(a[k], c[k])
    assert a["cat"].dtype == torch.int32 and a["cat"].shape == (4096, 26)
    assert int(a["cat"].min()) >= 1 and int(a["cat"].max()) <= cfg["num_buckets"]
    assert 0.2 < float(a["y"].mean()) < 0.8


def test_same_seed_same_weights(tiny):
    from perfbench.reference import steps

    cfg = spec.config("dlrm_mlperf_criteo")
    shapes = steps.family("dlrm").param_shapes(cfg)
    a = gen.glorot_weights(shapes, gen.generator(SEED, gen.WEIGHTS, "cpu"), "cpu")
    b = gen.glorot_weights(shapes, gen.generator(SEED, gen.WEIGHTS, "cpu"), "cpu")
    assert all(torch.equal(a[k], b[k]) for k in shapes)
    w = a["top_dnn_layer_0_weights"]
    assert abs(float(w.std()) - (2 / sum(w.shape)) ** 0.5) < 0.05 * (2 / sum(w.shape)) ** 0.5


def test_zipf_residue_law_matches_numpy():
    """The inverse-CDF draw against numpy's rejection sampler of Zipf(1.2)
    mod 1,000: the two empirical CDFs within a KS distance of 0.01."""
    buckets, n = 1000, 200_000
    cdf = gen.zipf_residue_cdf(1.2, buckets, "cpu").numpy()
    ids = np.random.RandomState(0).zipf(1.2, size=n) % buckets
    emp = np.cumsum(np.bincount(ids, minlength=buckets)) / n
    assert np.abs(emp - cdf).max() < 0.01


def test_chunk_sizes_are_a_fixed_grid(tiny):
    t = spec.traffic("score_chunks")
    sizes = gen.chunk_sizes(t)
    assert len(sizes) == t["chunks"] and sizes == sorted(sizes)
    assert t["chunk_rows_min"] <= sizes[0] and sizes[-1] <= t["chunk_rows_max"]
    shipped = spec.load_json(spec.ROOT / "perfbench" / "traffic" / "score_chunks.json")
    full = gen.chunk_sizes(shipped)
    # one request in three or so pays two batches of 65,536
    assert 0.25 < sum(s >= shipped["batch"] for s in full) / len(full) < 0.4

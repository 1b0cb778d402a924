"""The cost functions against counts by hand at the cells' shapes."""

from __future__ import annotations

from perfbench import spec
from perfbench.costs import dlrm, xdeepfm


def test_xdeepfm_counts():
    cfg = spec.config("xdeepfm_bench_criteo")
    # CIN layer 0: 16 * 26 * 26 products, 2 * 16 * 676 * 100 contraction;
    # layer 1: 16 * 26 * 50 and 2 * 16 * 1,300 * 100
    cin = 16 * 676 * 201 + 16 * 1300 * 201
    assert xdeepfm.cin_fwd(cfg, 1)[0] == cin
    # DNN 429 -> 400 -> 400 -> 1
    assert xdeepfm.model_flops(cfg, 1)[0] == cin + 2 * (429 * 400 + 400 * 400 + 400)
    assert 3 * xdeepfm.model_flops(cfg, 1)[0] == 21_056_448  # 21.06 MFLOP an example
    # the bound chip_smoke.py gives K1 at 8192 (0.0524 ms) and K2 at 65,536 (0.84 ms)
    assert abs(xdeepfm.cin_fwd_save(cfg, 8192)[0] / 989e12 * 1e3 - 0.0524) < 0.001
    assert abs(xdeepfm.cin_bwd(cfg, 65536)[0] / 989e12 * 1e3 - 0.85) < 0.02
    # K3 at 8192: 192.1 MB (chip_smoke.py), 299.5 MB at 65,536
    assert round(xdeepfm.segment_sum(cfg, 8192)[1] / 1e6, 1) == 192.1
    assert round(xdeepfm.segment_sum(cfg, 65536)[1] / 1e6, 1) == 299.5
    # fmaps saved: 200 maps of 16 positions a row, f32
    assert xdeepfm.cin_fwd_save(cfg, 10)[1] - xdeepfm.cin_fwd(cfg, 10)[1] == 4 * 10 * 16 * 200


def test_dlrm_counts():
    cfg = spec.config("dlrm_mlperf_criteo")
    bot = 2 * (13 * 512 + 512 * 256 + 256 * 128)
    top = 2 * (479 * 1024 + 1024 * 1024 + 1024 * 512 + 512 * 256 + 256)
    assert dlrm.model_flops(cfg, 1)[0] == bot + top + 2 * 351 * 128
    assert round(dlrm.model_flops(cfg, 65536)[0] / 1e9) == 316  # GFLOP a scoring batch
    # K3 at (26, 128, 2048) into 1,000,001-row tables: 13.34 GB, 3.9819 ms
    # at 3.35 TB/s (0.4056 ms into 100,001 rows, chip_smoke.py's bound)
    assert round(dlrm.segment_sum(cfg, 2048)[1] / 3.35e12 * 1e3, 4) == 3.9819
    assert round(dlrm.segment_sum(dict(cfg, num_buckets=100000), 2048)[1] / 3.35e12 * 1e3,
                 4) == 0.4056

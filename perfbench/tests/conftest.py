"""Fixtures of the benchmark's tests: the cells' files at a size the CPU
holds, in a copy that ``perfbench.spec`` reads in place of the shipped
one."""

from __future__ import annotations

import json
import shutil

import pytest

from perfbench import spec
from perfbench.loops import score_closed, train


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU; skips with a reason without one"
    )


def shrink(base):
    """The data files under ``base`` cut to tiny sizes: 1,000 buckets,
    train batches of 256 from a pool of 8, scoring chunks of 300-2,000
    rows at batch 1,024."""
    for f in (base / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c.update(num_buckets=1000, reference_block_rows=128)
        f.write_text(json.dumps(c))
    for f in (base / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        if t["loop"] == "train":
            t.update(batch=256, pool_rows=256 * 8)
        else:
            t.update(batch=1024, chunk_rows_min=300, chunk_rows_max=2000, chunks=4)
        f.write_text(json.dumps(t))


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """A tiny copy of the data files, read by ``spec`` for the test, and a
    short warm-up."""
    base = tmp_path / "perfbench"
    shutil.copytree(spec.HERE, base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests", "*.py"))
    shrink(base)
    monkeypatch.setattr(spec, "HERE", base)
    monkeypatch.setattr(train, "WARMUP_SECONDS", 0.1)
    monkeypatch.setattr(score_closed, "WARMUP_SECONDS", 0.1)
    return base

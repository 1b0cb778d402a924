"""Each cell on the card: a short run through the command line comes out
correct, and the control (the reference one precision step below the
configuration's) in the port's place comes out not correct. Run on a
machine with a CUDA card:

    python3 -m pytest -q perfbench/tests/test_bench_card.py
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from perfbench import run, spec
from perfbench.faults import PROGRAMS

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct(cell):
    _card()
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", cell,
                          "--seed", str(2**31 + 5), "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, cwd=spec.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["check"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    _card()
    run.cache_dirs()
    loop = spec.traffic(spec.cell(cell)["traffic"])["loop"]
    r = run.run_cell(cell, 2**31 + 6, 1.0, False, make_program=PROGRAMS["control"][loop])
    assert not r["correct"], r["check"]

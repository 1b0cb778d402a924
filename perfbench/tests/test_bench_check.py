"""The check that decides ``correct``, driven through a whole run at a size
the CPU holds, the harness's look for a card skipped: the port passes,
and the control and each fault a cell can have fail it."""

from __future__ import annotations

import pytest

from perfbench import run, spec
from perfbench.faults import PROGRAMS

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SEED = 2**31 + 3


def _loop(cell):
    return spec.traffic(spec.cell(cell)["traffic"])["loop"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_port_passes(tiny, cell):
    r = run.run_cell(cell, SEED, 0.3, False, device="cpu")
    assert r["correct"], r["check"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "check"


@pytest.mark.parametrize("cell,kind", [(c, k) for c in CELLS for k in PROGRAMS
                                       if _loop(c) in PROGRAMS[k]])
def test_control_and_faults_fail(tiny, cell, kind):
    r = run.run_cell(cell, SEED, 0.3, False, device="cpu",
                     make_program=PROGRAMS[kind][_loop(cell)])
    assert not r["correct"], r["check"]

"""Torch's CPU threads for the port's tests, shared between pytest-xdist
workers.

Each worker's torch would otherwise start one thread per core, so six
workers run six times as many threads as the machine has cores, and every
test waits on the others. A test module that imports ``worker_threads``
runs with the cores divided evenly among the workers (all of them in a run
without workers), and torch's own setting is restored after the module.
"""

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def worker_threads():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    prev = torch.get_num_threads()
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // max(workers, 1)))
    yield
    torch.set_num_threads(prev)

"""The sharded run that a row-sharded step is inside of, for the code below
``parallel/`` that reduces over a mesh.

``parallel/train_pjit.py`` opens ``sharded_run(run)`` around a row-sharded
step's forward, its optimizer update and the eval forward, with ``run`` a
``parallel.mesh_run.MeshRun``. The embedding lookups (its exchange), the
DNNs (its tensor-parallel specs), Dice (its moments over the data group)
and Lamb (its norms over blocks) read it with ``current_run()`` and call
its methods, so none of them imports ``parallel/``. Outside a sharded run
it is None, and each computes on what it holds, as on one device.
"""

from __future__ import annotations

import contextlib
import threading

_local = threading.local()


@contextlib.contextmanager
def sharded_run(run):
    """Make ``run`` the current sharded run while the context is open."""
    prev = getattr(_local, "run", None)
    _local.run = run
    try:
        yield run
    finally:
        _local.run = prev


def current_run():
    """The open ``sharded_run``'s run, or None."""
    return getattr(_local, "run", None)

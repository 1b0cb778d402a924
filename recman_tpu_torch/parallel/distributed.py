"""Process-group bootstrap and the numerical debug flag.

Counterpart of ``recman_tpu/parallel/distributed.py``. JAX's data plane is
XLA collectives; the port's is ``torch.distributed``: NCCL for one rank
per card, Gloo on the CPU (and for two ranks sharing one card, which NCCL
refuses). Typical entry under ``torchrun``:

    from recman_tpu_torch.parallel import initialize_cluster, make_mesh
    initialize_cluster()          # reads RANK, WORLD_SIZE, MASTER_ADDR, ...
    mesh = make_mesh(model=4)     # the global mesh over every rank
    trainer = ShardedTrainer(model, mesh=mesh, ...)

Without a launcher's environment it starts a one-rank group on a
``FileStore`` in a temporary file, so a plain single process runs the same
collective code.
"""

from __future__ import annotations

import datetime
import logging
import os
import tempfile

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

# read by the DP and sharded steps: raise FloatingPointError on a
# non-finite loss or gradient (enable_debug_checks)
DEBUG_NANS = False
DEBUG_INFS = False


def rank_device(device=None) -> torch.device:
    """This rank's device: the caller's, else ``cuda:LOCAL_RANK`` (modulo
    the cards there are). Raises without a GPU unless ``device="cpu"``."""
    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def initialize_cluster(backend=None, init_method=None, world_size=None, rank=None,
                       device=None, timeout_s=300) -> bool:
    """Start the default process group; returns whether the world has more
    than one rank. A no-op when a group exists. With ``init_method`` /
    ``world_size`` / ``rank`` given it uses them; under a launcher
    (``RANK`` and ``WORLD_SIZE`` set, as torchrun sets them with
    ``MASTER_ADDR``/``MASTER_PORT``/``LOCAL_RANK``) it reads the
    environment; otherwise it starts a one-rank group on a FileStore.
    ``backend`` defaults to NCCL for a CUDA ``device`` (default: CUDA when
    a GPU is present) and Gloo for the CPU."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    backend = backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
    timeout = datetime.timedelta(seconds=timeout_s)
    kwargs = {}
    if backend == "nccl":
        dev = rank_device(device)
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    if init_method is not None or world_size is not None or rank is not None:
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank, timeout=timeout, **kwargs)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", timeout=timeout, **kwargs)
    else:
        fd, path = tempfile.mkstemp(prefix="recman_store_")
        os.close(fd)
        os.unlink(path)  # the FileStore creates it, and deletes it at the end
        log.info("single-process run; one-rank %s group on a FileStore", backend)
        dist.init_process_group(backend, store=dist.FileStore(path, 1), rank=0, world_size=1,
                                timeout=timeout, **kwargs)
    log.info("torch.distributed initialized: rank %d/%d (%s)", dist.get_rank(),
             dist.get_world_size(), backend)
    return dist.get_world_size() > 1


def enable_debug_checks(nans=True, infs=False):
    """Numerical-debug mode: the DP and sharded train steps raise
    FloatingPointError at once on a NaN (``nans``) or an Inf (``infs``) in
    the loss or a gradient. Each check reads the device, so it costs a
    synchronisation a step while on."""
    global DEBUG_NANS, DEBUG_INFS
    DEBUG_NANS, DEBUG_INFS = bool(nans), bool(infs)


def check_finite(loss, grads: dict):
    """The debug checks of ``enable_debug_checks`` (a no-op while off)."""
    if not (DEBUG_NANS or DEBUG_INFS):
        return
    for name, t in [("loss", loss), *grads.items()]:
        if DEBUG_NANS and bool(torch.isnan(t).any()):
            raise FloatingPointError(f"NaN in {name}")
        if DEBUG_INFS and bool(torch.isinf(t).any()):
            raise FloatingPointError(f"Inf in {name}")

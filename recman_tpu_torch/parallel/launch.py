"""Run a function on every rank of a fresh torch.distributed world.

``run_world(fn, world, ...)`` starts ``world`` processes with the ``spawn``
start method (never fork, which is unsafe after CUDA or threads start),
joins them against one deadline, and returns each rank's result. The ranks
meet on a ``FileStore`` in a temporary directory, so worlds started side by
side (test workers) need no ports. Each rank's process group has a 60 s
timeout, so a rank that dies leaves the others blocked for at most that
long; past ``timeout_s`` every rank is killed and the call raises with each
rank's stderr tail. ``fn`` must be importable by the children (a function
of a module, not of a test file that imports JAX).
"""

from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import os
import pickle
import sys
import tempfile
import time

import torch
import torch.distributed as dist

RANK_TIMEOUT_S = 60
_TAIL = 3000


def _rank_main(fn, rank, world, backend, device, directory, args, threads):
    err = open(os.path.join(directory, f"stderr_{rank}.txt"), "w")  # noqa: SIM115 - until exit
    os.dup2(err.fileno(), 2)
    sys.stderr = err
    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(threads)
    kwargs = {}
    if backend == "nccl":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(directory, "store"), world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S), **kwargs)
    try:
        result = fn(*args)
    finally:
        dist.destroy_process_group()
    path = os.path.join(directory, f"result_{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".tmp", path)


def _tails(directory, world) -> str:
    out = []
    for r in range(world):
        try:
            with open(os.path.join(directory, f"stderr_{r}.txt")) as f:
                out.append(f"--- rank {r} stderr ---\n{f.read()[-_TAIL:]}")
        except OSError:
            out.append(f"--- rank {r}: no stderr file ---")
    return "\n".join(out)


def run_world(fn, world: int, backend="gloo", device="cpu", args=(), timeout_s=120, threads=1):
    """``fn(*args)`` on each of ``world`` spawned ranks of a new process
    group (``backend``: "gloo" or "nccl"; ``device`` is where the children
    run, for the parent's CUDA cache). Returns the ranks' results in rank
    order (picklable values: numpy arrays, numbers, dicts). Raises
    RuntimeError with every rank's stderr tail if a rank fails, TimeoutError
    past ``timeout_s``."""
    if torch.device(device).type == "cuda" and torch.cuda.is_initialized():
        torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="recman_world_") as directory:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, backend, device, directory, args, threads))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.exitcode is None for p in procs):
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"world of {world} not done in {timeout_s} s\n"
                                       + _tails(directory, world))
                multiprocessing.connection.wait(
                    [p.sentinel for p in procs if p.exitcode is None], timeout=min(left, 1.0))
                if any(p.exitcode not in (None, 0) for p in procs):
                    raise RuntimeError(
                        "rank(s) failed: "
                        + str({r: p.exitcode for r, p in enumerate(procs) if p.exitcode})
                        + "\n" + _tails(directory, world))
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.kill()
                p.join(10)
        results = []
        for r in range(world):
            with open(os.path.join(directory, f"result_{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))  # written by this world's ranks
        return results

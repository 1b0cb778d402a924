"""Two-process ShardedTrainer demo: per-process feeds, both exchanges and a
preempted, resumed run.

Counterpart of the JAX package's ``tools/multiprocess_demo.py``. The
problem is the reference's: DeepFM with k 4 and DNN (16,), 1,024
synthetic Criteo rows from seed 11 over 500 buckets, batch 256, 2 epochs,
Adam at lr 0.01, params from the reference's ``PRNGKey(2019)``
(``utils.JaxKey``). ``parallel.launch.run_world`` starts
``--num-processes`` ranks (2 by default) in one Gloo world; in the port a
rank stands for a device, so the reference's meshes of 4 devices a
process become:

1. psum    a pure-DP mesh (P, 1);
2. dedup   a (P/2, 2) mesh whose tables (501 rows, over
           ``row_shard_threshold`` 256) are row-sharded over the model axis
           and exchanged through the dedup exchange (its capacity sized on
           the first batch);
3. preempt the dedup run with a ``MeshResilience`` (checkpoints every
           epoch, no signals) whose flag every rank sets before step 7 of
           10 completes; then a fresh ``ShardedTrainer`` in each rank
           restores and finishes.

Each rank passes only its own data group's rows (``dataset_sharded`` and
``multihost_feed`` set explicitly: the port turns the feed off by
default when the whole world is on one host). The checks are the
reference's: every rank reports the same mean loss (the same param L2
under preempt, since the resumed run's last epoch covers only the
remaining batches) and the same dedup capacity, and each mode matches a
one-rank run of the same problem within 1e-4. The one-rank run is a
``ShardedTrainer`` on a mesh of rank 0 alone, fed the whole dataset in
the world's batches (``world_batches``); under preempt it is an
uninterrupted resilient run, whose per-epoch shuffle seeds the preempted
run's match.

The ranks run on the card unless ``--device cpu`` asks for the CPU (the
reference's demo runs on the CPU). Two ranks on one card take Gloo, as
NCCL refuses two ranks on one card. It prints the reference's JSON
summary line with the card's name and power limit, and exits 1 on a
failed check.

Run from the repository root:

    python -m recman_tpu_torch.tools.multiprocess_demo [--num-processes 2]
        [--modes psum,dedup,preempt] [--device cpu] [--grad-kernel segmat]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

ROWS = 1024
BATCH = 256
BUCKETS = 500
EPOCHS = 2
SEED = 2019
DATA_SEED = 11
LEARNING_RATE = 0.01
PREEMPT_AT_STEP = 7  # of 10 (5 steps an epoch, 2 epochs): mid-epoch 2
DEDUP_THRESHOLD = 256
TOL = 1e-4
MODES = ("psum", "dedup", "preempt")
WORLD_TIMEOUT_S = 600


def build_problem():
    """(feature schema, encoded synthetic rows with ``y``)."""
    from ..data import create_criteo_features, synthetic_criteo_arrays

    return (create_criteo_features(num_buckets=BUCKETS),
            synthetic_criteo_arrays(ROWS, num_buckets=BUCKETS, seed=DATA_SEED))


def build_model(fs):
    from ..models import DeepFM

    return DeepFM(fs, {"embedding_size": 4, "deep_hidden_units": (16,),
                       "deep_dropout": (1.0, 1.0)})


def mesh_shape(mode: str, ranks: int) -> tuple:
    """(data, model) of a mode's mesh over ``ranks`` ranks."""
    if mode == "psum":
        return ranks, 1
    if ranks % 2:
        raise ValueError(f"the {mode} mode needs an even number of ranks, not {ranks}")
    return ranks // 2, 2


def world_batches(n: int, data_ranks: int, batch: int, seed: int) -> np.ndarray:
    """The global rows of each batch of a fit over ``data_ranks`` data
    ranks, each fed its own contiguous block of the ``n`` rows: every
    block shuffled by one ``RandomState(seed)`` in data-rank order, each
    batch the concat over the data ranks of ``batch / data_ranks`` of
    their block's rows (-1 pads), as ``ShardedTrainer`` orders a
    per-process feed."""
    local_n = -(-n // data_ranks)
    local_bs = batch // data_ranks
    num_batches = local_n // local_bs + 1
    rs = np.random.RandomState(seed)
    idx = np.full((num_batches * local_bs, data_ranks), -1, dtype=np.int32)
    for d in range(data_ranks):
        valid = min(max(n - d * local_n, 0), local_n)
        idx[:valid, d] = rs.permutation(valid).astype(np.int32) + d * local_n
    return (idx.reshape(num_batches, local_bs, data_ranks).transpose(0, 2, 1)
            .reshape(num_batches, batch))


def _trainer(fs, mesh, mode, device, cls=None, **kw):
    """A ShardedTrainer of the problem on ``mesh`` from JaxKey(SEED)'s params."""
    from ..parallel import ShardedTrainer, shard_init_state
    from ..utils import JaxKey

    if mode != "psum":
        kw.update(embedding_exchange="dedup", row_shard_threshold=DEDUP_THRESHOLD)
    t = (cls or ShardedTrainer)(build_model(fs), {"learning_rate": LEARNING_RATE, "optimizer": "adam"},
                                epoch=EPOCHS, batch_size=BATCH, random_seed=SEED, mesh=mesh,
                                device=device, **kw)
    t.state = shard_init_state(t.model, t.optimizer, JaxKey(SEED), mesh, t.row_shard_threshold,
                               t.tp_dense_threshold, device)
    return t


def _param_l2(t) -> float:
    """The L2 of every whole param, in f64 (a collective over the mesh)."""
    from ..parallel.checkpoint import global_state

    params = global_state(t.state, t.mesh, t.specs).params
    return float(sum(float(v.double().square().sum()) for v in params.values())) ** 0.5


def _preempting(directory, at_step):
    """A MeshResilience that sets the flag on this rank before global step
    ``at_step`` completes (every rank sets it alike)."""
    from ..parallel import MeshResilience

    class PreemptAtStep(MeshResilience):
        def step_boundary(self, trainer, step, epoch, extra=None):
            if step == at_step:
                self._preempted = True
            super().step_boundary(trainer, step, epoch, extra)

    return PreemptAtStep(directory, every_steps=None, every_epochs=1, preempt_signals=())


def _fit(fs, x, y, mesh, mode, device, directory, cls=None, preempt=True, **kw):
    """The mode's run: a fit, or a preempted fit and a fresh trainer's
    resume (with ``preempt=False`` an uninterrupted resilient fit, whose
    per-epoch seeds are the same). Returns the trainer that finished."""
    from ..training import Preempted, Resilience

    if mode != "preempt":
        t = _trainer(fs, mesh, mode, device, cls, **kw)
        t.fit(x, y, random_seed_for_mini_batch=False)
        return t
    if not preempt:
        t = _trainer(fs, mesh, mode, device, cls, **kw)
        t.fit(x, y, resilience=Resilience(directory, every_epochs=10**6, preempt_signals=()))
        return t
    try:
        _trainer(fs, mesh, mode, device, cls, **kw).fit(
            x, y, resilience=_preempting(directory, PREEMPT_AT_STEP))
        raise AssertionError(f"the run was not preempted at step {PREEMPT_AT_STEP}")
    except Preempted:
        pass
    t = _trainer(fs, mesh, mode, device, cls, **kw)
    t.fit(x, y, resilience=Resilience(directory, preempt_signals=()))
    return t


def _counted_fit(*args, **kw):
    """``_fit`` and the kernels' launches it made."""
    from .bench import launch_counts

    before = launch_counts(every=True)
    t = _fit(*args, **kw)
    after = launch_counts(every=True)
    return t, {k: after[k] - before[k] for k in after}


def _one_rank_class(data_ranks):
    """A ShardedTrainer whose fit batches are the world's (world_batches)."""
    from ..parallel import ShardedTrainer

    class OneRank(ShardedTrainer):
        def _batch_index_matrix(self, n, shuffle_seed=None):
            if shuffle_seed is None:
                return super()._batch_index_matrix(n)
            return world_batches(n, data_ranks, self.batch_size, shuffle_seed)

    return OneRank


def _report(t, mode, counts):
    out = {"param_l2": _param_l2(t), "mean_loss": float(t.last_mean_loss), "launches": counts}
    if mode != "psum":
        out["dedup_capacity"] = int(t.dedup_capacity or -1)
    return out


def demo_rank(modes, device, directory, grad_kernel):
    """One rank of the demo's world: every mode in turn on this rank's
    feed, then, on rank 0, each mode's one-rank run. Returns numbers."""
    import torch.distributed as dist

    from ..ops.embedding import grad_kernel as grad_route
    from ..parallel import make_mesh
    from ..parallel.distributed import rank_device

    dev = rank_device(device)
    ranks, rank = dist.get_world_size(), dist.get_rank()
    one = make_mesh(data=1, model=1, ranks=(0,))  # every rank makes its groups
    fs, data = build_problem()
    y_all = data.pop("y")
    out = {"rank": rank, "modes": {}, "one_rank": {}}
    with grad_route(grad_kernel or "auto"):
        for mode in modes:
            d_n, m_n = mesh_shape(mode, ranks)
            mesh = make_mesh(data=d_n, model=m_n)
            n_local = ROWS // d_n
            rows = slice(mesh.data_index * n_local, (mesh.data_index + 1) * n_local)
            x = {k: v[rows] for k, v in data.items()}
            t, counts = _counted_fit(fs, x, y_all[rows], mesh, mode, dev,
                                     os.path.join(directory, mode), dataset_sharded=True,
                                     multihost_feed=True)
            rec = _report(t, mode, counts)
            # the batches this rank fed, as global rows: world_batches'
            local = t._batch_index_matrix(n_local, shuffle_seed=SEED)
            glob = np.where(local >= 0, local + np.repeat(np.arange(d_n) * n_local,
                                                          BATCH // d_n)[None], -1)
            rec["batches_match"] = bool(np.array_equal(glob, world_batches(ROWS, d_n, BATCH,
                                                                           SEED)))
            out["modes"][mode] = rec
        if rank == 0:
            for mode in modes:
                d_n, _ = mesh_shape(mode, ranks)
                t, counts = _counted_fit(fs, data, y_all, one, mode, dev,
                                         os.path.join(directory, f"one_rank_{mode}"),
                                         cls=_one_rank_class(d_n), preempt=False,
                                         dataset_sharded=True)
                out["one_rank"][mode] = _report(t, mode, counts)
    return out


def check(ranks_out, modes) -> tuple:
    """The reference's checks over the ranks' results: (summary of each
    mode, failures)."""
    results, failures = {}, []
    one = ranks_out[0]["one_rank"]
    for mode in modes:
        key = "param_l2" if mode == "preempt" else "mean_loss"
        got = [r["modes"][mode][key] for r in ranks_out]
        if len(set(got)) != 1:
            failures.append(f"{mode}: the ranks disagree on {key}: {got}")
        caps = {r["modes"][mode].get("dedup_capacity") for r in ranks_out}
        if len(caps) != 1:
            failures.append(f"{mode}: the ranks disagree on the dedup capacity: {caps}")
        if not all(r["modes"][mode]["batches_match"] for r in ranks_out):
            failures.append(f"{mode}: a rank's batches are not world_batches'")
        ref = one[mode][key]
        delta = abs(got[0] - ref)
        if not delta < TOL:
            failures.append(f"{mode}: {key} {got[0]} is {delta} from the one-rank run's {ref}")
        name = "param_l2" if mode == "preempt" else "mean_loss"
        results[mode] = {f"multiprocess_{name}": got[0], f"single_process_{name}": ref,
                         "abs_delta": delta,
                         "launches_per_rank": [r["modes"][mode]["launches"] for r in ranks_out]}
        if mode != "psum":
            results[mode]["auto_dedup_capacity"] = caps.pop()
    return results, failures


def run(num_processes=2, modes=MODES, device=None, grad_kernel=None, timeout_s=WORLD_TIMEOUT_S):
    """Run the demo's world; prints and returns its summary (``ok``: every
    check held; ``failures``: the ones that did not)."""
    from ..device import resolve_device
    from ..parallel.launch import run_world
    from .bench import card_of

    dev = resolve_device(device)
    modes = tuple(modes)
    with tempfile.TemporaryDirectory(prefix="recman_demo_") as directory:
        ranks_out = run_world(demo_rank, num_processes, backend="gloo", device=dev.type,
                              args=(modes, dev.type, directory, grad_kernel), timeout_s=timeout_s)
    results, failures = check(ranks_out, modes)
    summary = {"processes": num_processes, "global_devices": num_processes, "modes": results,
               "abs_delta": max(r["abs_delta"] for r in results.values()),
               "ok": not failures, "failures": failures, "lr": LEARNING_RATE,
               "grad_kernel": grad_kernel or "auto", "device": dev.type, "card": card_of(dev)}
    print(json.dumps(summary), flush=True)
    summary["ranks"] = ranks_out
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--grad-kernel", default=None, choices=("auto", "scatter", "segmat"))
    args = ap.parse_args(argv)
    summary = run(args.num_processes, [m.strip() for m in args.modes.split(",")], args.device,
                  args.grad_kernel)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

"""A closed loop of training steps: ``Trainer.fit_on_batch`` on batches of
a pool of rows made on the card, in turn.

Set-up makes the weights and the pool from the seed, builds the trainer,
drives it through its first ``CHECKED`` steps on pool batches 0, 1, 2
(rows that all differ) and keeps what the check reads from them: each
step's loss, the first gradient as the optimizer got it, and each leaf's
change over those steps. Then at least ``WARMUP`` more steps, for at least
``WARMUP_SECONDS``, and the same trainer goes on in the window. After the
window the reference follows the first ``CHECKED`` steps from the same
weights on the same rows.
"""

from __future__ import annotations

import statistics
import time

import torch

from .. import gen
from ..reference import steps as ref_steps

CHECKED = 3
WARMUP = 2
WARMUP_SECONDS = 3.0  # so that a call's first run reads like the others
# a leaf whose reference gradient's norm is under this share of the norm of
# its terms' magnitudes summed has cancelled (``conditioned``)
CANCELLED = 1e-2


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def checked_steps(stepper, idx) -> dict:
    """Steps 1..CHECKED on idx[0..]; each step's loss, each leaf's first
    gradient norm and each leaf's change norm after the steps."""
    p0 = dict(stepper.params)
    losses, grads = [], None
    for s in range(CHECKED):
        losses.append(stepper.step(idx[s]))
        if s == 0:
            grads = norms(stepper.first_grads(p0))
    p = stepper.params
    change = norms({k: p[k] - p0[k] for k in p0})
    out = {"loss": [float(x) for x in losses], "grad": grads, "change": change}
    if getattr(stepper, "terms", None) is not None:
        out["terms"] = stepper.terms
    return out


def weights(cfg, seed, device):
    fam = ref_steps.family(cfg["reference"])
    return gen.glorot_weights(fam.param_shapes(cfg), gen.generator(seed, gen.WEIGHTS, device),
                              device)


def setup(cfg, traffic, seed, device, make_program=None):
    """Weights, pool and trainer; the checked and warm-up steps."""
    from ..program import TrainProgram

    batch = traffic["batch"]
    rows = gen.criteo_rows(cfg, traffic["pool_rows"],
                           gen.generator(seed, gen.ROWS, device), device)
    n = traffic["pool_rows"] // batch
    idx = torch.arange(n * batch, device=device).view(n, batch)
    stepper = (make_program or TrainProgram)(cfg, traffic, weights(cfg, seed, device), rows,
                                             device)
    readings = checked_steps(stepper, idx)
    s, t0 = CHECKED, time.perf_counter()
    while s < CHECKED + WARMUP or time.perf_counter() - t0 < WARMUP_SECONDS:
        stepper.step(idx[s % n])
        s += 1
    sync(device)
    return {"cfg": cfg, "traffic": traffic, "seed": seed, "device": device, "rows": rows,
            "idx": idx, "stepper": stepper, "next": s, "readings": readings, "losses": []}


def window(state, seconds) -> dict:
    """Steps until ``seconds`` have passed, then a synchronize; the host
    time of each ``fit_on_batch`` call (no sync inside) is its span."""
    stepper, idx, device = state["stepper"], state["idx"], state["device"]
    n = idx.shape[0]
    spans, losses = [], state["losses"]
    i = state["next"]
    sync(device)
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        losses.append(stepper.step(idx[i % n]))
        b = time.perf_counter()
        spans.append(b - a)
        i += 1
        if b - t0 >= seconds:
            break
    sync(device)
    wall = time.perf_counter() - t0
    steps = i - state["next"]
    state["next"] = i
    return {"seconds": wall, "units": {"step": steps, "example": steps * idx.shape[1]},
            "spans": {"fit_on_batch": spans}}


def end_to_end(records) -> dict:
    seconds = sum(r["seconds"] for r in records)
    return {"train_examples_per_s": sum(r["units"]["example"] for r in records) / seconds}


def finish(state) -> tuple[int, int]:
    """(attempted, failed) steps of the windows, a step failing when its
    loss is not finite; frees the trainer."""
    losses = state.pop("losses")
    attempted = len(losses)
    failed = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
    del state["stepper"], losses
    return attempted, failed


def reference_readings(state, prec) -> dict:
    """The reference's readings of the checked steps at ``prec``."""
    cfg, traffic, device = state["cfg"], state["traffic"], state["device"]
    ref = ref_steps.Stepper(cfg, weights(cfg, state["seed"], device), state["rows"],
                            traffic["batch"], prec)
    out = checked_steps(ref, state["idx"])
    del ref
    return out


def conditioned(ref: dict, counted) -> list:
    """The leaves of ``counted`` whose reference gradient does not cancel:
    its norm is at least ``CANCELLED`` of the norm of the sum over rows of
    its terms' magnitudes (``ref["terms"]``). A cancelled sum moves with
    the smallest change of its terms: an order of summation, an
    activation's kink crossed by one rounding."""
    terms = ref.get("terms", {})
    return [k for k in counted if ref["grad"][k] >= CANCELLED * terms.get(k, 0.0)]


def compare(prog: dict, ref: dict) -> dict:
    """The numbers: the largest relative gap of a step's loss; of a leaf's
    first-gradient norm and of its change norm, the gap between the two
    sides' norms over the reference's norm of that leaf or of the median
    leaf, whichever is larger, at the worst leaf (``grad_gap``,
    ``change_gap``) and at the median leaf (``grad_gap_median``). Leaves
    whose reference gradient is under a thousandth of the median leaf's
    move by round-off alone and are left out; ``grad_gap`` also leaves out
    the leaves whose reference gradient cancels (``conditioned``). A
    cell's limits file names the numbers it holds."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    med_g = statistics.median(ref["grad"].values())
    counted = [k for k, g in ref["grad"].items() if g >= 1e-3 * med_g]
    med_c = statistics.median(ref["change"][k] for k in counted)

    def gaps(side, med, keys):
        return [abs(prog[side][k] - ref[side][k]) / max(ref[side][k], med) for k in keys]

    return {"loss_gap": loss, "grad_gap": max(gaps("grad", med_g, conditioned(ref, counted))),
            "grad_gap_median": statistics.median(gaps("grad", med_g, counted)),
            "change_gap": max(gaps("change", med_c, counted))}


def check(state) -> dict:
    """{number: value} of the program's checked steps against the
    reference at the configuration's precision."""
    return compare(state["readings"], reference_readings(state, state["cfg"]["precision"]))

"""A closed loop of scoring requests from one client: each request is one
``Predictor.predict`` call on a chunk of host rows, the next sent when its
scores are on the host.

Set-up makes every chunk's rows on the card from the seed and holds them
on the host, one contiguous array a column, as a user hands them to
``Predictor``; the chunk sizes are a fixed log-uniform grid
(``gen.chunk_sizes``) that the seed orders. Warm-up scores the smallest
and the largest chunk (one and two batches), then requests in the
window's order for ``WARMUP_SECONDS``. After the window the
reference scores every chunk and each answer of the window is compared
with its chunk's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import gen, spec
from ..reference import steps as ref_steps
from .train import WARMUP_SECONDS, sync, weights


def _rows(cfg, sizes, seed, device):
    return gen.criteo_rows(cfg, sum(sizes), gen.generator(seed, gen.ROWS, device), device)


def setup(cfg, traffic, seed, device, make_program=None):
    from ..program import ScoreProgram

    sizes = gen.chunk_sizes(traffic)
    order = torch.randperm(len(sizes), generator=gen.generator(seed, gen.ORDER, "cpu")).tolist()
    rows = _rows(cfg, sizes, seed, device)
    cat = rows["cat"].t().contiguous().cpu().numpy()
    dense = rows["dense"].t().contiguous().cpu().numpy()
    del rows
    cats, dense_names = spec.field_names(cfg)
    chunks, start = [], 0
    for n in sizes:
        chunk = {c: cat[j, start:start + n] for j, c in enumerate(cats)}
        chunk.update({c: dense[j, start:start + n] for j, c in enumerate(dense_names)})
        chunks.append(chunk)
        start += n
    program = (make_program or ScoreProgram)(cfg, traffic, weights(cfg, seed, device), device)
    for c in (0, len(sizes) - 1):
        program.predict(chunks[c])
    i, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < WARMUP_SECONDS:
        program.predict(chunks[order[i % len(order)]])
        i += 1
    sync(device)
    return {"cfg": cfg, "traffic": traffic, "seed": seed, "device": device, "sizes": sizes,
            "order": order, "chunks": chunks, "program": program, "next": 0, "answers": []}


def window(state, seconds) -> dict:
    """Requests until ``seconds`` have passed; a request's latency runs from
    the call to ``predict`` until its scores are on the host."""
    program, chunks = state["program"], state["chunks"]
    order, sizes = state["order"], state["sizes"]
    batch = state["traffic"]["batch"]
    lat, answers = [], state["answers"]
    i, rows, batches = state["next"], 0, 0
    sync(state["device"])
    t0 = time.perf_counter()
    while True:
        c = order[i % len(order)]
        a = time.perf_counter()
        scores = program.predict(chunks[c])
        b = time.perf_counter()
        lat.append(b - a)
        answers.append((c, scores))
        rows += sizes[c]
        batches += sizes[c] // batch + 1
        i += 1
        if b - t0 >= seconds:
            break
    wall = time.perf_counter() - t0
    n = i - state["next"]
    state["next"] = i
    return {"seconds": wall, "units": {"request": n, "row": rows, "batch": batches},
            "latency_s": lat}


def end_to_end(records) -> dict:
    lat = np.concatenate([r["latency_s"] for r in records])
    return {"score_examples_per_s": sum(r["units"]["row"] for r in records)
            / sum(r["seconds"] for r in records),
            "score_p95_ms": 1e3 * float(np.quantile(lat, 0.95))}


def finish(state) -> tuple[int, int]:
    """(attempted, failed) requests, a request failing when it returns
    other than one finite score a row; frees the predictor."""
    sizes = state["sizes"]
    failed = sum(1 for c, s in state["answers"]
                 if np.shape(s) != (sizes[c],) or not np.isfinite(s).all())
    del state["program"]
    return len(state["answers"]), failed


def reference_scores(state, prec) -> list:
    """The reference's scores of every chunk at ``prec`` (host arrays)."""
    cfg, device, sizes = state["cfg"], state["device"], state["sizes"]
    fam = ref_steps.family(cfg["reference"])
    params = weights(cfg, state["seed"], device)
    rows = _rows(cfg, sizes, state["seed"], device)
    p = ref_steps.predict(fam, params, rows["cat"], rows["dense"], cfg, prec,
                          cfg["reference_block_rows"]).cpu().numpy()
    del params, rows
    return np.split(p, np.cumsum(sizes)[:-1])


def compare(answers, ref) -> dict:
    """The numbers compared over every answer: the largest gap of a score
    and the root mean square gap."""
    worst, sq, n = 0.0, 0.0, 0
    for c, s in answers:
        r = ref[c]
        if np.shape(s) != r.shape:
            return {"score_max_gap": float("inf"), "score_rms_gap": float("inf")}
        d = np.abs(np.asarray(s, np.float64) - r)
        worst = max(worst, float(np.nan_to_num(d, nan=np.inf).max()))
        sq += float(np.nan_to_num(d, nan=np.inf) @ np.nan_to_num(d, nan=np.inf))
        n += d.size
    return {"score_max_gap": worst, "score_rms_gap": (sq / max(n, 1)) ** 0.5}


def check(state) -> dict:
    return compare(state["answers"], reference_scores(state, state["cfg"]["precision"]))

"""The general traffic generator: Criteo-shaped rows and Glorot weights,
made on the device from the run's seed.

Rows follow ``recman_tpu_torch.data.synthetic_criteo_arrays``, rewritten
for the card: each hashed field draws K ~ Zipf(a) on k >= 1 and takes the
id ``K mod buckets + 1`` (row 0 stays the null row), the first
``informative_fields`` fields and a standard normal draw set the label
(``logit = sum((id % 7 - 3) * 0.3) + N(0, 1)``, ``y = logit > 0``), and
each dense column is ``log1p(lognormal(0, 2))``. The id draw samples the
exact law of ``K mod buckets`` by inverse CDF, so no rejection loop runs
on the card. A configuration's ``data`` block and ``num_buckets`` give
the sizes; a traffic file gives the counts.
"""

from __future__ import annotations

import math

import torch

# separate random streams of one seed: weights, rows, orders
WEIGHTS, ROWS, ORDER = 0, 1, 2


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of ``seed``."""
    return torch.Generator(device=device).manual_seed((int(seed) << 2) | stream)


def zipf_residue_cdf(a: float, buckets: int, device, terms: int = 64) -> torch.Tensor:
    """CDF (float64, (buckets,)) of ``K mod buckets`` for K ~ Zipf(a), k >= 1:
    P(r) is proportional to sum_j (r + j * buckets) ** -a, the first
    ``terms`` terms summed and the rest by Euler-Maclaurin."""
    m = float(buckets)
    r = torch.arange(buckets, dtype=torch.float64, device=device)
    k = r[:, None] + m * torch.arange(terms, dtype=torch.float64, device=device)[None, :]
    head = torch.where(k >= 1, k.clamp_min(1).pow(-a), 0.0).sum(1)
    x = r + terms * m
    tail = x.pow(1 - a) / ((a - 1) * m) + x.pow(-a) / 2 + a * m * x.pow(-a - 1) / 12
    p = head + tail
    return torch.cumsum(p, 0) / p.sum()


def criteo_rows(cfg: dict, n: int, gen: torch.Generator, device) -> dict:
    """``n`` rows of the configuration's sizes: ``cat`` (n, n_cat) int32
    ids in [1, num_buckets], ``dense`` (n, n_dense) f32, ``y`` (n,) f32 in
    {0, 1}."""
    data = cfg["data"]
    n_cat, buckets = int(data["n_cat"]), int(cfg["num_buckets"])
    cdf = zipf_residue_cdf(float(data["zipf_a"]), buckets, device)
    u = torch.rand((n, n_cat), generator=gen, dtype=torch.float64, device=device)
    ids = torch.searchsorted(cdf, u, right=True).clamp_max(buckets - 1) + 1
    del u
    z = torch.randn((n, int(data["n_dense"])), generator=gen, device=device)
    dense = torch.log1p(torch.exp(2.0 * z))
    informative = int(data["informative_fields"])
    logit = (((ids[:, :informative] % 7) - 3).to(torch.float32) * 0.3).sum(1)
    logit = logit + torch.randn((n,), generator=gen, device=device)
    return {"cat": ids.to(torch.int32), "dense": dense, "y": (logit > 0).to(torch.float32)}


def glorot_weights(shapes: dict, gen: torch.Generator, device) -> dict:
    """One tensor per name of ``shapes`` ({name: (shape, kind)}): "glorot",
    N(0, 2 / (rows + cols)) for a matrix; "zeros". The normals of every
    matrix come from one draw, laid out by name, and each leaf is a view
    of it."""
    glorot = sorted(k for k, (_, kind) in shapes.items() if kind == "glorot")
    sizes = [math.prod(shapes[k][0]) for k in glorot]
    flat = torch.randn((sum(sizes),), generator=gen, device=device)
    out, start = {}, 0
    for name, size in zip(glorot, sizes):
        shape = shapes[name][0]
        std = math.sqrt(2.0 / (shape[0] + shape[1]))
        out[name] = flat[start:start + size].view(shape).mul_(std)
        start += size
    for name, (shape, kind) in shapes.items():
        if kind == "zeros":
            out[name] = torch.zeros(shape, dtype=torch.float32, device=device)
        elif kind != "glorot":
            raise ValueError(f"unknown init {kind!r} for {name}")
    return {k: out[k] for k in shapes}


def chunk_sizes(traffic: dict) -> list:
    """Rows of each scoring chunk: a fixed log-uniform grid over
    [chunk_rows_min, chunk_rows_max], the same for every seed (a seed
    orders it)."""
    lo, hi = int(traffic["chunk_rows_min"]), int(traffic["chunk_rows_max"])
    n = int(traffic["chunks"])
    return [int(round(lo * (hi / lo) ** ((i + 0.5) / n))) for i in range(n)]

"""``BENCHMARK.json`` and the data files of cells, found by name.

A cell ``<config>.<traffic>`` reads ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``limits/<cell>.json``; a per-layer metric
reads ``metrics/<name>.json``. Code is found by the names those files
give: ``loops/<loop>.py``, ``readers/<reader>.py``, ``costs/<costs>.py``
and ``reference/<reference>.py``.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def metric(name: str) -> dict:
    return load_json(HERE / "metrics" / f"{name}.json")


def limits(cell: str) -> dict:
    return load_json(HERE / "limits" / f"{cell}.json")


def module(kind: str, name: str):
    """``perfbench.<kind>.<name>``: a loop, reader, costs or reference."""
    return importlib.import_module(f"{__package__}.{kind}.{name}")


def cell(name: str, bench: dict | None = None) -> dict:
    """The cell's ``workloads`` entry with its end-to-end and per-layer
    metrics (the entries that list it, or list no cells)."""
    bench = bench or benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def mine(m):
        return name in m.get("workloads", [name])

    return dict(found[0],
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


def field_names(cfg: dict) -> tuple[list, list]:
    """The hashed and dense columns' names of a configuration's rows."""
    d = cfg["data"]
    return ([d["cat_names"].format(i + 1) for i in range(d["n_cat"])],
            [d["dense_names"].format(i + 1) for i in range(d["n_dense"])])


def peaks(kind: str) -> dict | None:
    """The published peaks of a device by its name, or None."""
    return load_json(HERE / "peaks.json")["devices"].get(kind)

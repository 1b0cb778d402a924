"""Serving artifacts on one CUDA GPU: f32, load-time int8 and runtime int8.

Counterpart of ``tools/bench_serving.py``. Exports the bench xDeepFM (26
hashed fields of 100,000 buckets, k 16, CIN (100, 100), DNN (400, 400);
random params from a seed) with ``Predictor.export`` at batch 8192 three
ways: f32, ``quantize_embeddings=True`` (int8 on disk, f32 tables on the
device after load) and ``"runtime"`` (int8 tables on the device, each
looked-up row dequantized after the gather). Serves 65,536 synthetic
Criteo rows through each ``ExportedPredictor`` and prints one JSON line:
examples/s (median of 3 whole ``predict`` calls, host clock, results on
the host), the table bytes each artifact holds on the device (read from
the tensors held), the program blob's bytes, and the max |delta| of each
artifact's predictions against the f32 artifact's.

Run from the repository root on a machine with a CUDA GPU:

    python -m recman_tpu_torch.tools.bench_serving [--batch 8192] [--rows 65536]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time

import numpy as np
import torch

from recman_tpu_torch.data import create_criteo_features, synthetic_criteo_arrays
from recman_tpu_torch.device import card_line
from recman_tpu_torch.models import XDeepFM
from recman_tpu_torch.serving import EXPORT_BLOB, TABLE_SUFFIXES, ExportedPredictor, Predictor

HPARAMS = {
    "embedding_size": 16,
    "cin_cross_layer_units": (100, 100),
    "cin_dropout": (1, 1, 1),
    "deep_hidden_units": (400, 400),
    "deep_dropout": (1.0, 1.0, 1.0),
}
MODES = {"f32": False, "load_int8": True, "runtime_int8": "runtime"}


def table_bytes(params: dict) -> int:
    """Bytes of the embedding tables among an artifact's params as held (a
    runtime-int8 table's ``::q8`` and ``::q8scale`` tensors)."""
    return sum(v.numel() * v.element_size() for k, v in params.items()
               if k.split("::")[0].endswith(TABLE_SUFFIXES))


def serve_artifacts(predictor, data, directory, batch, repeats=3, **export_kw):
    """Export ``predictor`` in every mode of ``MODES`` under ``directory``,
    load each onto the predictor's device and serve ``data`` through it.
    Returns {mode: {"served", "preds", "examples_per_s", "table_bytes",
    "blob_bytes", "export_s", "load_s"}}; the first predict call is not
    timed."""
    out = {}
    n = len(next(iter(data.values())))
    for mode, quant in MODES.items():
        t0 = time.perf_counter()
        path = predictor.export(os.path.join(directory, mode), data, batch_size=batch,
                                quantize_embeddings=quant, **export_kw)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        served = ExportedPredictor.load(path, device=predictor.device)
        load_s = time.perf_counter() - t0
        preds = served.predict(data)
        walls = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            served.predict(data)
            walls.append(time.perf_counter() - t0)
        out[mode] = {"served": served, "preds": preds,
                     "examples_per_s": n / statistics.median(walls),
                     "table_bytes": table_bytes(served.params),
                     "blob_bytes": os.path.getsize(os.path.join(path, EXPORT_BLOB)),
                     "export_s": export_s, "load_s": load_s}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--rows", type=int, default=65_536)
    ap.add_argument("--num-buckets", type=int, default=100_000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_serving needs a CUDA GPU")

    model = XDeepFM(create_criteo_features(num_buckets=args.num_buckets), HPARAMS)
    predictor = Predictor(model, model.init_params(torch.Generator().manual_seed(0)),
                          batch_size=args.batch)
    data = synthetic_criteo_arrays(args.rows, num_buckets=args.num_buckets, seed=7)
    data.pop("y")
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build") as tmp:  # the artifacts stay in the checkout
        res = serve_artifacts(predictor, data, tmp, args.batch)
    ref = res["f32"]["preds"]
    line = {"card": card_line(), "batch": args.batch, "rows": args.rows}
    for mode, r in res.items():
        line[mode] = {"examples_per_s": r["examples_per_s"], "table_bytes": r["table_bytes"],
                      "blob_bytes": r["blob_bytes"],
                      "max_abs_delta_vs_f32": float(np.abs(r["preds"] - ref).max())}
    line["table_shrink_runtime"] = res["f32"]["table_bytes"] / res["runtime_int8"]["table_bytes"]
    print(json.dumps(line), flush=True)
    err = line["runtime_int8"]["max_abs_delta_vs_f32"]
    if not err < 1e-2:
        raise SystemExit(f"runtime int8 predictions off f32 by {err}")


if __name__ == "__main__":
    main()

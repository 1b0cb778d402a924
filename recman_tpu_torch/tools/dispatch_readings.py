"""The host cost of launching K1 and K4 through their registered ops
(``recman_tpu_torch::cin_chain_fwd``, ``::cin_interact_fwd``) on the live
paths, against the wrappers' direct launches.

Each reading alternates two variants unit by unit in one process: "op",
the package as it is, and "direct", with ``cin_chain.cin_chain_fwd`` and
``cin_interact.cin_interact_fwd`` patched to the direct launches
(``_cin_chain_fm_cuda``, ``_cin_interact_fwd_cuda``; the launch code is
the same, only the dispatch is skipped). A unit is timed on the host
clock from a synchronised card to a synchronised card, the order of the
two variants flips every pair, and the reading is the median of the
pairs' differences (op minus direct), so the host's drift over seconds
does not enter it. On a checkout whose wrappers launch directly, the two
variants run the same code and the reading is the method's noise.

One JSON line per unit, on the models and inputs of ``chip_smoke.py``
(this file's checkout): ``k1_call`` (the bench chain at batch 8192),
``k4_call`` (a paper layer, B*D 40,960), ``forward`` (one bench batch's
eval forward), ``predict`` (``Predictor.predict`` of 65,536 rows at batch
8192), ``stacked_step`` (``make_train_step_stacked`` at 8192) and
``per_layer_step`` (``xdeepfm_paper_criteo``'s ``Trainer.fit_on_batch``
at 4096).

Run from the root of a checkout on a machine with a CUDA GPU; the package
read is the first on ``PYTHONPATH``:

    PYTHONPATH=. python recman_tpu_torch/tools/dispatch_readings.py --tag change
    PYTHONPATH=<other checkout> python recman_tpu_torch/tools/dispatch_readings.py --tag parent
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import importlib.util
import json
import statistics
import time
from pathlib import Path

import torch

PAIRS = {"k1_call": 200, "k4_call": 200, "forward": 60, "predict": 30, "stacked_step": 40,
         "per_layer_step": 40}


@functools.cache
def smoke():
    """chip_smoke.py of this file's checkout, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[2] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def direct_launches(cin_chain, cin_interact, on):
    """With ``on``, the live paths launch K1 and K4 through the wrappers'
    direct launches instead of ``cin_chain_fwd`` and ``cin_interact_fwd``."""
    if not on:
        yield
        return
    saved = cin_chain.cin_chain_fwd, cin_interact.cin_interact_fwd

    def k1(x0c, ws, bs, units, d, act="leaky_relu", save=False):
        return cin_chain._cin_chain_fm_cuda(x0c, list(ws), list(bs), tuple(units), d, act, save)

    cin_chain.cin_chain_fwd, cin_interact.cin_interact_fwd = k1, cin_interact._cin_interact_fwd_cuda
    try:
        yield
    finally:
        cin_chain.cin_chain_fwd, cin_interact.cin_interact_fwd = saved


def paired(unit, n, cin_chain, cin_interact):
    """Host ms of one unit() per variant, alternating; returns the medians
    of each variant and of the pairs' differences, with the differences'
    quartiles."""
    times = {"op": [], "direct": []}
    for i in range(n + 2):  # the first two pairs warm up
        for variant in ("op", "direct") if i % 2 else ("direct", "op"):
            with direct_launches(cin_chain, cin_interact, variant == "direct"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                unit()
                torch.cuda.synchronize()
                times[variant].append((time.perf_counter() - t0) * 1e3)
    op, direct = times["op"][2:], times["direct"][2:]
    diffs = [a - b for a, b in zip(op, direct)]
    q1, _, q3 = statistics.quantiles(diffs, n=4)
    return {"pairs": n, "op_ms": statistics.median(op), "direct_ms": statistics.median(direct),
            "diff_ms": statistics.median(diffs), "diff_q1_ms": q1, "diff_q3_ms": q3}


def readings(tag):
    import recman_tpu_torch
    from recman_tpu_torch.data import create_criteo_features, synthetic_criteo_arrays
    from recman_tpu_torch.models import XDeepFM
    from recman_tpu_torch.ops import cin_chain, cin_interact, cuda_build
    from recman_tpu_torch.serving import Predictor, batch_indices
    from recman_tpu_torch.training import (
        LogLoss, TrainState, Trainer, create_optimizer, make_train_step_stacked, pack_dataset,
        stack_table_params,
    )

    cs = smoke()
    cuda_build.build()
    base = {"tag": tag, "package": str(Path(recman_tpu_torch.__file__).parent),
            "registered_ops": hasattr(cin_chain, "_cin_chain_fwd_op"), "card": cs.card_line()}
    device = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    units = {}

    # K1 and K4 alone
    h0, layers, b, d = 26, (100, 100), cs.BATCH, cs.HPARAMS["embedding_size"]
    x0c = torch.randn((h0, b * d), generator=gen).to(device)
    cfgs = cin_chain._layer_cfgs(h0, layers)
    ws = [torch.randn((h0 * c.hk, c.o), generator=gen).mul_(0.05).to(device) for c in cfgs]
    bs = [torch.randn((c.o,), generator=gen).to(device) for c in cfgs]
    units["k1_call"] = lambda: cin_chain.cin_chain_fwd(x0c, ws, bs, layers, d)
    bd = cs.PAPER_BATCH * cs.PAPER_HP["embedding_size"]
    x0 = torch.randn((26, bd), generator=gen).to(device)
    xk = torch.randn((100, bd), generator=gen).to(device)
    w = torch.randn((2600, 200), generator=gen).mul_(0.05).to(device)
    units["k4_call"] = lambda: cin_interact.cin_interact_fwd(x0, xk, w)

    # serving: one batch's forward and a whole predict
    model = XDeepFM(create_criteo_features(num_buckets=cs.NUM_BUCKETS), cs.HPARAMS)
    data = synthetic_criteo_arrays(cs.N_ROWS, num_buckets=cs.NUM_BUCKETS, seed=2019)
    data.pop("y")
    predictor = Predictor(model, model.init_params(torch.Generator().manual_seed(0)),
                          batch_size=cs.BATCH)
    dev = {k: torch.as_tensor(v[:cs.BATCH]).to(device) for k, v in data.items()}
    override = torch.as_tensor(model.linear.override_vector()).to(device)

    def forward():
        with torch.inference_mode():
            return model.apply(predictor.params, dev, linear_override=override)

    units["forward"] = forward
    units["predict"] = lambda: predictor.predict(data)

    # the stacked step
    opt = create_optimizer("adam", 1e-3)
    sparams, names = stack_table_params(model, model.init_params(torch.Generator().manual_seed(0)))
    packed, layout = pack_dataset(
        synthetic_criteo_arrays(cs.N_ROWS, num_buckets=cs.NUM_BUCKETS, seed=2019))
    idx_np = batch_indices(cs.N_ROWS, cs.BATCH, shuffle_seed=0)
    idx = torch.as_tensor(idx_np[(idx_np >= 0).all(axis=1)]).to(device)
    pdata = {k: torch.as_tensor(v).to(device) for k, v in packed.items()}
    step = make_train_step_stacked(model, opt, 1, names)
    box = {"state": TrainState(sparams, opt.init(sparams), 0, None), "i": 0}

    def stacked():
        j = box["i"] % idx.shape[0]
        box["state"], _ = step(box["state"], pdata, idx[j:j + 1], layout)
        box["i"] += 1

    units["stacked_step"] = stacked

    # the per-layer step
    hp = cs.PAPER_HP
    tr = Trainer(XDeepFM(create_criteo_features(num_buckets=cs.NUM_BUCKETS), hp), hp,
                 metrics=(LogLoss(),), epoch=1, batch_size=cs.PAPER_BATCH, random_seed=2019,
                 device=device)
    x = synthetic_criteo_arrays(cs.PAPER_ROWS, num_buckets=cs.NUM_BUCKETS, seed=3)
    y = x.pop("y")
    d_, layout_ = tr._to_device(x, y)
    pidx = tr._idx(batch_indices(cs.PAPER_ROWS, cs.PAPER_BATCH, shuffle_seed=7))
    units["per_layer_step"] = lambda: tr.fit_on_batch(d_, pidx[box["i"] % pidx.shape[0]], layout_)

    for name, unit in units.items():
        print(json.dumps({"reading": name, **base,
                          **paired(unit, PAIRS[name], cin_chain, cin_interact)}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="change")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dispatch_readings needs a CUDA GPU")
    readings(args.tag)


if __name__ == "__main__":
    main()

"""The reduction by program span (``perfbench/spans.py``) on synthetic
events, the span readers on synthetic runs and on a run of a program
without spans, and a cell's untraced window recorded at a size the CPU
holds."""

from __future__ import annotations

from collections import namedtuple

import pytest

from perfbench import spans, spec
from perfbench.trace import GAP_MIN_NS

US = 1_000  # ns
STEP = [(0, 100 * US, "recman.train.step"), (10 * US, 40 * US, "recman.train.loss"),
        (20 * US, 30 * US, "recman.train.l2"), (50 * US, 90 * US, "recman.train.backward")]
# correlation id -> launch time: in loss, in l2, in backward (the
# autograd thread's launch, which no span of its own thread holds), after
# the step
LAUNCHES = {1: 15 * US, 2: 25 * US, 3: 60 * US, 4: 120 * US}
# device operations (start, end, correlation id), the last launched before
# the window
OPS = [(200 * US, 210 * US, 1), (230 * US, 250 * US, 2), (252 * US, 262 * US, 3),
       (300 * US, 301 * US, 4), (301 * US, 302 * US, 99)]
Record = namedtuple("Record", "name parent id start_ns end_ns")


def test_timeline_names_the_innermost_span():
    bounds, names = spans.timeline(STEP)
    at = {t: names[max(i for i, b in enumerate(bounds) if b <= t)] for t in
          (5 * US, 15 * US, 25 * US, 35 * US, 45 * US, 60 * US, 95 * US, 150 * US)}
    assert at == {5 * US: "recman.train.step", 15 * US: "recman.train.loss",
                  25 * US: "recman.train.l2", 35 * US: "recman.train.loss",
                  45 * US: "recman.train.step", 60 * US: "recman.train.backward",
                  95 * US: "recman.train.step", 150 * US: None}


def test_operations_go_to_the_innermost_span_of_their_launch():
    r = spans.by_span(STEP, LAUNCHES, OPS)
    assert r["device_ns"] == {"recman.train.loss": 10 * US, "recman.train.l2": 20 * US,
                              "recman.train.backward": 10 * US, spans.OUTSIDE: 2 * US}
    assert r["launches"] == {"recman.train.loss": 1, "recman.train.l2": 1,
                             "recman.train.backward": 1, spans.OUTSIDE: 2}


def test_idle_gaps_go_to_the_span_holding_their_start():
    # the device empties at 35 us (the host in loss: 35 us idle), at 80 us
    # (2 us, too short to count) and at 84 us (the host in backward: 11 us)
    ops = [(20 * US, 35 * US, 1), (70 * US, 80 * US, 2), (82 * US, 84 * US, 3),
           (95 * US, 96 * US, 4)]
    assert 2 * US < GAP_MIN_NS < 11 * US
    assert spans.by_span(STEP, LAUNCHES, ops)["idle_ns"] == {
        "recman.train.loss": 35 * US, "recman.train.backward": 11 * US}


def test_a_kernel_launched_from_another_thread_inside_a_span_goes_to_it():
    # backward's launch at 60 us is on autograd's thread; only time decides
    r = spans.by_span(STEP, {7: 60 * US}, [(500 * US, 510 * US, 7)])
    assert r["device_ns"] == {"recman.train.backward": 10 * US}


def _run(with_spans):
    records = [Record(n, None, 0, s, e) for s, e, n in STEP]
    run = {"host": {"units": {"step": 2, "request": 4}}, "traced": {"units": {"step": 3}},
           "labelled": {"units": {"step": 1}}}
    if with_spans:
        run["spans"] = dict(spans.by_span(STEP, LAUNCHES, OPS),
                            host_ns=spans.host_ns(records))
        run["counters"] = {"ROWS": 300, "PADDED_ROWS": 100, "H2D_BYTES": 9_000_000}
    return run


def _read(name, run):
    m = spec.metric(name)
    return spec.module("readers", m["reader"]).read(m, run)


def test_the_readers_read_a_run_with_spans():
    run = _run(True)
    assert _read("loss_device_ms.train", run) == pytest.approx(0.030)
    assert _read("backward_device_ms.train", run) == pytest.approx(0.010)
    assert _read("optimizer_device_ms.train", run) is None  # no operation launched there
    assert _read("padded_share.score", run) == pytest.approx(25.0)
    assert _read("h2d_mb.score", run) == pytest.approx(2.25)  # 9 MB over 4 requests
    # host ms over the untraced window's 2 steps
    m = {"reader": "span_host_ms", "spans": ["recman.train.loss"], "per": "step"}
    assert spec.module("readers", "span_host_ms").read(m, run) == pytest.approx(0.015)
    m = {"reader": "span_launches", "spans": ["recman.train.loss", "recman.train.l2"],
         "per": "step"}
    assert spec.module("readers", "span_launches").read(m, run) == 2


METRICS = {"train": ["loss_device_ms.train", "backward_device_ms.train",
                     "optimizer_device_ms.train", "optimizer_host_ms.train",
                     "optimizer_launches.train"],
           "score_closed": ["predict_h2d_ms.score", "predict_d2h_ms.score",
                            "padded_share.score", "h2d_mb.score"]}
HOST = {"train": ["optimizer_host_ms.train"],
        "score_closed": ["predict_h2d_ms.score", "predict_d2h_ms.score",
                         "padded_share.score", "h2d_mb.score"]}


@pytest.mark.parametrize("name", [n for names in METRICS.values() for n in names])
def test_every_reader_gives_none_without_spans(name):
    assert _read(name, _run(False)) is None
    assert _read(name, dict(_run(False), spans={"host_ns": {}, "device_ns": {},
                                                 "launches": {}, "idle_ns": {}},
                            counters={})) is None


@pytest.mark.parametrize("cell", ["dlrm_mlperf_criteo.train_b2048",
                                  "xdeepfm_bench_criteo.score_chunks"])
def test_a_cells_untraced_window_recorded(tiny, cell):
    """The untraced window under the program's recording, with its counters
    read around it, gives every host metric of the cell a number."""
    kind = spec.traffic(spec.cell(cell)["traffic"])["loop"]
    loop = spec.module("loops", kind)
    c = spec.cell(cell)
    state = loop.setup(spec.config(c["config"]), spec.traffic(c["traffic"]), 2**31 + 5, "cpu")
    before = spans.counters()
    with spans.recording() as records:
        host = loop.window(state, 0.2)
    after = spans.counters()
    run = {"host": host, "spans": {"host_ns": spans.host_ns(records)},
           "counters": {k: after[k] - before[k] for k in after}}
    values = {n: _read(n, run) for n in HOST[kind]}
    assert loop.finish(state)[1] == 0 and all(v > 0 for v in values.values()), values
    if kind == "train":
        assert set(run["spans"]["host_ns"]) == {
            "recman.train.step", "recman.train.loss", "recman.train.l2",
            "recman.train.backward", "recman.train.optimizer"}
    else:
        batch = spec.traffic("score_chunks")["batch"]
        assert values["padded_share.score"] == pytest.approx(
            100.0 * (1 - host["units"]["row"] / (host["units"]["batch"] * batch)))

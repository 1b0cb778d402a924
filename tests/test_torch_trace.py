"""The port's spans and counters (``obs/trace.py``, ``serving.py``) on the
CPU at tiny widths: off they cost a shared no-op; under ``recording()`` one
training step and one ``Predictor.predict`` give their spans in order,
nested and sharing an id; the counters move by the rows, padding and
bytes of the request; the spans sit on the profiler's clock; and
recording changes no number."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from recman_tpu_torch import models, serving
from recman_tpu_torch.data import create_criteo_features, synthetic_criteo_arrays
from recman_tpu_torch.obs import trace
from recman_tpu_torch.serving import Predictor
from recman_tpu_torch.training import Trainer, pack_dataset
from tests.torch_threads import worker_threads  # noqa: F401  (autouse)

BUCKETS, BATCH, ROWS = 50, 16, 64
HP = {
    "xdeepfm": ("XDeepFM", {
        "embedding_size": 4, "embedding_l2_reg": 1e-5, "linear_l2_reg": 1e-5,
        "cin_cross_layer_units": [6, 6], "cin_activation": "leaky_relu",
        "cin_dropout": [1, 1, 1], "cin_l2_reg": 1e-5, "deep_hidden_units": [8],
        "deep_activation": "leaky_relu", "deep_dropout": [1.0, 1.0], "deep_l2_reg": 1e-5,
        "optimizer": "adam", "learning_rate": 1e-3}),
    "dlrm": ("DLRM", {
        "embedding_size": 4, "embedding_l2_reg": 0.0, "bot_hidden_units": [8],
        "bot_activation": "relu", "bot_l2_reg": 0.0, "top_hidden_units": [8],
        "top_activation": "relu", "top_dropout": [1.0, 1.0], "top_l2_reg": 0.0,
        "optimizer": "sgd", "learning_rate": 0.1}),
}
FAMILIES = sorted(HP)
STEP = ["recman.train.step", "recman.train.loss", "recman.train.l2", "recman.train.backward",
        "recman.train.optimizer"]
PARENT = {"recman.train.loss": "recman.train.step", "recman.train.l2": "recman.train.loss",
          "recman.train.backward": "recman.train.step",
          "recman.train.optimizer": "recman.train.step", "recman.predict.h2d": "recman.predict",
          "recman.predict.override": "recman.predict.h2d",
          "recman.predict.forward": "recman.predict", "recman.predict.d2h": "recman.predict"}


def _trainer(family):
    cls, hp = HP[family]
    model = getattr(models, cls)(create_criteo_features(num_buckets=BUCKETS), dict(hp))
    return Trainer(model, dict(hp), batch_size=BATCH, device="cpu")


@pytest.fixture(scope="module")
def rows():
    arr = synthetic_criteo_arrays(ROWS, num_buckets=BUCKETS)
    data, layout = pack_dataset(arr)
    return {k: torch.as_tensor(v) for k, v in data.items()}, layout, \
        {k: v for k, v in arr.items() if k != "y"}


def _steps(trainer, rows, count):
    data, layout, _ = rows
    for s in range(count):
        trainer.fit_on_batch(data, np.arange(BATCH) + BATCH * s, layout)


def _nested(records):
    """Every child lies inside its parent, in the parent's tree."""
    for r in records:
        if r.parent is None:
            continue
        assert r.parent == PARENT[r.name]
        holders = [p for p in records if p.name == r.parent and p.id == r.id
                   and p.start_ns <= r.start_ns and r.end_ns <= p.end_ns]
        assert holders, r


def test_off_span_is_the_shared_noop_and_records_nothing(rows):
    assert trace.span("train.step") is trace.NOOP and trace.span("predict") is trace.NOOP
    _steps(_trainer("dlrm"), rows, 1)
    with trace.recording() as records:
        assert isinstance(trace.span("train.step"), trace._Span)
    assert records == [] and trace.span("train.step") is trace.NOOP


@pytest.mark.parametrize("family", FAMILIES)
def test_a_training_step_records_its_layers_in_order(family, rows):
    trainer = _trainer(family)
    with trace.recording() as records:
        _steps(trainer, rows, 1)
    records = sorted(records, key=lambda r: r.start_ns)
    assert [r.name for r in records] == STEP
    assert {r.id for r in records} == {records[0].id} and records[0].parent is None
    _nested(records)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n", [40, 32])
def test_predict_records_copies_forwards_and_wait_and_counts(family, n, rows):
    trainer = _trainer(family)
    pred = Predictor(trainer.model, trainer.state.params, batch_size=BATCH, device="cpu")
    chunk = {k: v[:n] for k, v in rows[2].items()}
    before = (serving.ROWS, serving.PADDED_ROWS, serving.H2D_BYTES)
    with trace.recording() as records:
        pred.predict(chunk)
    batches = n // BATCH + 1
    override = trainer.model.linear.override_vector().nbytes if family == "xdeepfm" else 0
    assert (serving.ROWS - before[0], serving.PADDED_ROWS - before[1],
            serving.H2D_BYTES - before[2]) == (
        n, batches * BATCH - n,
        sum(v.nbytes for v in chunk.values()) + batches * BATCH * 4 + override)
    records = sorted(records, key=lambda r: r.start_ns)
    h2d = ["recman.predict.h2d"] + (["recman.predict.override"] if override else [])
    assert [r.name for r in records] == (["recman.predict"] + h2d
                                         + ["recman.predict.forward"] * batches
                                         + ["recman.predict.d2h"])
    assert {r.id for r in records} == {records[0].id}
    _nested(records)


def test_spans_share_the_profilers_clock(rows):
    trainer = _trainer("xdeepfm")
    _steps(trainer, rows, 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof, trace.recording() as records:
        _steps(trainer, rows, 1)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU]
    ranges = sorted((e for e in events if e.name().startswith(trace.PREFIX)),
                    key=lambda e: e.start_ns())
    records = sorted(records, key=lambda r: r.start_ns)
    assert [e.name() for e in ranges] == [r.name for r in records] == STEP
    ops = [e for e in events if e.name().startswith("aten::")]
    for e, r in zip(ranges, records):
        assert abs(e.start_ns() - r.start_ns) < 1e6 and abs(e.end_ns() - r.end_ns) < 1e6
        inside = [o for o in ops if e.start_ns() <= o.start_ns() and o.end_ns() <= e.end_ns()]
        assert inside and all(r.start_ns <= o.start_ns() and o.end_ns() <= r.end_ns
                              for o in inside), e.name()


@pytest.mark.parametrize("family", FAMILIES)
def test_recording_changes_no_number(family, rows):
    plain, recorded = _trainer(family), _trainer(family)
    _steps(plain, rows, 3)
    with trace.recording() as records:
        _steps(recorded, rows, 3)
    assert records
    for k, v in plain.state.params.items():
        assert torch.equal(v, recorded.state.params[k]), k
    chunk = {k: v[:40] for k, v in rows[2].items()}
    scores = Predictor(plain.model, plain.state.params, batch_size=BATCH,
                       device="cpu").predict(chunk)
    with trace.recording():
        again = Predictor(recorded.model, recorded.state.params, batch_size=BATCH,
                          device="cpu").predict(chunk)
    assert np.array_equal(scores, again)

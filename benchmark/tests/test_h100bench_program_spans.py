"""The five readers of the program's own spans (`layer_metrics/_program.py`
and the metrics with `"source": "program_span"`) on a hand-built traced
slice and span list, and their silence where there is nothing to read:
no slice, no device events, a program without spans, no span to divide
by."""
from __future__ import annotations

import types

import pytest

from h100bench_helpers import common

from benchmark import tracing
from capdec_tpu_torch.utils import profiling

MS = 1_000_000
T0, T1 = 100 * MS, 200 * MS
# the device is busy in [100, 105], [108, 120] and [150, 200] ms
DEVICE = [("k", 100 * MS, 105 * MS), ("k", 108 * MS, 115 * MS),
          ("k", 112 * MS, 120 * MS), ("Memcpy HtoD", 150 * MS, 210 * MS)]


def span(name, start, end, id, parent=None, **meta):
    return profiling.Span(name, int(start * MS), int(end * MS), 1, id,
                          parent, meta)


SPANS = [
    # a batch begun before the slice, with a step in it
    span("decode.batch", 40, 104, 1, batch=0),
    span("decode.step", 99, 103, 2, 1, step=65),
    span("decode.stop_flag", 102, 103, 3, 2),
    # the batch begun in the slice: idle 105-108 before its first step
    span("decode.batch", 102, 230, 10, batch=1),
    span("decode.stop_flag", 102.5, 103, 11, 10),
    span("decode.step", 110, 118, 12, 10, step=1),
    span("decode.stop_flag", 116, 118, 13, 12),   # issue 6 ms
    span("decode.step", 118, 130, 14, 10, step=2),
    span("decode.stop_flag", 127, 130, 15, 14),   # issue 9 ms
    span("decode.step", 130, 140, 16, 10, step=3),  # no read: not counted
    # the serving thread's detokenizing: idle 105-108 and 120-125, and
    # none in the slice under the one that outlasts it
    span("serve.finish", 103, 126, 20, batch=0),
    span("serve.detokenize", 104, 125, 21, 20, batch=0),
    span("serve.finish", 190, 240, 22, batch=1),
    span("serve.detokenize", 190, 240, 23, 22, batch=1),
    # outside the slice
    span("decode.batch", 250, 300, 30, batch=2),
    span("serve.detokenize", 250, 260, 31, batch=2),
]

TRAIN = [
    span("train.step", 100, 150, 1, step=7),
    span("train.forward", 100, 110, 2, 1),       # idle 105-108: 3 ms
    span("train.backward", 110, 140, 3, 1),      # idle 120-140: 20 ms
    span("train.optimizer", 140, 150, 4, 1),
    span("train.step", 150, 200, 5, step=8),
    span("train.forward", 150, 160, 6, 5),       # busy
    span("train.backward", 160, 195, 7, 5),      # busy
    span("train.optimizer", 195, 200, 8, 5),
]


def ctx(events=DEVICE, trace=True):
    t = tracing.TraceSlice(events, [], T0, T1) if trace else None
    return types.SimpleNamespace(cfg={}, traffic={}, counters={}, trace=t)


def read(name, c):
    return common.metric_reader(name).read(c)


@pytest.fixture
def recorded(monkeypatch):
    def use(spans):
        monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    return use


def test_host_issue_ms_per_step(recorded):
    recorded(SPANS)
    # steps begun in the slice with a flag read: 6 and 9 ms
    assert read("host_issue_ms_per_step.offline", ctx()) == \
        pytest.approx(7.5)


def test_idle_in_detokenize_ms_per_batch(recorded):
    recorded(SPANS)
    # 3 + 5 ms of idle under the slice's detokenizing; one batch begun
    assert read("idle_in_detokenize_ms_per_batch.offline", ctx()) == \
        pytest.approx(8.0)


def test_idle_at_batch_start_ms_per_batch(recorded):
    recorded(SPANS)
    assert read("idle_at_batch_start_ms_per_batch.offline", ctx()) == \
        pytest.approx(3.0)
    # a batch with no step yet: up to the slice's end (idle 105-108 and
    # 120-150)
    recorded([s for s in SPANS if s.name != "decode.step"])
    assert read("idle_at_batch_start_ms_per_batch.offline", ctx()) == \
        pytest.approx(33.0)


def test_idle_in_forward_and_backward_ms_per_step(recorded):
    recorded(TRAIN)
    assert read("idle_in_forward_ms_per_step.train", ctx()) == \
        pytest.approx(1.5)
    assert read("idle_in_backward_ms_per_step.train", ctx()) == \
        pytest.approx(10.0)


READERS = ["host_issue_ms_per_step.offline",
           "idle_in_detokenize_ms_per_batch.offline",
           "idle_at_batch_start_ms_per_batch.offline",
           "idle_in_forward_ms_per_step.train",
           "idle_in_backward_ms_per_step.train"]


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_reads_none(name, recorded, monkeypatch):
    recorded(SPANS + TRAIN)
    assert read(name, ctx()) is not None
    assert read(name, ctx(trace=False)) is None
    assert read(name, ctx(events=[])) is None
    recorded([])
    assert read(name, ctx()) is None
    # the spans outside the slice only
    recorded([s for s in SPANS if s.start_ns >= T1])
    assert read(name, ctx()) is None
    # an older program, whose profiling module records no spans
    monkeypatch.delattr(profiling, "spans")
    assert read(name, ctx()) is None


def test_entries_name_the_readers():
    bench = common.benchmark()
    mine = [m for m in bench["per_layer"] if m["source"] == "program_span"]
    assert [m["name"] for m in mine] == READERS
    for m in mine:
        assert m["unit"] == "ms" and m["better"] == "lower"
        train = m["name"].endswith(".train")
        assert m["moves"] == ("train_peak_memory_gb" if train
                              else "captions_per_s")
        assert m["workloads"] == (["flagship-train-coco",
                                   "flagship-train-dp4"] if train else
                                  ["flagship-beam-offline",
                                   "clipcap-mlp-beam-offline"])

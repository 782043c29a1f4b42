"""The port's profiling and process setup (capdec_tpu_torch/utils/
profiling.py, utils/torch_setup.py).

  * `trace(log_dir)` writes a Chrome trace of the block on the CPU, with
    the program's spans of the block in it as complete events on their
    threads, on the trace's own time base.
  * Spans are recorded only while a torch.profiler session is open: with
    none, a tiny serve and a tiny train step record nothing and read no
    clock at a span site.
  * Inside a profiler: one `decode.batch` a batch with its entry_length - 1
    `decode.step` spans, each step's `decode.stop_flag` read, parents and
    batch ids shared by the serving thread's spans and the decoding
    thread's; `train.step` around `train.forward`, `train.backward` and
    `train.optimizer`, in that order; a CPU op's profiler event inside the
    span around it.
  * The server's counters: decode steps, captions stopped early, the
    decoding thread's time and the per-request queue wait.
  * `setup_torch(debug_nans=True)` raises on a NaN in the backward (the
    counterpart of jax_debug_nans), and without it the backward runs.
"""
import json
import os
import threading
import types

import numpy as np
import pytest
import torch

from capdec_tpu_torch import serve
from capdec_tpu_torch.decode import beam
from capdec_tpu_torch.models import caption_model, gpt2
from capdec_tpu_torch.train import optim as optim_lib
from capdec_tpu_torch.train import step as step_lib
from capdec_tpu_torch.utils import profiling, torch_setup

K, D, E = 3, 16, 6


class IdTokenizer:
    """Token ids joined by commas, so a caption's length can be read."""

    def decode(self, ids) -> str:
        return ",".join(map(str, ids.tolist()))


@pytest.fixture(scope="module")
def tiny():
    cfg = caption_model.CaptionModelConfig(
        prefix_length=K, clip_length=K, prefix_size=D, num_layers=1,
        mapping_type="mlp",
        gpt2=gpt2.GPT2Config(vocab_size=64, n_positions=32, n_embd=32,
                             n_layer=1, n_head=2))
    model = caption_model.init_params(cfg, torch.Generator().manual_seed(3))
    return cfg, model


@pytest.fixture(autouse=True)
def no_spans_left():
    profiling.clear()
    yield
    profiling.clear()


def server(tiny, stop_token=-1, beam_size=2, greedy=False):
    cfg, model = tiny
    return serve.CaptionServer(
        model, cfg, IdTokenizer(),
        serve.ServeConfig(batch_size=2, max_wait_s=0.01, beam=not greedy,
                          beam_config=beam.BeamConfig(
                              beam_size=beam_size, entry_length=E,
                              stop_token=stop_token),
                          topp_config=serve.ToppConfig(
                              entry_length=E, stop_token=stop_token)),
        device="cpu")


def requests(n=5, seed=0):
    embs = np.random.RandomState(seed).randn(n, D).astype(np.float32)
    return list(enumerate(embs))


def train_step(tiny):
    cfg, model = tiny
    model = caption_model.init_params(cfg, torch.Generator().manual_seed(4))
    opt, sched = optim_lib.make_optimizer(
        caption_model.set_trainable(model, cfg), 1e-3, 10, 100)
    state = step_lib.init_train_state(model, opt, sched)
    step_fn = step_lib.make_train_step(cfg,
                                       step_lib.NoiseConfig(variance=0.01))
    rng = np.random.RandomState(1)
    batch = {"tokens": rng.randint(1, 64, size=(2, 5)),
             "mask": np.ones((2, K + 5), np.float32),
             "prefix": rng.randn(2, D).astype(np.float32)}
    return step_fn(state, batch, 7)


def named(spans, name):
    return [s for s in spans if s.name == name]


def test_the_profiler_flag_the_recorder_reads():
    """The recorder records while torch.autograd.profiler's module flag is
    set, which torch.profiler sets for the length of a session; a torch
    that moves or renames it fails here."""
    flag = torch.autograd.profiler._is_profiler_enabled
    assert flag is False
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        assert torch.autograd.profiler._is_profiler_enabled is True
        assert isinstance(profiling.span("x"), profiling._Recording)
    finally:
        prof.stop()
    assert torch.autograd.profiler._is_profiler_enabled is False
    assert profiling.span("x") is profiling._NO_SPAN


def test_no_span_and_no_clock_without_a_profiler(tiny, monkeypatch):
    def no_clock():
        raise AssertionError("a span site read the clock")
    monkeypatch.setattr(profiling, "time",
                        types.SimpleNamespace(time_ns=no_clock))
    assert profiling.span("a", batch=1) is profiling.span("b")
    srv = server(tiny)
    got = dict(srv.serve(iter(requests())))
    assert sorted(got) == list(range(5))
    train_step(tiny)
    assert profiling.spans() == []


def test_serve_spans_inside_a_profiler(tiny):
    srv = server(tiny)
    srv.warmup()                      # batch 0, no profiler open
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = dict(srv.serve(iter(requests())))
    assert sorted(got) == list(range(5))
    spans = profiling.spans()
    by_id = {s.id: s for s in spans}
    main = threading.get_native_id()

    batches = named(spans, "decode.batch")
    assert sorted(s.meta["batch"] for s in batches) == [1, 2, 3]
    steps = named(spans, "decode.step")
    flags = named(spans, "decode.stop_flag")
    for b in batches:
        assert b.tid != main and b.parent is None
        mine = sorted((s for s in steps if s.parent == b.id),
                      key=lambda s: s.start_ns)
        # random weights and no stop token: every batch runs E - 1 steps
        assert [s.meta["step"] for s in mine] == list(range(1, E))
        for s in mine:
            assert s.meta["batch"] == b.meta["batch"] and s.tid == b.tid
            assert b.start_ns <= s.start_ns <= s.end_ns <= b.end_ns
            kids = [f for f in flags if f.parent == s.id]
            # the read that follows a step; the last step (i reaches E)
            # is followed by none
            assert len(kids) == (0 if s is mine[-1] else 1)
            for f in kids:
                assert s.start_ns <= f.start_ns <= f.end_ns <= s.end_ns
        # before the first step: the loop's two reads at its stage's start
        assert len([f for f in flags if f.parent == b.id]) == 2
    assert len(steps) == 3 * (E - 1) == srv.stats["decode_steps"]

    finishes = named(spans, "serve.finish")
    assert sorted(s.meta["batch"] for s in finishes) == [1, 2, 3]
    collects = named(spans, "serve.collect")
    assert {1, 2, 3} <= {s.meta["batch"] for s in collects}
    for s in finishes + collects:
        assert s.tid == main and s.parent is None
    for d in named(spans, "serve.detokenize"):
        parent = by_id[d.parent]
        assert parent.name == "serve.finish"
        assert d.meta["batch"] == parent.meta["batch"]
        assert parent.start_ns <= d.start_ns <= d.end_ns <= parent.end_ns
    assert len(named(spans, "serve.detokenize")) == 3
    # each batch is collected and launched before it decodes, and
    # decoded before it is finished
    for b in batches:
        f, = [s for s in finishes if s.meta["batch"] == b.meta["batch"]]
        c = [s for s in collects if s.meta["batch"] == b.meta["batch"]][-1]
        assert c.start_ns <= b.start_ns and b.end_ns <= f.end_ns


def test_train_step_spans_nest_in_order(tiny):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        state, loss = train_step(tiny)
    assert state["step"] == 1 and torch.isfinite(loss)
    spans = profiling.spans()
    step, = named(spans, "train.step")
    assert step.meta == {"step": 0} and step.parent is None
    kids = sorted((s for s in spans if s.parent == step.id),
                  key=lambda s: s.start_ns)
    assert [s.name for s in kids] == ["train.forward", "train.backward",
                                      "train.optimizer"]
    for a, b in zip(kids, kids[1:]):
        assert a.end_ns <= b.start_ns
    assert step.start_ns <= kids[0].start_ns
    assert kids[-1].end_ns <= step.end_ns
    assert len(spans) == 4


def test_cpu_op_lies_inside_its_span():
    a = torch.randn(256, 256)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("around"):
            a @ a                     # room on both sides of the op
            torch.tanh(a)
            a @ a
    sp, = profiling.spans()
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::tanh"]
    assert len(ops) == 1
    assert sp.start_ns <= ops[0].start_ns() <= ops[0].end_ns() <= sp.end_ns


def test_trace_and_summary_on_the_cpu(tmp_path):
    """trace() writes the block's Chrome trace, with the program's spans
    of the block in it as complete events."""
    d = str(tmp_path / "trace")
    a = torch.randn(64, 64)
    with profiling.span("before"):    # no profiler open: not recorded
        pass
    with profiling.trace(d) as where:
        assert where == d
        with profiling.span("outer", batch=3):
            with profiling.span("inner"):
                for _ in range(3):
                    (a @ a).relu_()
    files = [f for f in os.listdir(d) if f.endswith(profiling.TRACE_SUFFIX)]
    assert len(files) == 1
    with open(os.path.join(d, files[0])) as f:
        events = json.load(f)["traceEvents"]
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("cat") != "program_span"]
    assert any("mm" in e["name"] or "matmul" in e["name"] for e in ops)
    mine = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert set(mine) == {"outer", "inner"}
    outer, inner = mine["outer"], mine["inner"]
    assert inner["args"] == {"id": inner["args"]["id"],
                             "parent": outer["args"]["id"], "batch": 3}
    assert outer["args"]["parent"] is None
    assert outer["pid"] == os.getpid()
    assert outer["tid"] == inner["tid"] == threading.get_native_id()
    # on the trace's time base: the block's matmuls lie inside `inner`
    for e in ops:
        if e["name"] == "aten::mm":
            assert inner["ts"] <= e["ts"]
            assert e["ts"] + e["dur"] <= inner["ts"] + inner["dur"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


@pytest.mark.parametrize("greedy", [False, True], ids=["beam", "greedy"])
def test_server_counts_steps_stops_and_queue_waits(tiny, greedy):
    # one beam (or greedy decoding), so a caption stops at the stop
    # token's first place in the caption served without one; the stop
    # token is the first caption's first token
    first = server(tiny, beam_size=1, greedy=greedy)
    caps = dict(first.serve(iter(requests(8, 1))))
    caps = [caps[i].split(",") for i in range(8)]
    assert all(len(c) == E for c in caps)
    stop = caps[0][0]
    want = [c.index(stop) + 1 if stop in c[:E - 1] else E for c in caps]
    srv = server(tiny, stop_token=int(stop), beam_size=1, greedy=greedy)
    got = dict(srv.serve(iter(requests(8, 1))))
    assert [len(got[i].split(",")) for i in range(8)] == want
    stats = srv.stats
    assert stats["batches"] == 4 and stats["requests"] == 8
    assert stats["captions_stopped"] == sum(n < E for n in want) > 0
    # a batch runs until both its captions stop
    assert stats["decode_steps"] == sum(
        min(E, max(want[i], want[i + 1])) - 1 for i in range(0, 8, 2))
    assert stats["decode_s"] > 0 and srv.throughput() > 0
    pct = srv.latency_percentiles()
    assert pct["n"] == 8
    assert 0 <= pct["wait_p50"] <= pct["wait_p95"] <= pct["p95"]
    assert first.stats["captions_stopped"] == 0
    assert first.stats["decode_steps"] == 4 * (E - 1)


def test_debug_nans_raises_on_a_nan_backward():
    def nan_backward():
        x = torch.tensor([-1.0, 4.0], requires_grad=True)
        torch.sqrt(x).sum().backward()
        return x.grad

    assert torch.isnan(nan_backward()).any()  # no check: NaN passes
    try:
        torch_setup.setup_torch(debug_nans=True)
        assert torch.is_anomaly_enabled()
        with pytest.raises(RuntimeError, match="nan"), \
                pytest.warns(UserWarning, match="Error detected in Sqrt"):
            nan_backward()
    finally:
        torch.autograd.set_detect_anomaly(False)
    torch_setup.setup_torch()
    assert not torch.is_anomaly_enabled()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch_setup.resolve_device("cpu") == torch.device("cpu")

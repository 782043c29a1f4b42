"""`epilogue_ms_per_batch.offline` on a hand-built traced slice: the
device time of the fused epilogues' kernels per batch's worth of decode
steps, and None where there is nothing to read (no slice, no decode
step, a program without the epilogues)."""
from __future__ import annotations

import types

from h100bench_helpers import common

from benchmark import tracing

MS = 1_000_000
NAME = "epilogue_ms_per_batch.offline"
CFG = {"decode": {"entry_length": 3}}  # 2 steps a batch
EVENTS = [
    ("void capdec::(anonymous namespace)::residual_layernorm"
     "<__nv_bfloat16, true, 3>(...)", 100 * MS, 101 * MS),
    ("ampere_bf16_s16816gemm_bf16_128x64", 101 * MS, 104 * MS),
    ("void capdec::(anonymous namespace)::bias_act<__nv_bfloat16, false>"
     "(...)", 104 * MS, 106 * MS),
    ("void capdec::(anonymous namespace)::residual_layernorm"
     "<__nv_bfloat16, false, 3>(...)", 106 * MS, 107 * MS),
    ("void capdec::(anonymous namespace)::bias_act<__nv_bfloat16, true>"
     "(...)", 107 * MS, 110 * MS),
    ("void at::native::vectorized_elementwise_kernel<4>", 110 * MS,
     120 * MS),
]


def _ctx(events, steps):
    spans = [("decode_step", (100 + 10 * i) * MS, (110 + 10 * i) * MS,
              None, i) for i in range(steps)]
    t = tracing.TraceSlice(events, spans, 100 * MS, 200 * MS)
    return types.SimpleNamespace(cfg=CFG, traffic={}, counters={}, trace=t)


def read(c):
    return common.metric_reader(NAME).read(c)


def test_epilogue_ms_per_batch():
    # 7 ms of the four epilogue kernels over 4 steps, 2 batches' worth
    assert abs(read(_ctx(EVENTS, 4)) - 3.5) < 1e-9


def test_nothing_to_read_reads_none():
    assert read(types.SimpleNamespace(cfg=CFG, traffic={}, counters={},
                                      trace=None)) is None
    assert read(_ctx(EVENTS, 0)) is None
    assert read(_ctx([e for e in EVENTS if "capdec" not in e[0]], 4)) is None


def test_entry_names_the_reader():
    bench = common.benchmark()
    m = common.by_name(bench["per_layer"], NAME, "metric")
    assert m["source"] == "device_trace" and m["moves"] == "captions_per_s"
    assert m["layer"] == "model" and m["unit"] == "ms"

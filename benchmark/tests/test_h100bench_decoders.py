"""A configuration's decoder is found by name (decoders/__init__.py).

The accepted configurations resolve to decoders/gpt2.py with the layout
and the matmul counts they had before decoders were looked up; and a
configuration naming another decoder, `toy` (a module the test registers,
binding GPT-2's functions under that key, so that its `model` object has
no `gpt2`), runs a serving cell through run.py's `execute` and passes its
checks, and the readers that need the decoder read it as they read
GPT-2's."""
from __future__ import annotations

import sys
import types

import pytest
import torch

from h100bench_helpers import (ROOT, TOY_DECODER, common, run_module,
                               tiny_config, tiny_traffic, toy_config)

from benchmark import decoders, tracing
from benchmark.decoders import gpt2 as gpt2_decoder
from benchmark.reference import model as ref_model

CPU = torch.device("cpu")
CONFIGS = {
    # tensors, parameters, matmul operations of a caption (beam 5, 67
    # tokens) and of a train step at batch 30 x 40 tokens
    "capdec-rn50x4-transformer-gpt2": (247, 181959936, 95563878912.0,
                                       2076569395200.0),
    "clipcap-vitb32-mlp-gpt2": (152, 155908608, 83901153792.0,
                                1053615513600.0),
}


def _model(name):
    return common.config_file(common.benchmark(), name)["model"]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_accepted_configurations_resolve_to_gpt2(name):
    m = _model(name)
    dec = decoders.of(m)
    assert dec is gpt2_decoder
    assert dec.__file__ == str(ROOT / "benchmark" / "decoders" / "gpt2.py")
    tensors, params, caption, train = CONFIGS[name]
    lay = dec.layout(m)
    assert lay == ref_model.layout(m)
    assert len(lay) == tensors
    assert sum(torch.Size(s).numel() for _, s, _ in lay) == params
    assert dec.caption_flops(m, 5, 67) == caption
    assert dec.train_step_flops(m, 30, 40) == train
    assert dec.lm_head_shape(m) == (768, 50257)
    assert dec.decode_attention_shape(m) == 768
    assert dec.hidden(m) == 768 and dec.vocab(m) == 50257
    assert [s[2] for s in dec.spans()] == ["prefill", "decode_step"]


def test_the_flagship_caption_is_95_gflop():
    m = _model("capdec-rn50x4-transformer-gpt2")
    assert 95e9 < decoders.of(m).caption_flops(m, 5, 67) < 96e9


def test_a_model_with_no_single_decoder_is_refused():
    with pytest.raises(ValueError):
        decoders.key({"mapper": {}, "gpt2": {}, "other": {}})
    with pytest.raises(ValueError):
        decoders.key({"mapper": {}})


def toy_decoder():
    mod = types.ModuleType("benchmark.decoders.toy")
    exec(TOY_DECODER, mod.__dict__)
    return mod


@pytest.fixture
def toy(monkeypatch):
    monkeypatch.setitem(sys.modules, "benchmark.decoders.toy", toy_decoder())


@pytest.mark.parametrize("cell", ["flagship-beam-offline",
                                  "clipcap-mlp-beam-offline"])
def test_a_second_decoder_serves_a_cell(cell, toy):
    cfg = toy_config(cell)
    assert "gpt2" not in cfg["model"]
    out = run_module().execute(cell, 2**31 + 57, 0.6, True, CPU,
                               cfg_override=cfg,
                               traffic_override=tiny_traffic(cell))
    assert out["correct"], out["checks"]
    assert out["checks"]["top_r_gap"]["value"] < 1e-4
    assert out["attempted"] >= tiny_traffic(cell)["batch_size"]


MS = 1_000_000


def _slice(steps=4):
    """A traced slice of `steps` decode steps, each with one K1 call and
    one K2 call a layer."""
    events, spans = [], []
    for s in range(steps):
        t = (10 + 10 * s) * MS
        spans.append(("decode_step", t, t + 9 * MS, 1, s + 1))
        events.append(("lm_head_wgmma<128>", t + MS, t + 2 * MS))
        events.append(("lm_head_merge", t + 2 * MS, t + 3 * MS))
        for layer in range(2):
            events.append(("async_attn<bf16>", t + (4 + layer) * MS,
                           t + (5 + layer) * MS))
    spans.append(("train_step", 10 * MS, 40 * MS, 1, None))
    return tracing.TraceSlice(events, spans, 0, 60 * MS)


@pytest.mark.parametrize("metric", ["lm_head_roofline",
                                    "decode_attention_roofline",
                                    "mfu.offline", "mfu.train"])
def test_readers_read_the_toy_as_gpt2(metric, toy):
    cell = "flagship-train-coco" if metric == "mfu.train" \
        else "flagship-beam-offline"
    rm = run_module()
    cfg = tiny_config(cell, "f32")
    traffic = dict(common.traffic_file(common.by_name(
        common.benchmark()["workloads"], cell, "workload")["traffic"]),
        **tiny_traffic(cell))
    reader = common.metric_reader(metric)
    got = [reader.read(rm.MetricContext(c, traffic, {}, _slice()))
           for c in (cfg, toy_config(cell))]
    assert got[0] is not None and got[0] > 0
    assert got[0] == got[1]


def test_a_decoder_without_k2_reads_no_k2_roofline(toy, monkeypatch):
    monkeypatch.setattr(sys.modules["benchmark.decoders.toy"],
                        "decode_attention_shape", None)
    cell = "flagship-beam-offline"
    ctx = run_module().MetricContext(toy_config(cell), tiny_traffic(cell),
                                     {}, _slice())
    assert common.metric_reader("decode_attention_roofline").read(ctx) is None

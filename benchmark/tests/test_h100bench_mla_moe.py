"""The Kimi-VL-A3B configuration's decoder (decoders/mla_moe.py), its
cell and its readers, on the CPU.

The configuration resolves to decoders/mla_moe.py at its published size
(15.96B decoder parameters, within 0.1 % of the model card's 16B-A3B
count); its matmul count a caption is frozen; a tiny version of the cell
serves through run.py's `execute` in f32 and passes its check tightly,
and comes out not correct with each of the readings tool's faults that
its limits catch planted (tools/readings_mla_moe.py), while those they
do not catch still move the check's numbers; the new readers read synthetic
slices and counters, and read None where there is nothing to read (a
GPT-2 cell)."""
from __future__ import annotations

import copy
import math
import types

import pytest
import torch

from h100bench_helpers import ROOT, common, run_module, tiny_traffic

from benchmark import decoders, tracing
from benchmark.decoders import mla_moe as dec
from benchmark.roofline import mla_attention, peaks

CELL = "kimi-vl-a3b-beam-offline"
CONFIG = "capdec-rn50x4-transformer-kimi-vl-a3b"
CPU = torch.device("cpu")
TINY_TEXT = dict(vocab_size=512, hidden_size=64, intermediate_size=96,
                 moe_intermediate_size=32, num_hidden_layers=3,
                 num_attention_heads=4, n_routed_experts=8,
                 num_experts_per_tok=2, n_shared_experts=1, kv_lora_rank=32,
                 qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
# the readings tool's faults the cell's limits catch, and those they do
# not, with the numbers each of these moves (PERF.md, PR 22): a routed
# expert's products skipped, and the lowest-ranked beam served
CAUGHT = ["fault_cache_unchanged", "fault_expert_shifted",
          "fault_rope_dropped", "fault_token", "fault_top5_routing"]
UNCAUGHT = {"fault_expert_skipped": ("top_r_gap",),
            "fault_worst_beam": ("beam_score_median",)}
# what the sound tiny run reads at most
SOUND = {"top_r_gap": 1e-4, "beam_score_median": 1e-5}


def _cfg():
    return common.config_file(common.benchmark(), CONFIG)


def test_the_file_holds_the_published_config_at_its_top_level():
    """The file states the published text_config key for key at its top
    level; `model.mla_moe`, which the decoder reads, is that same set."""
    cfg = _cfg()
    published = cfg["model"]["mla_moe"]
    assert {k: cfg.get(k, "absent") for k in published} == published
    assert (cfg["vocab_size"], cfg["hidden_size"], cfg["kv_lora_rank"],
            cfg["q_lora_rank"], cfg["rope_scaling"]) == (
        163840, 2048, 512, None, None)


def test_the_configuration_resolves_at_its_published_size():
    cfg = _cfg()
    m = cfg["model"]
    assert decoders.of(m) is dec
    assert dec.__file__ == str(ROOT / "benchmark" / "decoders" / "mla_moe.py")
    lay = dec.layout(m)
    assert len(lay) == 476
    decoder = sum(math.prod(s) for k, s, _ in lay if k.startswith("gpt."))
    assert abs(decoder / 15.96e9 - 1) < 1e-3
    assert sum(math.prod(s) for _, s, _ in lay) == 16281269376
    assert cfg["reduced"] == [] and cfg["weights_dtype"] == "bf16"
    c = m["mla_moe"]
    assert (c["num_hidden_layers"], c["n_routed_experts"],
            c["num_experts_per_tok"], c["n_shared_experts"],
            c["vocab_size"], c["ep_size"]) == (27, 64, 6, 2, 163840, 1)
    assert dec.lm_head_shape(m) == (2048, 163840)
    assert dec.decode_attention_shape is None
    assert [s[2] for s in dec.spans()] == ["prefill", "decode_step"]
    kinds = {kind for _, _, kind in lay}
    assert kinds - {"one", "zero", "linear", "linear_bias"} \
        <= set(cfg["weights"])


def test_the_caption_flops_are_frozen():
    m = _cfg()["model"]
    assert dec.caption_flops(m, 5, 67) == 1948865464320.0
    with pytest.raises(NotImplementedError):
        dec.train_step_flops(m, 30, 40)


def test_the_kernel_counts_at_the_cells_shape():
    assert mla_attention.flops(512, 5, 40, 66) == 9536798720.0
    assert mla_attention.nbytes(512, 5, 40, 66) == 310312960


def tiny_config():
    cfg = copy.deepcopy(_cfg())
    cfg["model"]["mla_moe"].update(TINY_TEXT)
    cfg["model"]["mapper"].update(prefix_size=32, prefix_length=4,
                                  clip_length=4, num_layers=2)
    cfg["decode"]["entry_length"] = 8
    cfg["serve_precision"] = "f32"
    cfg["weights_dtype"] = "f32"
    cfg["weights"].update(attn_in=0.15, kv_b=0.2, attn_out=0.15,
                          mlp_in=0.15, mlp_out=0.15, expert_in=0.15,
                          expert_out=0.15, router=0.3, head=0.15)
    return cfg


def test_the_cell_serves_a_tiny_model_through_execute():
    out = run_module().execute(CELL, 2**31 + 91, 0.6, True, CPU,
                               cfg_override=tiny_config(),
                               traffic_override=tiny_traffic(CELL))
    assert out["correct"], out["checks"]
    assert out["checks"]["top_r_gap"]["value"] < 1e-4
    assert abs(out["checks"]["beam_score_median"]["value"]) < 1e-5
    rows = out["info"]["counters"]["stats"]["expert_rows"]
    assert len(rows) == 2 and len(rows[0]) == 8
    assert out["metrics"]["expert_rows_max_over_mean.offline"]["value"] >= 1


MS = 1_000_000


def _slice():
    events, spans = [], []
    for s in range(3):
        t = (10 + 10 * s) * MS
        spans.append(("decode_step", t, t + 9 * MS, 1, s + 1))
        events.append(("mla_decode_attention", t + MS, t + 2 * MS))
        events.append(("lm_head_wgmma<48>", t + 3 * MS, t + 4 * MS))
    return tracing.TraceSlice(events, spans, 0, 60 * MS)


def _ctx(cfg, counters=None, trace=None):
    traffic = common.traffic_file("beam-offline-b512-kimi")
    return run_module().MetricContext(cfg, traffic, counters or {},
                                      trace or _slice())


def _faulty_run(fault, monkeypatch):
    """The tiny cell of test_the_cell_serves_a_tiny_model_through_execute
    with one of the readings tool's faults planted, against the cell's own
    limits."""
    from benchmark.tools import readings_mla_moe
    owner, attr, value = readings_mla_moe.faults(
        TINY_TEXT["vocab_size"])[fault]
    monkeypatch.setattr(owner, attr, value)
    return run_module().execute(CELL, 2**31 + 91, 0.6, False, CPU,
                                cfg_override=tiny_config(),
                                traffic_override=tiny_traffic(CELL))


@pytest.mark.parametrize("fault", CAUGHT)
def test_a_planted_fault_is_caught(fault, monkeypatch):
    out = _faulty_run(fault, monkeypatch)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", sorted(UNCAUGHT))
def test_an_uncaught_fault_still_moves_the_checks_numbers(fault,
                                                          monkeypatch):
    """The sound tiny run reads top_r_gap under 1e-4 and beam_score_median
    under 1e-5 (test_the_cell_serves_a_tiny_model_through_execute); these
    faults read a hundred times that at least, though under the limits,
    which bf16's routing flips set at the full size."""
    checks = _faulty_run(fault, monkeypatch)["checks"]
    moved = {n: checks[n]["value"] for n in UNCAUGHT[fault]}
    assert all(abs(v) > 100 * SOUND[n] for n, v in moved.items()), moved


def test_k16_roofline_reads_each_call_at_its_step():
    cfg = _cfg()
    got = common.metric_reader("mla_attention_roofline").read(_ctx(cfg))
    want = sum(peaks.bound_s(mla_attention.flops(512, 5, 40, s),
                             mla_attention.nbytes(512, 5, 40, s))
               for s in (1, 2, 3)) / 3e-3 * 100
    assert got == pytest.approx(want)
    gpt2 = common.config_file(common.benchmark(),
                              "capdec-rn50x4-transformer-gpt2")
    assert common.metric_reader("mla_attention_roofline").read(
        _ctx(gpt2)) is None


def test_expert_rows_reads_the_busiest_over_the_mean():
    ctx = _ctx(_cfg(), {"stats": {"expert_rows": [[1, 1, 1, 5],
                                                  [2, 2, 2, 2]]}})
    got = common.metric_reader("expert_rows_max_over_mean.offline").read(ctx)
    assert got == pytest.approx((5 / 2 + 1) / 2)


def test_the_readings_tool_plants_this_decoders_faults(monkeypatch):
    from benchmark.tools import readings, readings_mla_moe
    # as its main runs: readings.py's serving readings take this table
    monkeypatch.setattr(readings, "serve_faults", readings_mla_moe.faults)
    table = readings.serve_faults(163840)
    assert sorted(table) == sorted(CAUGHT + list(UNCAUGHT))
    for owner, attr, value in table.values():
        assert isinstance(owner, types.ModuleType) and callable(value)
        assert callable(getattr(owner, attr))


def test_the_mix_and_cell():
    bench = common.benchmark()
    wl = common.by_name(bench["workloads"], CELL, "workload")
    assert (wl["config"], wl["traffic"], wl["chips"]) == \
        (CONFIG, "beam-offline-b512-kimi", 1)
    tr = common.traffic_file(wl["traffic"])
    assert tr["driver"] == "serve_offline" and tr["batch_size"] == 512
    assert tr["check_requests"] <= 96
    for name in ("captions_per_s",):
        m = common.by_name(bench["end_to_end"], name, "metric")
        assert CELL in m["workloads"]
    # GPT-2's kernels, and the program-span metrics whose cells
    # test_h100bench_program_spans.py holds
    left_off = ("decode_attention_roofline", "epilogue_ms_per_batch.offline",
                "host_issue_ms_per_step.offline",
                "idle_at_batch_start_ms_per_batch.offline",
                "idle_in_detokenize_ms_per_batch.offline")
    for m in bench["per_layer"]:
        assert (CELL in m.get("workloads", [CELL])) == \
            (m["name"] not in left_off and not m["name"].endswith(".train")
             and m["name"] != "dp_sum_ms_per_step.train"), m["name"]

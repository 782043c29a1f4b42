"""Tiny versions of the benchmark's cells for the CPU tests."""
from __future__ import annotations

import copy
import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import common  # noqa: E402

# GPT-2's head size (64) kept, so that attention is as peaked as at full
# width once the block weights are scaled by sqrt(768 / n_embd)
TINY_GPT2 = dict(n_embd=128, n_layer=2, n_head=2, vocab_size=512,
                 n_positions=128)


def run_module(root: Path = ROOT):
    """benchmark/run.py of `root`, imported (it is a script)."""
    spec = importlib.util.spec_from_file_location(
        "bench_run_" + str(abs(hash(str(root)))), root / "benchmark" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiny_config(workload: str, precision: str = "bf16") -> dict:
    bench = common.benchmark()
    wl = common.by_name(bench["workloads"], workload, "workload")
    cfg = copy.deepcopy(common.config_file(bench, wl["config"]))
    cfg["model"]["gpt2"].update(TINY_GPT2)
    m = cfg["model"]["mapper"]
    m.update(prefix_size=32, prefix_length=4, clip_length=4)
    if m["type"] == "transformer":
        m.update(num_layers=2)  # the program fixes 8 heads and mlp_ratio 2
    cfg["decode"]["entry_length"] = 8
    w, scale = cfg["weights"], (768 / TINY_GPT2["n_embd"]) ** 0.5
    w["gpt_in"] *= scale
    w["gpt_out"] *= scale
    cfg["serve_precision"] = cfg["train_precision"] = precision
    return cfg


TINY_SERVE = {"batch_size": 8, "max_queue": 16, "check_requests": 16,
              "trace_after_s": 0.2, "trace_s": 0.3}
TINY_TRAIN = {"batch_size": 4, "tokens": 8, "caption_tokens": [2, 6],
              "trace_after_s": 0.2, "trace_steps": 3}


def tiny_traffic(workload: str) -> dict:
    return TINY_TRAIN if "train" in workload else TINY_SERVE

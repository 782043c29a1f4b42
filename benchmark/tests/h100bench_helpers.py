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


# A decoder file that binds GPT-2's functions under the key `toy`: a
# configuration whose `model` holds `toy` and `mapper` (and no `gpt2`)
# runs through it as a GPT-2 one does.
TOY_DECODER = '''"""GPT-2's bindings under the key `toy` (a test's decoder)."""
from benchmark.decoders import gpt2 as _g

Precision, load_model, spans = _g.Precision, _g.load_model, _g.spans


def _m(m):
    return {"gpt2": m["toy"], "mapper": m["mapper"]}


def layout(m):
    return _g.layout(_m(m))


def hidden(m):
    return _g.hidden(_m(m))


def vocab(m):
    return _g.vocab(_m(m))


def lm_head_shape(m):
    return _g.lm_head_shape(_m(m))


def decode_attention_shape(m):
    return _g.decode_attention_shape(_m(m))


def caption_flops(m, *a):
    return _g.caption_flops(_m(m), *a)


def train_step_flops(m, *a):
    return _g.train_step_flops(_m(m), *a)


def model_config(m, *a, **k):
    return _g.model_config(_m(m), *a, **k)


def caption_logits(sd, m, *a, **k):
    return _g.caption_logits(sd, _m(m), *a, **k)


def beam_search(sd, m, *a, **k):
    return _g.beam_search(sd, _m(m), *a, **k)
'''


def toy_config(workload: str, precision: str = "f32") -> dict:
    """tiny_config with its decoder under the key `toy`."""
    cfg = tiny_config(workload, precision)
    cfg["model"] = {"toy": cfg["model"]["gpt2"],
                    "mapper": cfg["model"]["mapper"]}
    return cfg

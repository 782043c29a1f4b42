"""A new cell, mix and per-layer metric are new files and new entries:
in a copy of the benchmark, a dummy mix (data only, for an existing
driver), a dummy metric (a reader of its own) and a cell naming them run
through run.py's dispatch with no edit to any file already there."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from h100bench_helpers import ROOT, tiny_config, TINY_SERVE

CHILD = r"""
import importlib.util, json, sys
import torch
root = sys.argv[1]
spec = importlib.util.spec_from_file_location("r", root + "/benchmark/run.py")
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)
assert run.ROOT.as_posix() == root
out = run.execute("dummy-cell", 2**31 + 77, 0.8, True, torch.device("cpu"),
                  cfg_override=json.loads(sys.argv[2]))
import benchmark
assert benchmark.__file__.startswith(root), benchmark.__file__
print(json.dumps({"metrics": out["metrics"], "correct": out["correct"]}))
"""


def test_new_cell_mix_and_metric_by_files_alone(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    b = tmp_path / "benchmark"
    (b / "traffic" / "dummy-mix.json").write_text(json.dumps(
        dict(json.loads((b / "traffic" / "beam-offline-b512.json").read_text()),
             **TINY_SERVE)))
    (b / "layer_metrics" / "dummy_metric.py").write_text(
        "def read(ctx):\n"
        "    return float(ctx.counters['batches_in_window'])\n")
    (b / "limits" / "dummy-cell.json").write_text(
        (b / "limits" / "flagship-beam-offline.json").read_text())
    bench["workloads"].append({"name": "dummy-cell",
                               "config": "capdec-rn50x4-transformer-gpt2",
                               "traffic": "dummy-mix", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "dummy_metric", "unit": "batches",
                               "better": "higher", "source": "host_clock",
                               "layer": "serve", "moves": "captions_per_s",
                               "workloads": ["dummy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    cfg = tiny_config("flagship-beam-offline", "f32")
    r = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path),
                        json.dumps(cfg)], capture_output=True, text=True,
                       env=env, cwd=tmp_path, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["metrics"]["dummy_metric"]["value"] >= 1
    assert got["correct"]
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data, rel

"""A run with its timed path broken underneath must come out not correct.

Each test skips the harness's look for a card and drives the rest of a
run (run.py's `execute`, on the CPU at a tiny size, the program in
float32) with one fault planted in the program, against the cell's own
limits; the sound run beside them comes out correct. The faults are
those the limits were read against (benchmark/tools/readings.py); a
training fault marked `_window` touches the window's steps alone."""
from __future__ import annotations

import importlib.util

import pytest
import torch

from h100bench_helpers import (ROOT, common, run_module, tiny_config,
                               tiny_traffic)

CPU = torch.device("cpu")
SEED = 2**31 + 101
SERVE = ["flagship-beam-offline", "clipcap-mlp-beam-offline"]
TRAIN = "flagship-train-coco"


def readings():
    spec = importlib.util.spec_from_file_location(
        "bench_readings", ROOT / "benchmark" / "tools" / "readings.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def execute(cell, seconds=0.6, **traffic):
    return run_module().execute(
        cell, SEED, seconds, False, CPU,
        cfg_override=tiny_config(cell, "f32"),
        traffic_override=dict(tiny_traffic(cell), **traffic))


# a learning rate that moves the tiny model's weights within a few steps
TRAIN_LR = dict(lr=1e-3, warmup_steps=2)


@pytest.mark.parametrize("cell", SERVE + [TRAIN])
def test_sound_run_is_correct(cell):
    out = execute(cell, **(TRAIN_LR if cell == TRAIN else {}))
    assert out["correct"], out["checks"]


def failed(out):
    return [n for n, c in out["checks"].items() if c["value"] > c["limit"]]


@pytest.mark.parametrize("fault", ["fault_token", "fault_cache_unchanged",
                                   "fault_greedy", "fault_worst_beam"])
@pytest.mark.parametrize("cell", SERVE)
def test_serve_fault_is_caught(cell, fault, monkeypatch):
    V = tiny_config(cell)["model"]["gpt2"]["vocab_size"]
    owner, attr, value = readings().serve_faults(V)[fault]
    monkeypatch.setattr(owner, attr, value)
    out = execute(cell)
    assert not out["correct"]
    assert failed(out)


@pytest.mark.parametrize("fault", ["fault_half_batch",
                                   "fault_half_batch_window",
                                   "fault_state_unchanged_window",
                                   "fault_stale_batch_window"])
def test_train_fault_is_caught(fault, monkeypatch):
    check_steps = common.traffic_file("train-coco-b30")["check_steps"]
    owner, attr, value = readings().train_faults(check_steps)[fault]
    monkeypatch.setattr(owner, attr, value)
    out = execute(TRAIN, 0.4, **TRAIN_LR)
    assert not out["correct"]
    if fault.endswith("_window"):
        # the first steps were sound: the window's step is what fails
        assert all(n.startswith("window_") for n in failed(out)), failed(out)

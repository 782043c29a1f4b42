"""drivers/train_dp.py on the CPU: two gloo ranks (the test's process as
rank 0 and one child) at a tiny size through run.py's `execute`, the
program in float32. A sound run is correct, its ranks bit-equal, and no
child outlives it; with a fault planted it is not correct: rank 0's dp
sums left out (its gradients its own rows' alone) fail `ranks_apart` and
the gradient gaps, half of every rank's batch left out and the window's
step leaving every rank's state unchanged fail the gaps. An exception on
rank 0, and a kill of it, end the children too."""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from h100bench_helpers import (ROOT, common, run_module, tiny_config,
                               TINY_TRAIN)

from benchmark.drivers import train_dp
from benchmark.tools import readings

CPU = torch.device("cpu")
CELL = "flagship-train-dp4"
SEED = 2**31 + 303
# two ranks, and a learning rate that moves the tiny model within a few
# steps
TRAFFIC = dict(TINY_TRAIN, dp=2, lr=1e-3, warmup_steps=2)


@pytest.fixture
def spawned(monkeypatch):
    """The child processes the driver starts."""
    procs = []
    spawn = train_dp._spawn

    def record(*a):
        procs.extend(spawn(*a))
        return procs
    monkeypatch.setattr(train_dp, "_spawn", record)
    return procs


def execute(seconds=0.5):
    return run_module().execute(
        CELL, SEED, seconds, False, CPU,
        cfg_override=tiny_config(CELL, "f32"), traffic_override=TRAFFIC)


def failed(out):
    return [n for n, c in out["checks"].items() if c["value"] > c["limit"]]


def test_sound_run_is_correct_and_ends_its_children(spawned):
    out = execute()
    assert out["correct"], out["checks"]
    assert out["checks"]["ranks_apart"]["value"] == 0
    assert out["device"]["count"] == 2
    assert out["attempted"] >= 1
    # the rate counts the global batch: both ranks' rows
    steps, window = out["info"]["counters"]["steps_in_window"], \
        out["info"]["window_s"]
    assert out["info"]["counters"]["samples_per_s"] == pytest.approx(
        steps * 2 * TINY_TRAIN["batch_size"] / window)
    assert set(out["metrics"]) == {"setup_s", "train_peak_memory_gb"}
    assert len(spawned) == 1
    assert all(p.poll() == 0 for p in spawned)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("fault,every_rank,fails", [
    ("fault_dp_sum_skipped", False, {"ranks_apart", "grad_norm_gap"}),
    ("fault_half_batch", True, {"grad_norm_gap"}),
    ("fault_state_unchanged_window", True, {"window_change_gap"}),
])
def test_fault_is_caught(fault, every_rank, fails, spawned):
    steps = common.traffic_file("train-coco-dp4-b30")["check_steps"]
    out = readings.planted(fault, every_rank, steps, execute)
    assert not out["correct"]
    assert fails <= set(failed(out)), out["checks"]
    assert all(p.poll() == 0 for p in spawned)


def test_an_exception_on_rank_0_ends_the_children(spawned, monkeypatch):
    def broken(run, state):
        raise RuntimeError("planted")
    monkeypatch.setattr(train_dp, "ranks_apart", broken)
    with pytest.raises(RuntimeError, match="planted"):
        execute()
    assert len(spawned) == 1
    assert all(p.poll() is not None for p in spawned)
    assert not torch.distributed.is_initialized()


RANK0 = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1] + "/benchmark/tests")
from h100bench_helpers import run_module
run_module().execute("flagship-train-dp4", 2**31 + 5, 600.0, False,
                     torch.device("cpu"), cfg_override=json.loads(sys.argv[2]),
                     traffic_override=json.loads(sys.argv[3]))
"""


def _children(pid):
    out = set()
    for task in Path(f"/proc/{pid}/task").glob("*"):
        try:
            out |= {int(c) for c in (task / "children").read_text().split()}
        except OSError:
            pass
    return out


def test_a_kill_of_rank_0_ends_the_children(tmp_path):
    rank0 = subprocess.Popen(
        [sys.executable, "-c", RANK0, str(ROOT),
         json.dumps(tiny_config(CELL, "f32")), json.dumps(TRAFFIC)],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 120
        kids = set()
        while not kids and time.monotonic() < deadline:
            time.sleep(0.5)
            kids = _children(rank0.pid)
        assert kids, "rank 0 started no child"
        time.sleep(8)                  # the child is past its imports
        rank0.kill()
        rank0.wait(timeout=30)
        deadline = time.monotonic() + 30
        while any(Path(f"/proc/{k}").exists() for k in kids) \
                and time.monotonic() < deadline:
            time.sleep(0.2)
        # a child killed and not yet reaped by its new parent is a zombie
        alive = [k for k in kids if Path(f"/proc/{k}/status").exists()
                 and "zombie" not in Path(f"/proc/{k}/status").read_text()]
        assert not alive
    finally:
        if rank0.poll() is None:
            rank0.kill()
            rank0.wait()

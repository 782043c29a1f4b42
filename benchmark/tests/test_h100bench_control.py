"""The control, on the card at each cell's own size: the reference put in
the program's place in the precision below the configuration's (fp8 for
bf16) must come out not correct by the check a run makes, while the
program on the same seed comes out correct. Marked `cuda`: it skips
without a card.

    python -m pytest benchmark/tests/test_h100bench_control.py -q
"""
from __future__ import annotations

import importlib.util

import pytest
import torch

from h100bench_helpers import ROOT, common, run_module

CELLS = [w["name"] for w in common.benchmark()["workloads"]]
SEED = 2**31 + 4242


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell, cuda):
    spec = importlib.util.spec_from_file_location(
        "bench_readings", ROOT / "benchmark" / "tools" / "readings.py")
    readings = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(readings)
    from benchmark import tracing
    rm = run_module()
    bench = common.benchmark()
    wl = common.by_name(bench["workloads"], cell, "workload")
    traffic = common.traffic_file(wl["traffic"])
    run = rm.Run(cell, common.config_file(bench, wl["config"]), traffic, SEED,
                 4.0, False, cuda, tracing.Spans())
    drv = common.driver(traffic["driver"])
    limits = common.limits_file(cell)
    compared = [n for n in limits if "limit" in limits[n]]

    def over(r):
        return [n for n in compared if r[n] > limits[n]["limit"]]
    if traffic["driver"] == "train":
        rec = readings.train_readings(run, drv, limits, faults=False)
    else:
        rec = readings.serve_readings(run, drv, limits, faults=False)
    assert not over(rec["program"]), rec["program"]
    assert over(rec["control"]), rec["control"]

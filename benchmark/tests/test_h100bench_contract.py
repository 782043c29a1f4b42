"""BENCHMARK.json against the benchmark's contract, and the files each of
its names points to."""
from __future__ import annotations

import re

import pytest

from h100bench_helpers import ROOT, common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = common.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
            assert "\t" not in entry[key]


def test_unique_names():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_configs_and_files():
    """Each configuration is used, and its file names a decoder module
    that builds its layout."""
    from benchmark import decoders
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        f = common.load_json(ROOT / c["file"])
        assert f["reduced"] == c["reduced"]
        dec = decoders.of(f["model"])
        assert (ROOT / "benchmark" / "decoders"
                / f"{decoders.key(f['model'])}.py").exists()
        keys = [k for k, _, _ in dec.layout(f["model"])]
        assert keys and len(keys) == len(set(keys))
        assert dec.hidden(f["model"]) > 0 and dec.vocab(f["model"]) > 0


def test_four_chip_cells():
    """A cell takes 1 or 4 chips, and at most a quarter of the cells
    (rounded down), or one, take 4."""
    chips = [w["chips"] for w in BENCH["workloads"]]
    assert set(chips) <= {1, 4}
    assert chips.count(4) <= max(1, len(chips) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports(cell):
    """Every cell reports setup_s, another end-to-end metric and a
    per-layer one, and each per-layer metric's cells report what it
    moves."""
    wl = common.by_name(BENCH["workloads"], cell, "workload")
    assert set(wl) == {"name", "config", "traffic", "chips", "why"}
    assert wl["chips"] in (1, 4)
    e2e = {m["name"] for m in common.metrics_of_cell(BENCH["end_to_end"], cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = common.metrics_of_cell(BENCH["per_layer"], cell)
    assert layer
    for m in layer:
        assert m["moves"] in e2e
    assert (ROOT / "benchmark" / "traffic" / f"{wl['traffic']}.json").exists()
    assert (ROOT / "benchmark" / "limits" / f"{cell}.json").exists()
    drv = common.traffic_file(wl["traffic"])["driver"]
    assert (ROOT / "benchmark" / "drivers" / f"{drv}.py").exists()


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_readers(metric):
    assert callable(common.metric_reader(metric["name"]).read)
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_run_seconds_fits_a_full_check():
    cells = 24
    total = (2 + 14 * cells) * (BENCH["run_seconds"] + 60) \
        + cells * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_limits_lie_between_their_readings(cell):
    """Each compared number's limit lies above the program's largest
    reading and below the least reading that sets its upper end; an
    exact comparison's limit is 0, as its lower reading must be."""
    limits = common.limits_file(cell)
    compared = {n: v for n, v in limits.items()
                if isinstance(v, dict) and "limit" in v}
    assert compared
    for name, v in compared.items():
        assert v["lower"] == max(v["program"] + v.get("program_48_requests", [])
                                 + v.get("program_runs", [])), name
        if v.get("exact"):
            assert v["lower"] == v["limit"] == 0 < v["upper"], name
        else:
            assert v["lower"] < v["limit"] < v["upper"], name

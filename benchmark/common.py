"""What every part of the benchmark shares: where its files are, how a
named configuration, traffic mix, limit file or per-layer metric is found,
and how a run's result is printed.

Each piece is found by the name `BENCHMARK.json` gives it, so a new cell,
configuration, mix or metric is a new file and a new entry:

  configs/<file of the configuration entry>   sizes, precision, weights
  traffic/<traffic>.json                      parameters of one mix; its
                                              `driver` names the general
                                              generator drivers/<driver>.py
  layer_metrics/<metric>.py                   read(ctx) -> float or None
  limits/<workload>.json                      the limit of each number
                                              compared, with its readings
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK_JSON = ROOT / "BENCHMARK.json"

# Top-level module names that may not be loaded in a run (compared whole:
# the port's own name begins with the JAX package's).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "capdec_tpu")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark(path: Path = BENCHMARK_JSON) -> Dict[str, Any]:
    return load_json(path)


def by_name(entries: Iterable[Dict[str, Any]], name: str, what: str
            ) -> Dict[str, Any]:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def config_file(bench: Dict[str, Any], config_name: str) -> Dict[str, Any]:
    entry = by_name(bench["configs"], config_name, "configuration")
    return load_json(ROOT / entry["file"])


def traffic_file(name: str) -> Dict[str, Any]:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits_file(workload: str) -> Dict[str, Any]:
    return load_json(HERE / "limits" / f"{workload}.json")


def load_module(path: Path, name: Optional[str] = None):
    """Import a file of the benchmark by its path (file names may hold
    dots, so they are not package imports)."""
    name = name or "_bench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    """drivers/<name>.py, the general generator a mix names."""
    return importlib.import_module(f"benchmark.drivers.{name}")


def metric_reader(name: str):
    return load_module(HERE / "layer_metrics" / f"{name}.py")


def metrics_of_cell(metrics: List[Dict[str, Any]], workload: str
                    ) -> List[Dict[str, Any]]:
    """The metrics of `metrics` that the cell reports: those listing it
    under `workloads`, and those with no such list."""
    return [m for m in metrics
            if "workloads" not in m or workload in m["workloads"]]


def forbidden_loaded() -> List[str]:
    """Forbidden top-level modules present in sys.modules."""
    return sorted({n.split(".")[0] for n in sys.modules}
                  & set(FORBIDDEN_MODULES))


def checks_line(checks: Dict[str, Dict[str, float]]) -> str:
    """One line per compared number: name, value, limit, verdict."""
    out = []
    for name, c in checks.items():
        ok = c["value"] <= c["limit"]
        out.append(f"check {name}: {c['value']!r} limit {c['limit']!r} "
                   f"{'ok' if ok else 'FAIL'}")
    return "\n".join(out)


def device_info(device, count: int = 1) -> Dict[str, Any]:
    """The result's `device` object; the peak is the allocator's."""
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}

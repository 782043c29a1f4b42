"""Run one cell of the benchmark of `capdec_tpu_torch` on this machine's
card(s) and print its result as the last line of standard output.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic mix and its metrics are found by
name from `BENCHMARK.json` (see common.py). With `--trace 0` the result
holds the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics, read from a profiled slice of the window. Every run checks what
its window produced against the plain reference once the window has
closed, and prints each number compared beside its limit, on standard
error and under `checks`, the last key of the result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Caches of compiled kernels stay in the checkout, at fixed paths.
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / ".bench_cache" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".bench_cache" / "triton"))
os.environ.setdefault("USE_FLAX", "0")
# One process with few threads: no host thread pools beside the program's.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")


@dataclasses.dataclass
class Run:
    workload: str
    cfg: Dict[str, Any]
    traffic: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: Any
    spans: Any


@dataclasses.dataclass
class MetricContext:
    """What a per-layer metric's reader may read."""
    cfg: Dict[str, Any]
    traffic: Dict[str, Any]
    counters: Dict[str, Any]
    trace: Any                  # tracing.TraceSlice or None


def execute(workload: str, seed: int, seconds: float, trace: bool, device,
            bench: Optional[Dict[str, Any]] = None,
            cfg_override: Optional[Dict[str, Any]] = None,
            traffic_override: Optional[Dict[str, Any]] = None
            ) -> Dict[str, Any]:
    """Run one cell; return the result object (without printing). The
    overrides let the CPU tests run a cell at a tiny size."""
    import torch

    from benchmark import common, tracing
    bench = bench or common.benchmark()
    wl = common.by_name(bench["workloads"], workload, "workload")
    cfg = cfg_override or common.config_file(bench, wl["config"])
    traffic = dict(common.traffic_file(wl["traffic"]), **(traffic_override or {}))
    limits = common.limits_file(workload)
    run = Run(workload, cfg, traffic, int(seed), float(seconds), bool(trace),
              device, tracing.Spans())
    drv = common.driver(traffic["driver"])
    res = drv.run(run)
    setup_s = res["setup_end"] - T_START
    bad = common.forbidden_loaded()
    if bad:
        raise SystemExit(f"forbidden modules loaded: {', '.join(bad)}")
    checked = res["check"](run, res, limits)
    checks = checked.pop("checks")
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics: Dict[str, Dict[str, Any]] = {}
    slice_ = res.get("trace")
    if not trace:
        for m in common.metrics_of_cell(bench["end_to_end"], workload):
            v = setup_s if m["name"] == "setup_s" else res["e2e"][m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        ctx = MetricContext(cfg, traffic, res["counters"], slice_)
        for m in common.metrics_of_cell(bench["per_layer"], workload):
            v = common.metric_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = dict(res["device"])
    out: Dict[str, Any] = {"correct": correct, "attempted": res["attempted"],
                           "failed": res["missing"], "metrics": metrics,
                           "device": dev}
    if trace and slice_ is not None:
        dev["busy_s"] = slice_.busy_s
        dev["window_s"] = slice_.window_s
        out["breakdown"] = {"device_ops": slice_.top_ops(10),
                            "idle_gaps": slice_.idle_gaps(10)}
    out["info"] = {"setup_s": setup_s, "window_s": res["window_s"],
                   "e2e": res["e2e"], "counters": res["counters"],
                   "check": checked}
    out["checks"] = checks
    bad = common.forbidden_loaded()
    if bad:
        raise SystemExit(f"forbidden modules loaded: {', '.join(bad)}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import common
    bench = common.benchmark()
    wl = common.by_name(bench["workloads"], args.workload, "workload")
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"needs {wl['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda", 0), bench)
    print(json.dumps(out["info"], default=float), file=sys.stderr)
    print(common.checks_line(out["checks"]), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

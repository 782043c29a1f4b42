"""torch.profiler integration (port of capdec_tpu/utils/profiling.py).

A context manager wraps any region in a torch.profiler trace, written as
a Chrome trace (Perfetto / chrome://tracing read it), and a helper sums
the per-op durations of the newest trace: the counterpart of the JAX
package's jax.profiler trace and its summary. On the card the trace holds
the CUDA kernels beside the host ops.
"""
from __future__ import annotations

import contextlib
import glob
import json
import os
import time
from collections import Counter
from typing import Dict

import torch

TRACE_SUFFIX = ".trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (host ops, and CUDA kernels when a card is
    there) and write `capdec-<ns>.trace.json` into log_dir."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(
        log_dir, f"capdec-{time.time_ns()}{TRACE_SUFFIX}"))


def summarize_trace(log_dir: str, top: int = 25) -> Dict[str, float]:
    """Durations (ms) of the newest trace's complete events ("ph": "X"),
    summed by name, the `top` largest first."""
    paths = sorted(glob.glob(os.path.join(log_dir, f"*{TRACE_SUFFIX}")),
                   key=os.path.getmtime)
    if not paths:
        return {}
    with open(paths[-1]) as f:
        data = json.load(f)
    by_name: Counter = Counter()
    for e in data.get("traceEvents", []):
        if e.get("ph") == "X":
            by_name[e.get("name", "?")] += e.get("dur", 0)
    return {name: dur / 1000.0 for name, dur in by_name.most_common(top)}


def print_trace_summary(log_dir: str, top: int = 25) -> None:
    for name, ms in summarize_trace(log_dir, top).items():
        print(f"{ms:10.2f} ms  {name[:80]}", flush=True)

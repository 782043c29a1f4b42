"""Throughput and latency meters (replaces the reference CUDA-event Timer,
predictions_runner.py:125-151) plus structured metric logging.

The port's own copy of capdec_tpu/utils/meter.py."""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional


class Timer:
    """Wall-clock interval accumulator; pass a sync callable (such as
    `torch.cuda.synchronize`) for honest device timings."""

    def __init__(self, sync=None):
        self.timings: List[float] = []
        self._sync = sync
        self._t0 = 0.0

    def __enter__(self):
        if self._sync:
            self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync:
            self._sync()
        self.timings.append((time.perf_counter() - self._t0) * 1000.0)

    @property
    def mean_ms(self) -> float:
        return sum(self.timings) / max(1, len(self.timings))

    @property
    def std_ms(self) -> float:
        m = self.mean_ms
        return (sum((t - m) ** 2 for t in self.timings)
                / max(1, len(self.timings))) ** 0.5

    def __str__(self):
        return f"mean: {self.mean_ms:.2f} ms, std: {self.std_ms:.2f} ms"


class ThroughputMeter:
    """Steps/sec, samples/sec, tokens/sec over a sliding window."""

    def __init__(self, window: int = 50):
        self.window = window
        self._events: List[tuple] = []  # (t, samples, tokens)

    def update(self, samples: int, tokens: int = 0):
        self._events.append((time.perf_counter(), samples, tokens))
        if len(self._events) > self.window:
            self._events.pop(0)

    def rates(self) -> Dict[str, float]:
        if len(self._events) < 2:
            return {"steps_per_sec": 0.0, "samples_per_sec": 0.0,
                    "tokens_per_sec": 0.0}
        dt = self._events[-1][0] - self._events[0][0]
        n = len(self._events) - 1
        if dt <= 0:
            return {"steps_per_sec": 0.0, "samples_per_sec": 0.0,
                    "tokens_per_sec": 0.0}
        samples = sum(e[1] for e in self._events[1:])
        tokens = sum(e[2] for e in self._events[1:])
        return {"steps_per_sec": n / dt, "samples_per_sec": samples / dt,
                "tokens_per_sec": tokens / dt}


class MetricsLogger:
    """Append-only JSONL metrics with stdout echo every `print_every`."""

    def __init__(self, path: Optional[str] = None, print_every: int = 100):
        self.path = path
        self.print_every = print_every
        self._count = 0
        self._fh = open(path, "a") if path else None

    def log(self, **metrics):
        self._count += 1
        if self._fh:
            self._fh.write(json.dumps(metrics) + "\n")
            if self._count % 1000 == 0:
                self._fh.flush()
        if self._count % self.print_every == 0:
            parts = ", ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                              for k, v in metrics.items())
            print(parts, flush=True)

    def close(self):
        if self._fh:
            self._fh.close()

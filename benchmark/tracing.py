"""The traced slice of a `--trace 1` run, and the spans the benchmark
records around its calls into the program's layers.

A traced run profiles a short steady slice inside its window with
`torch.profiler` (device activity only), keeps the events in memory and
writes no trace file. Around the calls into each layer the benchmark
records spans of its own (name, host start and end, thread, and the
decode step where there is one): it wraps the program's functions for the
length of the run, and records only while the slice is open. The
profiler stamps device events on the host's realtime clock
(`time.time_ns`), which the spans use too, so each kernel can be set
beside what the host was doing.

Because the beam loop reads a flag back from the device at every step, a
step's kernels run before the next step begins on the host; so a kernel
belongs to the last decode-step span that began before the kernel did.
"""
from __future__ import annotations

import bisect
import functools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .roofline.families import family

NOT_KERNELS = ("Memcpy", "Memset")


class Spans:
    """Spans recorded by wrappers around program functions."""

    def __init__(self):
        self.active = False
        self.records: List[Tuple[str, int, int, int, Any]] = []
        self._patches: List[Tuple[Any, str, Any]] = []
        self._lock = threading.Lock()

    def wrap(self, owner, attr: str, name: str,
             meta: Optional[Callable] = None) -> None:
        """Record a span `name` around every call of owner.attr."""
        fn = getattr(owner, attr)
        spans = self

        @functools.wraps(fn)   # keeps attributes such as launch counters
        def wrapped(*args, **kwargs):
            if not spans.active:
                return fn(*args, **kwargs)
            t0 = time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                rec = (name, t0, time.time_ns(), threading.get_native_id(),
                       meta(*args, **kwargs) if meta else None)
                with spans._lock:
                    spans.records.append(rec)

        self._patches.append((owner, attr, fn))
        setattr(owner, attr, wrapped)

    def mark(self, name: str, t0: int, t1: int, meta=None) -> None:
        if self.active:
            with self._lock:
                self.records.append((name, t0, t1, threading.get_native_id(),
                                     meta))

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._patches):
            setattr(owner, attr, fn)
        self._patches.clear()


class Slice:
    """Starts and stops the profiler around the traced slice."""

    def __init__(self, spans: Spans, device: torch.device):
        self.spans = spans
        self.device = device
        self.prof = None
        self.t0_ns = self.t1_ns = 0
        self.events = None

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CUDA] \
            if self.device.type == "cuda" \
            else [torch.profiler.ProfilerActivity.CPU]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.t0_ns = time.time_ns()
        self.spans.active = True

    def stop(self) -> None:
        self.spans.active = False
        self.t1_ns = time.time_ns()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        self.events = self.prof.profiler.kineto_results.events()

    def result(self) -> "TraceSlice":
        dev = []
        index = self.device.index or 0
        for e in self.events or ():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            if e.device_index() != index:
                continue
            dev.append((e.name(), e.start_ns(), e.end_ns()))
        return TraceSlice(dev, self.spans.records, self.t0_ns, self.t1_ns)


class TraceSlice:
    """Device events and spans of one traced slice, clipped to it."""

    def __init__(self, device_events: Sequence[Tuple[str, int, int]],
                 spans: Sequence[Tuple[str, int, int, int, Any]],
                 t0_ns: int, t1_ns: int):
        self.t0, self.t1 = t0_ns, t1_ns
        ev = [(n, max(s, t0_ns), min(e, t1_ns)) for n, s, e in device_events
              if e > t0_ns and s < t1_ns]
        ev.sort(key=lambda x: x[1])
        self.events = ev
        self.kernels = [x for x in ev if not x[0].startswith(NOT_KERNELS)]
        self.spans = sorted(spans, key=lambda x: x[1])

    # -- the slice -------------------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def _union(self) -> List[Tuple[int, int]]:
        out: List[List[int]] = []
        for _, s, e in self.events:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._union()) / 1e9

    @property
    def has_device_events(self) -> bool:
        return bool(self.kernels)

    # -- counts ----------------------------------------------------------
    def spans_named(self, name: str) -> List[Tuple[str, int, int, int, Any]]:
        return [s for s in self.spans if s[0] == name
                and self.t0 <= s[1] < self.t1]

    def family_s(self, fam: str) -> float:
        return sum(e - s for n, s, e in self.kernels
                   if family(n) == fam) / 1e9

    def kernels_matching(self, names: Sequence[str]):
        """Kernels whose (demangled) name holds one of `names`."""
        return [k for k in self.kernels if any(n in k[0] for n in names)]

    def assign(self, kernels, span_name: str):
        """Pair each kernel with the last `span_name` span that began
        before it: [(kernel, span or None)]."""
        spans = [s for s in self.spans if s[0] == span_name]
        starts = [s[1] for s in spans]
        out = []
        for k in kernels:
            i = bisect.bisect_right(starts, k[1]) - 1
            out.append((k, spans[i] if i >= 0 else None))
        return out

    # -- the breakdown ---------------------------------------------------
    def top_ops(self, n: int = 10) -> List[List[Any]]:
        tot: Dict[str, int] = {}
        for name, s, e in self.events:
            tot[name] = tot.get(name, 0) + (e - s)
        top = sorted(tot.items(), key=lambda x: -x[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]

    def _host_label(self, t: int) -> str:
        """The innermost span open at host time t, or 'no span'."""
        best = None
        for s in self.spans:
            if s[1] > t:
                break
            if s[2] >= t and (best is None or s[1] >= best[1]):
                best = s
        return best[0] if best else "no span"

    def idle_gaps(self, n: int = 10) -> List[List[Any]]:
        """The longest idle gaps of the device in the slice (the edges
        included), each labelled by what the host was doing as it began:
        [label, seconds]."""
        union = self._union()
        gaps = []
        prev = self.t0
        for s, e in union:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        gaps.sort(key=lambda g: -(g[1] - g[0]))
        return [[self._host_label(s), (e - s) / 1e9] for s, e in gaps[:n]]

"""Spans of the port's layers on the profiler's clock, and a Chrome trace
of a block with those spans in it (the counterpart of capdec_tpu/utils/
profiling.py's jax.profiler trace).

`span(name, **meta)` marks a region of the host's work: the serve loop's
batch build and finish, the decode engine's batches, steps and stop-flag
reads, the train step's forward, backward and optimizer. A span records
its name, start and end (`time.time_ns()`, the clock on which
torch.profiler stamps host and device events, so each kernel can be set
beside what the host was doing), the host thread's native id, its own id,
the id of the span open around it on the same thread, and its `meta`. A
span without a `batch` takes that of the span around it, so every span
of one batch carries its id, whichever thread records it.

Spans are recorded while a torch.profiler session is open, and only
then. Otherwise a span site costs one read of a module global and gets a
shared no-op context: no clock is read and no span is kept. Recorded
spans stay in a bounded in-memory deque until `clear()`; `spans()` reads
them and `trace(log_dir)` writes those of its block into its trace.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

TRACE_SUFFIX = ".trace.json"
# Spans kept (the newest); a decode step records two, a train step four.
MAX_SPANS = 1 << 18


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    tid: int                 # threading.get_native_id() of the recorder
    id: int
    parent: Optional[int]    # the span open around it on its thread
    meta: Dict[str, Any]


_spans: "collections.deque[Span]" = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_open = threading.local()    # .stack: the thread's open spans


class _Recording:
    """The context of one recorded span."""

    __slots__ = ("name", "meta", "id", "parent", "t0", "stack")

    def __init__(self, name: str, meta: Dict[str, Any]):
        self.name, self.meta = name, meta

    def __enter__(self) -> "_Recording":
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        outer = stack[-1] if stack else None
        if outer is not None and "batch" in outer.meta:
            self.meta.setdefault("batch", outer.meta["batch"])
        self.parent = outer.id if outer is not None else None
        self.id = next(_ids)
        self.stack = stack
        stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.time_ns()
        self.stack.pop()
        _spans.append(Span(self.name, self.t0, t1, threading.get_native_id(),
                           self.id, self.parent, self.meta))
        return False


class _NoSpan:
    """The shared context of a span site while no profiler is open."""

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


def span(name: str, **meta):
    """A context manager that records the span `name` around its block
    while a torch.profiler session is open (see the module docstring)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Recording(name, meta)


def spans() -> List[Span]:
    """The recorded spans, in the order they ended."""
    return list(_spans)


def clear() -> None:
    _spans.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (host ops, and CUDA kernels when a card is
    there) and write `capdec-<ns>.trace.json` into log_dir, with the
    program's spans of the block as complete events on their threads."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    t0 = time.time_ns()
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    path = os.path.join(log_dir, f"capdec-{time.time_ns()}{TRACE_SUFFIX}")
    prof.export_chrome_trace(path)
    _add_spans(path, [s for s in spans() if s.start_ns >= t0])


def _add_spans(path: str, recorded: List[Span]) -> None:
    """Append `recorded` to the Chrome trace at `path` as complete ("X")
    events of this process, on the trace's time base (microseconds from
    its `baseTimeNanoseconds`)."""
    with open(path) as f:
        data = json.load(f)
    base = int(data.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    data.setdefault("traceEvents", []).extend(
        {"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
         "tid": s.tid, "ts": (s.start_ns - base) / 1e3,
         "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"id": s.id, "parent": s.parent, **s.meta}}
        for s in recorded)
    with open(path, "w") as f:
        json.dump(data, f, default=str)

"""Offline captioning: a closed loop through `CaptionServer.serve`.

The request iterator makes requests from the seed as fast as the server
takes them; the server's bounded queue (`max_queue`, two batches) blocks
it, so at least one full batch is always waiting behind the one being
formed. A batch completes all its captions at once, so the window closes
at the first batch completion at or after `--seconds`, and
`captions_per_s` is every caption completed in the window over the
window's length, the ramp of the first batch included. A batch's
completion is when its first caption is yielded; the server's
`stats["batch_span_s"]` changes at every batch it finishes, which tells
the batches apart in the stream.

Mix parameters: batch_size, max_wait_s, max_queue, check_requests,
trace_after_s, trace_s.
"""
from __future__ import annotations

import threading
import time

from benchmark import common, serving, tracing


def run(run):
    tr = run.traffic
    server = serving.build_server(run)
    D = run.cfg["model"]["mapper"]["prefix_size"]
    rows = tr["batch_size"]
    stop = threading.Event()
    submitted = [0]

    def requests():
        chunk = 0
        while not stop.is_set():
            embs = serving.chunk_embeddings(run.seed, chunk, rows, D)
            for r in range(rows):
                if stop.is_set():
                    return
                submitted[0] += 1
                yield chunk * rows + r, embs[r]
            chunk += 1

    traced = None
    if run.trace:
        serving.install_spans(run.spans)
        traced = tracing.Slice(run.spans, run.device)
    served = {}
    batches = []           # [completion time, captions] of each batch
    current = None         # the entry of the batch being yielded
    last_span = None
    t_setup = time.perf_counter()
    t0 = time.perf_counter()
    window_end = None
    for rid, text in server.serve(requests()):
        t = time.perf_counter()
        served[rid] = text
        span = server.stats["batch_span_s"]
        if span != last_span:          # the first caption of a batch
            last_span = span
            current = None
            if window_end is None:
                current = [t, 0]
                batches.append(current)
                if t - t0 >= run.seconds:
                    window_end = t
                    stop.set()
                if traced is not None:
                    if traced.prof is None and t - t0 >= tr["trace_after_s"]:
                        traced.start()
                        traced_at = time.perf_counter()
                    elif (traced.prof is not None and not traced.t1_ns
                          and t - traced_at >= tr["trace_s"]):
                        traced.stop()
        if current is not None:
            current[1] += 1
    if traced is not None:
        if traced.prof is not None and not traced.t1_ns:
            traced.stop()
        run.spans.restore()
    if window_end is None:
        raise RuntimeError("the server stopped before the window closed")
    in_window = sum(n for _, n in batches)
    window_s = window_end - t0
    mem = common.device_info(run.device)
    stats = dict(server.stats)
    del server
    return {
        "setup_end": t_setup,
        "e2e": {"captions_per_s": in_window / window_s},
        "attempted": submitted[0],
        "missing": submitted[0] - len(served),
        "served": served,
        "window_s": window_s,
        "device": mem,
        "counters": {"stats": stats, "captions_in_window": in_window,
                     "batches_in_window": len(batches),
                     "captions_per_batch": [n for _, n in batches]},
        "trace": traced.result() if traced is not None and traced.t1_ns
        else None,
        "check": serving.check,
    }

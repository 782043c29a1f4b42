"""Batch-serving loop over the beam engine (port of capdec_tpu/serve.py).

A long-lived server that coalesces caption requests into fixed-shape
batches:
  * One batch shape: requests are padded up to `batch_size` with zero
    embeddings (l2-normalised like real ones) and the padding rows are
    dropped host-side.
  * Time/size-based coalescing: a batch launches when `batch_size`
    requests are waiting or `max_wait_s` elapsed with at least one.
  * Bounded request queue (`max_queue`): producers block when the server
    falls behind.
  * One batch in flight: the loop starts batch k+1's decode (on a worker
    thread, since the beam loop drives the card step by step from the
    host) before it finishes batch k (device->host copy of the rank-0
    beams and detokenization), so a finished batch is yielded while the
    next one decodes.
  * Per-request latency (enqueue -> caption yielded) and queue wait
    (enqueue -> launch); their percentiles via `latency_percentiles()`.
  * Counters in `stats`: batches, requests, `decode_s` (the decoding
    thread's time in `_decode`), `batch_span_s` (launch -> finish, summed
    over batches), `decode_steps` (the engine's steps, summed over
    batches) and `captions_stopped` (captions that ended at the stop
    token before entry_length).
  * Spans (utils/profiling.py, recorded while a profiler is open), each
    with its batch's id: `serve.collect` (the queue reads, the batch
    build and its launch), `serve.finish` (the wait, the copy to the host
    and `serve.detokenize`) on the serving thread, and `decode.batch` on
    the decoding thread, around the engine's `decode.step` spans.

The decode engine is the beam engine with its BeamConfig knobs (the int8
KV cache and the slot-bounded kernels included), or with `beam=False`
greedy/top-p decoding with its ToppConfig knobs. The server runs on the
CUDA device unless it is given `device="cpu"`.

Under a mesh (`ServeConfig.mesh`, parallel/mesh.py) every rank holds the
model; rank 0 runs the serving loop and, for each padded batch,
broadcasts its [B, D] embeddings and n; every rank decodes its B / dp
rows, and the rows' top tokens and lengths are gathered back for rank 0
to detokenize. The other ranks run `follow()` until rank 0's `close()`.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .decode import (BeamConfig, ToppConfig, beam_search, beam_top_select,
                     greedy_topp_search)
from .decode import staging
from .decode.beam import cast_params_for_decode
from .models import caption_model
from .parallel import mesh as mesh_lib
from .utils import profiling
from .utils.torch_setup import resolve_device

# Latency samples kept for the percentile report (the latest ones).
LATENCY_WINDOW = 100_000

# The commands rank 0 broadcasts to the follower ranks of a mesh.
_SHUTDOWN, _DECODE = 0, 1


@dataclasses.dataclass
class ServeConfig:
    batch_size: int = 64
    max_wait_s: float = 0.05
    # Beam search (True) or greedy/top-p decoding (False).
    beam: bool = True
    normalize_prefix: bool = True
    # Request-queue capacity: producers (the `requests` feeder thread and
    # `submit()`) block once this many requests are waiting. 0 = unbounded.
    max_queue: int = 4096
    # Optional parallel.mesh.Mesh: every fixed-shape batch shards over the
    # dp axis (batch_size must divide by dp; the batch shape never
    # changes, so there is no ragged fallback).
    mesh: Optional[Any] = None
    beam_config: BeamConfig = dataclasses.field(default_factory=BeamConfig)
    topp_config: ToppConfig = dataclasses.field(default_factory=ToppConfig)


def _fresh_stats() -> Dict[str, Any]:
    return {"batches": 0, "requests": 0, "decode_s": 0.0,
            "batch_span_s": 0.0, "decode_steps": 0, "captions_stopped": 0}


def _l2norm(x, axis=-1):
    return x / np.maximum(np.linalg.norm(x, axis=axis, keepdims=True), 1e-12)


class _Shutdown:
    """Queue sentinel that ends serve() regardless of stop_on_exhaust."""


class CaptionServer:
    """Caption CLIP embeddings with fixed-shape batched decode.

    `caption(embeds)` is the synchronous core (pads to the fixed batch).
    `serve(requests)` is the continuous-batching loop: an iterable of
    (request_id, embedding [D]) pairs -> yields (request_id, caption) in
    completion order. While serve() runs, requests can be injected from
    other threads with `submit(rid, embed)`; `shutdown()` ends the loop.
    """

    def __init__(self, model: caption_model.ClipCaptionModel,
                 model_cfg: caption_model.CaptionModelConfig,
                 tokenizer, cfg: ServeConfig = ServeConfig(),
                 device=None):
        self._mesh = cfg.mesh
        if self._mesh is not None:
            dp = self._mesh.shape[mesh_lib.DP_AXIS]
            if cfg.batch_size % dp:
                raise ValueError(
                    f"batch_size {cfg.batch_size} must be divisible by "
                    f"the mesh dp axis ({dp})")
            device = self._mesh.device
        self._device = resolve_device(device)
        self._model = model.to(self._device).eval()
        # the decoder's weights in the compute dtype, cast once
        self._gpt = cast_params_for_decode(self._model.gpt, model_cfg.gpt2)
        self._model_cfg = model_cfg
        self._tokenizer = tokenizer
        self._cfg = cfg
        self._queue: "queue.Queue[Any]" = queue.Queue(
            maxsize=max(0, cfg.max_queue))
        self._latencies: List[float] = []
        self._waits: List[float] = []
        # the id of the next batch launched (its spans' `batch`)
        self._next_batch = 0
        self.stats = _fresh_stats()

    def warmup(self) -> None:
        """Run one batch before serving traffic (excluded from the
        serving stats)."""
        self.caption(np.zeros((1, self._model_cfg.prefix_size), np.float32))
        self.stats = _fresh_stats()
        self._latencies = []
        self._waits = []

    def _decode(self, x: np.ndarray, batch: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Caption tokens [N, E] and lengths [N] of the padded batch: the
        rank-0 beams, selected on the device, or the greedy rows. Under a
        mesh, rank 0 hands the batch to the followers first. Its time is
        `stats["decode_s"]` (the engine reads a flag back every step, so
        it returns within a step's device time of the decode's end)."""
        t0 = time.perf_counter()
        with profiling.span("decode.batch", batch=batch):
            x = torch.from_numpy(x).to(self._device)
            if self._mesh is not None:
                self._broadcast_header(_DECODE, len(x))
                dist.broadcast(x, src=0)
            out = self._decode_rows(x)
        self.stats["decode_s"] += time.perf_counter() - t0
        return out

    def _decode_rows(self, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """_decode of the padded batch on the device: this dp rank's rows,
        gathered back over dp under a mesh."""
        mesh = self._mesh
        rows = x if mesh is None else mesh_lib.shard_batch(x, mesh)
        steps = staging.steps_run()
        prefix = caption_model.map_prefix(self._model, self._model_cfg,
                                          rows)
        if not self._cfg.beam:
            toks, lens = greedy_topp_search(self._gpt, self._model_cfg.gpt2,
                                            prefix, self._cfg.topp_config)
        else:
            toks, lens, _, order = beam_search(
                self._gpt, self._model_cfg.gpt2, prefix,
                self._cfg.beam_config)
            toks, lens = beam_top_select(toks, lens, order)
        self.stats["decode_steps"] += staging.steps_run() - steps
        if mesh is None:
            return toks, lens
        return (mesh_lib.gather_batch(toks, mesh),
                mesh_lib.gather_batch(lens, mesh))

    def _broadcast_header(self, command: int, n: int) -> torch.Tensor:
        """Rank 0's (command, n) to every rank; the followers' receive."""
        header = torch.tensor([command, n], dtype=torch.int64,
                              device=self._device)
        dist.broadcast(header, src=0)
        return header

    def follow(self) -> None:
        """A follower rank's loop under a mesh: decode its rows of each
        batch rank 0 broadcasts, until rank 0's `close()`."""
        if self._mesh is None or self._mesh.is_main:
            raise RuntimeError("follow() runs on the ranks other than 0 of "
                               "a mesh")
        D = self._model_cfg.prefix_size
        while int(self._broadcast_header(_SHUTDOWN, 0)[0]) == _DECODE:
            x = torch.empty(self._cfg.batch_size, D, dtype=torch.float32,
                            device=self._device)
            dist.broadcast(x, src=0)
            self._decode_rows(x)

    def close(self) -> None:
        """Rank 0 under a mesh: end the followers' loops (nothing to do
        without a mesh)."""
        if self._mesh is not None and self._mesh.is_main:
            self._broadcast_header(_SHUTDOWN, 0)

    def _launch(self, embeds: np.ndarray,
                pool: Optional[ThreadPoolExecutor] = None
                ) -> Callable[[], List[str]]:
        """Start decoding `embeds` [n, D] (n <= batch_size, padded to the
        fixed shape) and return a finisher that waits for the decode,
        copies the rank-0 beams to the host and detokenizes the n
        captions. The decode loop drives the card from the host step by
        step, so the decode runs on `pool`'s thread when one is given (the
        serve loop's batch in flight) and here otherwise. The batch takes
        the next batch id."""
        cfg = self._cfg
        n, D = embeds.shape
        if n > cfg.batch_size:
            raise ValueError(f"{n} requests > batch_size {cfg.batch_size}")
        batch = self._next_batch
        self._next_batch += 1
        x = np.zeros((cfg.batch_size, D), np.float32)
        x[:n] = embeds
        if cfg.normalize_prefix:
            x = _l2norm(x)
        if pool is not None:
            result = pool.submit(self._decode, x, batch).result
        else:
            done = self._decode(x, batch)
            result = lambda: done
        E = (cfg.beam_config if cfg.beam else cfg.topp_config).entry_length

        def finish() -> List[str]:
            top_toks, top_lens = result()
            t = top_toks.cpu().numpy()
            ln = top_lens.cpu().numpy()
            self.stats["captions_stopped"] += int((ln[:n] < E).sum())
            with profiling.span("serve.detokenize"):
                return [self._tokenizer.decode(t[i, :int(ln[i])])
                        for i in range(n)]

        self.stats["batches"] += 1
        self.stats["requests"] += n
        return finish

    def caption(self, embeds: np.ndarray) -> List[str]:
        """Caption `embeds` [n, D], n <= batch_size. Synchronous."""
        return self._launch(embeds)()

    def submit(self, rid: Any, embed: np.ndarray) -> None:
        """Inject a request into a running serve() loop (thread-safe;
        blocks when the queue is full — backpressure)."""
        self._queue.put((rid, embed, time.monotonic()))

    def shutdown(self) -> None:
        """End a running serve() loop after it drains what it has."""
        self._queue.put(_Shutdown)

    def serve(self, requests: Iterable[Tuple[Any, np.ndarray]],
              stop_on_exhaust: bool = True
              ) -> Iterable[Tuple[Any, str]]:
        """Continuous-batching generator.

        Pulls (id, embedding) pairs from `requests` on a feeder thread,
        coalesces up to batch_size (launching early after max_wait_s),
        yields (id, caption). With stop_on_exhaust (default) the loop
        drains and returns when the iterable ends; otherwise it keeps
        serving requests injected via `submit()` until `shutdown()`.
        Each iteration launches the next batch before it finishes the
        previous one, and a finished batch is yielded at once when no new
        request is queued."""
        q = self._queue

        def feeder():
            for rid, emb in requests:
                q.put((rid, emb, time.monotonic()))
            q.put(None)  # exhaust sentinel

        t = threading.Thread(target=feeder, daemon=True)
        t.start()
        with ThreadPoolExecutor(max_workers=1) as pool:
            yield from self._serve_loop(pool, stop_on_exhaust)

    def _serve_loop(self, pool: ThreadPoolExecutor, stop_on_exhaust: bool
                    ) -> Iterable[Tuple[Any, str]]:
        cfg = self._cfg
        q = self._queue
        done = False
        # (ids, arrivals, launch time, finisher, launch time on the
        # perf_counter clock, batch id) of the batch in flight
        pending: Optional[Tuple[List[Any], List[float], float, Callable,
                                float, int]] = None
        while not done or pending is not None:
            launched = None
            with profiling.span("serve.collect", batch=self._next_batch):
                batch: List[Tuple[Any, np.ndarray, float]] = []
                deadline = None
                while not done and len(batch) < cfg.batch_size:
                    if deadline is not None:
                        timeout = max(0.0, deadline - time.monotonic())
                    elif pending is not None:
                        timeout = 0.0  # drain what's queued; don't hold the
                        #                finished batch waiting for traffic
                    else:
                        timeout = None
                    try:
                        item = q.get(timeout=timeout)
                    except queue.Empty:
                        break
                    if item is None:  # requests iterable exhausted
                        if stop_on_exhaust:
                            done = True
                            break
                        continue  # keep waiting for submit()/shutdown()
                    if item is _Shutdown:
                        done = True
                        break
                    batch.append(item)
                    if deadline is None:
                        deadline = time.monotonic() + cfg.max_wait_s
                if batch:
                    ids = [i for i, _, _ in batch]
                    arrivals = [a for _, _, a in batch]
                    embeds = np.stack([e for _, e, _ in batch]).astype(
                        np.float32)
                    b = self._next_batch
                    t_launch = time.perf_counter()
                    launched = (ids, arrivals, time.monotonic(),
                                self._launch(embeds, pool), t_launch, b)
            if pending is not None:
                p_ids, p_arrivals, t_queue, finish, t_launch, p_b = pending
                with profiling.span("serve.finish", batch=p_b):
                    texts = finish()
                # batch_span_s: the launch -> finish interval of each
                # batch. End-to-end throughput is served / wall, measured
                # by the caller.
                self.stats["batch_span_s"] += time.perf_counter() - t_launch
                t_done = time.monotonic()
                for arr in p_arrivals:
                    self._latencies.append(t_done - arr)
                    self._waits.append(t_queue - arr)
                if len(self._latencies) > LATENCY_WINDOW:
                    del self._latencies[:-LATENCY_WINDOW]
                    del self._waits[:-LATENCY_WINDOW]
                for rid, text in zip(p_ids, texts):
                    yield rid, text
            pending = launched

    def latency_percentiles(self) -> Dict[str, float]:
        """p50/p95/p99 request latency (seconds, enqueue -> yield) and the
        p50/p95 queue wait (`wait_p50`, `wait_p95`: enqueue -> launch)
        over the latest LATENCY_WINDOW served requests."""
        if not self._latencies:
            return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "n": 0,
                    "wait_p50": 0.0, "wait_p95": 0.0}
        arr = np.asarray(self._latencies)
        wait = np.asarray(self._waits)
        return {"p50": float(np.percentile(arr, 50)),
                "p95": float(np.percentile(arr, 95)),
                "p99": float(np.percentile(arr, 99)),
                "n": int(arr.size),
                "wait_p50": float(np.percentile(wait, 50)),
                "wait_p95": float(np.percentile(wait, 95))}

    def throughput(self) -> float:
        """requests / decode_s: the decode rate, decode_s being the
        decoding thread's time in `_decode`; use served / wall for
        end-to-end serving throughput."""
        s = self.stats
        return s["requests"] / s["decode_s"] if s["decode_s"] else 0.0

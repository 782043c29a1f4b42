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
  * Per-request latency (enqueue -> caption yielded); p50/p95/p99 via
    `latency_percentiles()`.

The decode engine is the beam engine with its BeamConfig knobs (the int8
KV cache and the slot-bounded kernels included), or with `beam=False`
greedy/top-p decoding with its ToppConfig knobs. The server runs on the
CUDA device unless it is given `device="cpu"`.
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

from .decode import (BeamConfig, ToppConfig, beam_search, beam_top_select,
                     greedy_topp_search)
from .decode.beam import cast_params_for_decode
from .models import caption_model
from .utils.torch_setup import resolve_device

# Latency samples kept for the percentile report (the latest ones).
LATENCY_WINDOW = 100_000


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
    # Multi-device serving is not ported yet; must stay None.
    mesh: Optional[Any] = None
    beam_config: BeamConfig = dataclasses.field(default_factory=BeamConfig)
    topp_config: ToppConfig = dataclasses.field(default_factory=ToppConfig)


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
        if cfg.mesh is not None:
            raise NotImplementedError(
                "mesh-sharded serving is not ported yet "
                "(ROADMAP.md Queue 1, parallelism)")
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
        self.stats = {"batches": 0, "requests": 0, "decode_s": 0.0,
                      "batch_span_s": 0.0}

    def warmup(self) -> None:
        """Run one batch before serving traffic (excluded from the
        serving stats)."""
        self.caption(np.zeros((1, self._model_cfg.prefix_size), np.float32))
        self.stats = {"batches": 0, "requests": 0, "decode_s": 0.0,
                      "batch_span_s": 0.0}
        self._latencies = []

    def _decode(self, x: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """Caption tokens [N, E] and lengths [N] of the padded batch: the
        rank-0 beams, selected on the device, or the greedy rows."""
        prefix = caption_model.map_prefix(
            self._model, self._model_cfg,
            torch.from_numpy(x).to(self._device))
        if not self._cfg.beam:
            return greedy_topp_search(self._gpt, self._model_cfg.gpt2,
                                      prefix, self._cfg.topp_config)
        toks, lens, _, order = beam_search(self._gpt, self._model_cfg.gpt2,
                                           prefix, self._cfg.beam_config)
        return beam_top_select(toks, lens, order)

    def _launch(self, embeds: np.ndarray,
                pool: Optional[ThreadPoolExecutor] = None
                ) -> Callable[[], List[str]]:
        """Start decoding `embeds` [n, D] (n <= batch_size, padded to the
        fixed shape) and return a finisher that waits for the decode,
        copies the rank-0 beams to the host and detokenizes the n
        captions. The decode loop drives the card from the host step by
        step, so the decode runs on `pool`'s thread when one is given (the
        serve loop's batch in flight) and here otherwise."""
        cfg = self._cfg
        n, D = embeds.shape
        if n > cfg.batch_size:
            raise ValueError(f"{n} requests > batch_size {cfg.batch_size}")
        x = np.zeros((cfg.batch_size, D), np.float32)
        x[:n] = embeds
        if cfg.normalize_prefix:
            x = _l2norm(x)
        if pool is not None:
            result = pool.submit(self._decode, x).result
        else:
            done = self._decode(x)
            result = lambda: done

        def finish() -> List[str]:
            top_toks, top_lens = result()
            t = top_toks.cpu().numpy()
            ln = top_lens.cpu().numpy()
            return [self._tokenizer.decode(t[i, :int(ln[i])])
                    for i in range(n)]

        self.stats["batches"] += 1
        self.stats["requests"] += n
        return finish

    def caption(self, embeds: np.ndarray) -> List[str]:
        """Caption `embeds` [n, D], n <= batch_size. Synchronous."""
        t0 = time.perf_counter()
        texts = self._launch(embeds)()
        self.stats["decode_s"] += time.perf_counter() - t0
        return texts

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
        # (ids, arrivals, finisher, launch time) of the batch in flight
        pending: Optional[Tuple[List[Any], List[float], Callable, float]] = None
        while not done or pending is not None:
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
            launched = None
            if batch:
                ids = [i for i, _, _ in batch]
                arrivals = [a for _, _, a in batch]
                embeds = np.stack([e for _, e, _ in batch]).astype(
                    np.float32)
                t_launch = time.perf_counter()
                launched = (ids, arrivals, self._launch(embeds, pool),
                            t_launch)
            if pending is not None:
                p_ids, p_arrivals, finish, t_launch = pending
                t0 = time.perf_counter()
                texts = finish()
                t_fin = time.perf_counter()
                # decode_s: the blocking finish() only; batch_span_s: the
                # launch -> finish interval of each batch. End-to-end
                # throughput is served / wall, measured by the caller.
                self.stats["decode_s"] += t_fin - t0
                self.stats["batch_span_s"] += t_fin - t_launch
                t_done = time.monotonic()
                for arr in p_arrivals:
                    self._latencies.append(t_done - arr)
                if len(self._latencies) > LATENCY_WINDOW:
                    del self._latencies[:-LATENCY_WINDOW]
                for rid, text in zip(p_ids, texts):
                    yield rid, text
            pending = launched

    def latency_percentiles(self) -> Dict[str, float]:
        """p50/p95/p99 request latency (seconds, enqueue -> yield) over
        the latest LATENCY_WINDOW served requests."""
        if not self._latencies:
            return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "n": 0}
        arr = np.asarray(self._latencies)
        return {"p50": float(np.percentile(arr, 50)),
                "p95": float(np.percentile(arr, 95)),
                "p99": float(np.percentile(arr, 99)),
                "n": int(arr.size)}

    def throughput(self) -> float:
        """requests / decode_s (see serve() for what decode_s counts);
        use served / wall for end-to-end serving throughput."""
        s = self.stats
        return s["requests"] / s["decode_s"] if s["decode_s"] else 0.0

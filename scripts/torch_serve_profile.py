#!/usr/bin/env python3
"""Where one serving batch of the PyTorch port spends its time, on one
NVIDIA GPU.

    python3 scripts/torch_serve_profile.py [--int8_kv] [--chunks 8]
        [--greedy [--chunk_slot_write]] [--no_lanes] [--seqmajor]
        [--pallas_slot_write] [--ancestry] [--batch 64]

Builds chip_smoke.py's main-path server (seeded full-width GPT-2 124M +
8-layer TransformerMapper, bf16, batch 64 or `--batch N`, entry_length
67; beam 5, or
with `--greedy` greedy decoding, the default ToppConfig), warms it up,
then decodes one batch of requests under torch.profiler. The flags
pick the path: `--int8_kv` the int8 generated KV cache (beam: staged
growth; greedy: with `--chunks`, the fused chunked int8 route);
`--chunks N` the slot-bounded kernels in N-slot tiles
(`fused_slot_chunks`; greedy: the fused row-major route);
`--chunk_slot_write` greedy's kernel slot write (K13); and for the beam
search `--no_lanes` beams in rank order with the whole cache gathered
after each selection (`lane_beams=False`, K10), `--seqmajor` the
seq-major cache (`rowmajor_cache=False`, K11), `--pallas_slot_write` the
slot write K14 in place of K3 (`chunk_slot_write=False,
pallas_slot_write=True`) and `--ancestry` ancestry attention.
Prints one JSON line: the batch's wall time (unprofiled, and under the
profiler), the device time summed over its kernels, the device busy share
(device time / unprofiled wall), the number of kernel launches and decode
steps, the top device-time consumers, and every hand-written kernel's
device time (capdec_device_ms). Then, without the profiler, it
serves two batches of requests twice each way in the order A B B A: A =
`serve()` (the batch in flight decodes on the worker thread), B =
back-to-back synchronous `caption()` calls of a batch, and prints each
run's captions/s. With `--int8_kv` it also serves four batches through `serve()` on the
same path without int8 (A) and with it (B), in the order A B B A, for a
comparison of the two inside one process.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--int8_kv", action="store_true",
                   help="the int8 generated KV cache (kv_cache_int8)")
    p.add_argument("--chunks", type=int, default=0,
                   help="fused_slot_chunks: slot-bounded attention tiles")
    p.add_argument("--greedy", action="store_true",
                   help="greedy decoding (ServeConfig(beam=False))")
    p.add_argument("--chunk_slot_write", action="store_true",
                   help="greedy: the seq-major kernel slot write")
    p.add_argument("--no_lanes", action="store_true",
                   help="beam: lane_beams=False (K10 gathers)")
    p.add_argument("--seqmajor", action="store_true",
                   help="beam: rowmajor_cache=False (K11 gathers)")
    p.add_argument("--pallas_slot_write", action="store_true",
                   help="beam: the slot write K14 in place of K3")
    p.add_argument("--ancestry", action="store_true",
                   help="beam: ancestry attention (the cache never moves)")
    p.add_argument("--batch", type=int, default=64,
                   help="the server's batch (and a profiled batch's "
                        "requests)")
    args = p.parse_args(argv)
    knobs = {}
    if args.no_lanes:
        knobs["lane_beams"] = False
    if args.seqmajor:
        knobs["rowmajor_cache"] = False
    if args.pallas_slot_write:
        knobs.update(chunk_slot_write=False, pallas_slot_write=True)
    if args.ancestry:
        knobs["ancestry"] = True
    if args.greedy and knobs:
        p.error("--no_lanes, --seqmajor, --pallas_slot_write and --ancestry "
                "are beam-search knobs")
    if args.chunks:
        knobs["fused_slot_chunks"] = args.chunks
        if args.greedy:
            knobs["fused_attention"] = True
    if args.chunk_slot_write:
        knobs["chunk_slot_write"] = True
    path = dict(knobs, kv_cache_int8=True) if args.int8_kv else knobs
    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from capdec_tpu_torch.ops import lm_head
    from capdec_tpu_torch.utils.torch_setup import setup_torch

    setup_torch()
    chip_smoke.MAIN["N"] = args.batch
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    beam = not args.greedy
    server, model, *_ = chip_smoke.build_server(gen, beam=beam, **path)
    server.warmup()
    embeds = np.random.RandomState(1).randn(
        chip_smoke.MAIN["N"], chip_smoke.MAIN["prefix_size"]).astype(
            np.float32)
    server.caption(embeds)  # one more warm batch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server.caption(embeds)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    steps0 = lm_head.lm_head_topk.launches
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.caption(embeds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = lm_head.lm_head_topk.launches - steps0
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events() if e.device_type == cuda]
    device_us = sum(e.device_time_total for e in kernels)
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time_total)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    reqs = np.random.RandomState(2).randn(
        2 * chip_smoke.MAIN["N"], chip_smoke.MAIN["prefix_size"]).astype(
            np.float32)

    def serve_on(srv, reqs):
        return lambda: len(dict(srv.serve(
            (i, e) for i, e in enumerate(reqs))))

    via_serve = serve_on(server, reqs)

    def via_caption():
        n = chip_smoke.MAIN["N"]
        return sum(len(server.caption(reqs[i:i + n]))
                   for i in range(0, len(reqs), n))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served = fn()
        torch.cuda.synchronize()
        return served / (time.perf_counter() - t0)

    ab = [{"via": name, "captions_per_s": timed(fn)}
          for name, fn in (("serve", via_serve), ("caption", via_caption),
                           ("caption", via_caption), ("serve", via_serve))]
    paths_ab = None
    if args.int8_kv:
        bf16_server, *_ = chip_smoke.build_server(None, model=model,
                                                  beam=beam, **knobs)
        bf16_server.warmup()
        reqs4 = np.concatenate([reqs, reqs])  # 4 batches a run
        paths_ab = [{"path": name, "captions_per_s":
                     timed(serve_on(srv, reqs4))}
                    for name, srv in (("bf16", bf16_server),
                                      ("int8", server), ("int8", server),
                                      ("bf16", bf16_server))]
    print(json.dumps({
        "card": torch.cuda.get_device_name(0),
        "beam": beam,
        "knobs": path,
        "serve_ab": ab,
        "paths_ab": paths_ab,
        "batch_wall_ms": wall_plain * 1e3,
        "batch_wall_ms_profiled": wall * 1e3,
        "device_ms": device_us / 1e3,
        "device_busy_share": device_us / 1e3 / (wall_plain * 1e3),
        "decode_steps": steps,
        "kernel_launches": len(kernels),
        "launches_per_step": len(kernels) / max(steps, 1),
        "top_device_ms": [{"kernel": k[:90], "launches": n,
                           "ms": t / 1e3} for k, (n, t) in top],
        "capdec_device_ms": [{"kernel": k[:90], "launches": n,
                              "ms": t / 1e3}
                             for k, (n, t) in sorted(by_name.items())
                             if "capdec::" in k],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

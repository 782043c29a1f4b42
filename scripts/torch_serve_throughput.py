"""End-to-end serving throughput of the PyTorch port on the flagship model
(random weights; counterpart of scripts/serve_throughput.py).

Drives the production serving surface, CaptionServer.serve() with its
feeder thread, fixed-shape padded batches, one-batch-in-flight pipeline,
device-side rank-0 beam selection and host detokenization, on the CUDA
card (or `--device cpu`), and reports wall-clock captions/s and the
request latency percentiles.

Usage: python scripts/torch_serve_throughput.py [--n 2048] [--batch 512]
       [--no_beam] [--int8] [--sync] [--device cpu]   (--sync disables
       the pipeline by calling the synchronous caption() per batch, for A/B)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=2048)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--no_beam", action="store_true")
    p.add_argument("--int8", action="store_true")
    p.add_argument("--sync", action="store_true",
                   help="bypass the serve() pipeline: synchronous "
                        "caption() per coalesced batch")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p


def model_config():
    """The flagship: RN50x4 prefix (640) -> the 8-layer TransformerMapper
    -> GPT-2 124M, with bf16 products as the serve CLI's default (--bf16)
    and the card's kernels' first type."""
    import torch
    from capdec_tpu_torch.models import caption_model, gpt2
    return caption_model.CaptionModelConfig(
        gpt2=gpt2.GPT2Config(compute_dtype=torch.bfloat16))


def build_server(args):
    """The server on the flagship's random weights from seed 0, warmed up
    (one batch, excluded from the stats), and the model config."""
    import torch

    from capdec_tpu_torch import serve as serve_lib
    from capdec_tpu_torch.models import caption_model
    from capdec_tpu_torch.utils.tokenizer import load_tokenizer
    from capdec_tpu_torch.utils.torch_setup import resolve_device

    device = resolve_device(args.device)
    cfg = model_config()
    model = caption_model.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    bc = serve_lib.BeamConfig(beam_size=5, entry_length=67, stop_token=-1)
    if args.int8:
        bc = dataclasses.replace(bc, kv_cache_int8=True,
                                 fused_attention=True)
    scfg = serve_lib.ServeConfig(
        batch_size=args.batch, max_wait_s=0.05, beam=not args.no_beam,
        beam_config=bc,
        topp_config=serve_lib.ToppConfig(entry_length=67, stop_token=-1,
                                         extra_stop_token=-1))
    server = serve_lib.CaptionServer(model, cfg, load_tokenizer(), scfg,
                                     device=device)
    print("warming up...", file=sys.stderr, flush=True)
    server.warmup()
    return server, cfg


def serve_requests(server, cfg, args) -> dict:
    """args.n random embeddings (seed 0) through the server: the summary
    the script prints."""
    import numpy as np
    import torch

    rng = np.random.RandomState(0)
    embeds = rng.randn(args.n, cfg.prefix_size).astype(np.float32)
    served = 0
    t0 = time.perf_counter()
    if args.sync:
        for i in range(0, args.n, args.batch):
            served += len(server.caption(embeds[i:i + args.batch]))
    else:
        for _rid, _text in server.serve(
                (i, embeds[i]) for i in range(args.n)):
            served += 1
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pct = server.latency_percentiles()
    return {
        "serve_captions_per_sec": served / wall,
        "served": served, "wall_s": wall,
        "batches": server.stats["batches"],
        "mode": ("sync" if args.sync else "pipelined"),
        "beam": not args.no_beam, "int8": args.int8,
        "latency_p50_s": pct["p50"],
        "latency_p99_s": pct["p99"],
    }


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    server, cfg = build_server(args)
    out = serve_requests(server, cfg, args)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

"""Serving CLI: continuous-batching caption server over a checkpoint
(port of capdec_tpu/cli/serve.py, same flags and output).

Two request sources:
  --embeddings_pickle P : serve every embedding in a reference-schema
    pickle (throughput demo / smoke test), then exit.
  --watch DIR           : poll DIR for new `<id>.npy` CLIP-embedding
    files; each is captioned and `<id>.caption.txt` is written next to
    it. Ctrl-C to stop.

Results stream to stdout as JSON lines {"id": ..., "caption": ...}; the
final line reports throughput. The GPT-2 size is read from the
checkpoint's shapes; the mapper flags mirror cli/predict.py. `--no_beam`
serves greedy/top-p captions (ToppConfig(entry_length=...)); `--int8_kv`
serves beam search with the int8 generated KV cache (beam only, as in the
JAX CLI). Runs on the CUDA device unless `--device cpu` is given.

    python -m capdec_tpu_torch.cli.serve --checkpoint model.pt \
        --embeddings_pickle embeddings.pkl
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--checkpoint', required=True)
    p.add_argument('--embeddings_pickle', default='')
    p.add_argument('--watch', default='')
    p.add_argument('--batch_size', type=int, default=64)
    p.add_argument('--max_wait_s', type=float, default=0.05)
    p.add_argument('--beam', action='store_true', default=True)
    p.add_argument('--no_beam', dest='beam', action='store_false')
    p.add_argument('--is_rn', action='store_true', default=True)
    p.add_argument('--not_rn', dest='is_rn', action='store_false')
    p.add_argument('--prefix_dim', type=int, default=0,
                   help='CLIP embedding dim; 0 = derive from --is_rn '
                        '(640 RN50x4 / 512 ViT-B/32)')
    p.add_argument('--prefix_length', type=int, default=40)
    p.add_argument('--prefix_length_clip', type=int, default=40)
    p.add_argument('--num_layers', type=int, default=8)
    p.add_argument('--mapping_type', type=str, default='transformer_encoder')
    p.add_argument('--dont_normalize_prefix', action='store_true',
                   default=False)
    p.add_argument('--bf16', action='store_true', default=True)
    p.add_argument('--no_bf16', dest='bf16', action='store_false')
    p.add_argument('--int8_kv', action='store_true', default=False,
                   help='int8 generated KV cache for beam search (levels '
                        '+ per-slot scales; not token-identical to bf16)')
    p.add_argument('--beam_size', type=int, default=5)
    p.add_argument('--entry_length', type=int, default=67)
    p.add_argument('--mesh', default='',
                   help="shard each serving batch over a device mesh "
                        "(not ported yet)")
    p.add_argument('--device', default=None,
                   help="torch device (default: cuda; 'cpu' runs the "
                        "kernels' plain versions)")
    return p


def _watch_requests(watch_dir: str, poll_s: float = 0.2,
                    max_retries: int = 25):
    """Yield (path, embedding) for new .npy files, forever.

    A file that fails to load (usually a partial write) is retried on
    later polls up to `max_retries` times, then skipped for good. Both
    `seen` and the retry budget key on (name, mtime), so a rewritten file
    is served again with a fresh budget; entries of deleted files are
    pruned each poll."""
    import numpy as np
    seen = set()
    retries = {}
    while True:
        names = set()
        for name in sorted(os.listdir(watch_dir)):
            if not name.endswith('.npy'):
                continue
            names.add(name)
            path = os.path.join(watch_dir, name)
            try:
                key = (name, os.stat(path).st_mtime_ns)
            except OSError:
                continue  # deleted between listdir and stat
            if key in seen:
                continue
            try:
                emb = np.load(path).reshape(-1).astype(np.float32)
            except (OSError, ValueError, EOFError) as e:
                n = retries.get(key, 0) + 1  # partial write; retry later
                retries[key] = n
                if n >= max_retries:
                    seen.add(key)  # give up on this version of the file
                    retries.pop(key, None)
                    print(f'giving up on {name} after {n} failures: {e}',
                          file=sys.stderr, flush=True)
                else:
                    print(f'skip {name}: {e}', file=sys.stderr, flush=True)
                continue
            seen.add(key)
            retries.pop(key, None)
            yield path, emb
        seen = {k for k in seen if k[0] in names}
        retries = {k: c for k, c in retries.items() if k[0] in names}
        time.sleep(poll_s)


def main(argv=None):
    import numpy as np
    import torch

    from .. import serve as serve_lib
    from ..models import caption_model, gpt2
    from ..utils import checkpoint as ckpt_lib
    from ..utils.tokenizer import load_tokenizer
    from ..utils.torch_setup import resolve_device

    args = build_parser().parse_args(argv)
    if not args.embeddings_pickle and not args.watch:
        sys.exit('need --embeddings_pickle or --watch')
    if args.mesh:
        raise NotImplementedError(
            '--mesh is not ported yet (ROADMAP.md Queue 1, parallelism)')
    device = resolve_device(args.device)

    sd = ckpt_lib.load_state_dict(args.checkpoint)
    prefix_dim = args.prefix_dim or [512, 640][args.is_rn]
    model_cfg = caption_model.CaptionModelConfig(
        prefix_length=args.prefix_length,
        clip_length=args.prefix_length_clip,
        prefix_size=prefix_dim, num_layers=args.num_layers,
        mapping_type=args.mapping_type,
        gpt2=gpt2.config_from_torch_state_dict(
            sd, prefix='gpt.',
            compute_dtype=torch.bfloat16 if args.bf16 else torch.float32))
    model = caption_model.params_from_torch_state_dict(sd, model_cfg, device)
    tokenizer = load_tokenizer()

    bc = serve_lib.BeamConfig(beam_size=args.beam_size,
                              entry_length=args.entry_length)
    tc = serve_lib.ToppConfig(entry_length=args.entry_length)
    if args.int8_kv:
        bc = dataclasses.replace(bc, kv_cache_int8=True,
                                 fused_attention=True)
    cfg = serve_lib.ServeConfig(
        batch_size=args.batch_size, max_wait_s=args.max_wait_s,
        beam=args.beam, normalize_prefix=not args.dont_normalize_prefix,
        beam_config=bc, topp_config=tc)
    server = serve_lib.CaptionServer(model, model_cfg, tokenizer, cfg,
                                     device=device)
    print('warming up...', file=sys.stderr, flush=True)
    server.warmup()
    print('serving', file=sys.stderr, flush=True)

    if args.embeddings_pickle:
        with open(args.embeddings_pickle, 'rb') as f:
            data = pickle.load(f)
        emb = np.asarray(data['clip_embedding'], np.float32)
        reqs = ((i, emb[i]) for i in range(emb.shape[0]))
        t0 = time.perf_counter()
        for rid, text in server.serve(reqs):
            print(json.dumps({'id': int(rid), 'caption': text}), flush=True)
        wall = time.perf_counter() - t0
        pct = server.latency_percentiles()
        print(json.dumps({
            'served': server.stats['requests'],
            'batches': server.stats['batches'],
            'wall_s': round(wall, 2),
            'captions_per_s': round(server.stats['requests'] / wall, 1),
            'decode_captions_per_s': round(server.throughput(), 1),
            'latency_p50_s': round(pct['p50'], 4),
            'latency_p95_s': round(pct['p95'], 4),
            'latency_p99_s': round(pct['p99'], 4),
        }), flush=True)
        return

    for path, text in server.serve(_watch_requests(args.watch),
                                   stop_on_exhaust=False):
        out = path[:-len('.npy')] + '.caption.txt'
        with open(out, 'w') as f:
            f.write(text + '\n')
        print(json.dumps({'id': path, 'caption': text}), flush=True)


if __name__ == '__main__':
    main()

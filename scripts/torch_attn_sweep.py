#!/usr/bin/env python3
"""The K2/K6/K8/K9 kernel's time under other launch plans, on one NVIDIA
GPU.

    python3 scripts/torch_attn_sweep.py [--images N] [--prefix K]
        [--tiles 4,8,16] [--stages 2,3,4] [--tree DIR]

The kernel (csrc/decode_attention_async.cu) takes its chunk size, ring
depth and block size from ops/decode_attention.py's `attention_plan`;
its shared-memory layout follows from them. This script swaps in other
plans, one at a time, and times `beam_decode_attention_rowmajor` (bf16,
N images (`--images`, 64) x R = 5, K prefix slots (`--prefix`, 40),
E = 72, D = 768, 12 heads x 64) at steps 1, 33 and 66 over the layers in
turn (so that the reads come from device memory), greedy's
`beam_decode_attention_chunked` at R = 1, step 66, and
`beam_decode_attention_chunked_q` (K9, int8 cache and int8 prefix) at
step 66 with R = 5 (path (b)) and R = 1 (path (e)), and
`beam_decode_attention_rowmajor_q` (K6, int8 cache, bf16 prefix, R = 5)
at steps 1 and 66.

The plans: by default chunks of 1 to 4 prefixes' slices (tile = m
ceil(K / rows)), 2 to 8 ring stages, 96 or 128 threads, each under a
shared-memory budget of 30 to 75 KB a block. With `--tiles` instead
chunks of the given generated slots a row (for every call, int8 caches
too) under each of `--stages` ring depths, 128 threads, within a block's
227 KB; each line gives the served call's shared memory and the blocks
an SM holds by it.

It prints the card's name and power limit, the shipped plan's times (and
with `--tree DIR` those of that checkout's kernels under their own
shipped plans, loaded in the same process by scripts/torch_attn_steps.py's
`load_tree`), then one JSON line per plan, fastest at step 66 first.
"""
from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(1, str(Path(__file__).resolve().parent))

SM_SMEM, BLOCK_RESERVED = 228 * 1024, 1024  # an H100 SM's shared memory


def ints(text: str) -> list:
    return [int(x) for x in text.split(",")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--images", type=int, default=64, help="N")
    p.add_argument("--prefix", type=int, default=40, help="K prefix slots")
    p.add_argument("--tiles", type=ints, default=None,
                   help="generated slots a row a chunk, comma-separated")
    p.add_argument("--stages", type=ints, default=[2, 3, 4, 8],
                   help="ring depths, comma-separated")
    p.add_argument("--tree", default=None,
                   help="another checkout whose shipped plan is timed too")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_attn_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from capdec_tpu_torch.ops import decode_attention as da
    from capdec_tpu_torch.utils.torch_setup import setup_torch
    from torch_attn_steps import load_tree

    setup_torch()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    R, L, E, D, H = (cs.MAIN[k] for k in ("R", "L", "E", "D", "H"))
    N, K = args.images, args.prefix
    hd = D // H
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    rand = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(
        torch.bfloat16)
    lev = lambda *s: torch.randint(-127, 128, s, generator=gen,
                                   device="cuda", dtype=torch.int8)
    scl = lambda *s: torch.rand(*s, generator=gen, device="cuda") * 3 / 127
    q, kn, vn = rand(N * R, 3 * D).split(D, dim=-1)
    pk, pv, gk, gv = rand(L, N, K, D), rand(L, N, K, D), \
        rand(N * R, L, E, D), rand(N * R, L, E, D)
    q1, kn1, vn1 = rand(N, 3 * D).split(D, dim=-1)
    gk1, gv1 = rand(N, L, E, D), rand(N, L, E, D)
    pre8 = (lev(L, N, K, D), lev(L, N, K, D))
    ps = dict(pks=scl(L, N, 1, K), pvs=scl(L, N, 1, K))
    g8 = {r: (lev(N * r, L, E, D), lev(N * r, L, E, D),
              scl(N * r, L, 1, E), scl(N * r, L, 1, E)) for r in (R, 1)}

    def calls(da):
        def beam(step):
            return lambda i: da.beam_decode_attention_rowmajor(
                q, kn, vn, pk, pv, gk, gv, step, i % L, beams_per_image=R,
                head_dim=hd)

        def greedy(i):
            return da.beam_decode_attention_chunked(
                q1, kn1, vn1, pk, pv, gk1, gv1, 66, i % L, beams_per_image=1,
                head_dim=hd)

        def k9(r, qs):
            return lambda i: da.beam_decode_attention_chunked_q(
                *qs, *pre8, *g8[r], 66, i % L, beams_per_image=r,
                head_dim=hd, **ps)

        def k6(step):
            return lambda i: da.beam_decode_attention_rowmajor_q(
                q, kn, vn, pk, pv, *g8[R], step, i % L, beams_per_image=R,
                head_dim=hd)

        return {"1": beam(1), "33": beam(33), "66": beam(66),
                "greedy_66": greedy, "k9_66": k9(R, (q, kn, vn)),
                "k9_greedy_66": k9(1, (q1, kn1, vn1)), "k6_1": k6(1),
                "k6_66": k6(66)}

    def times(da):
        return {k: cs.time_ms(cs.rotating(fn, L), iters=40)
                for k, fn in calls(da).items()}

    def per_sm(plan):
        return min(SM_SMEM // (plan["smem"] + BLOCK_RESERVED),
                   2048 // plan["threads"])

    shipped = da.attention_plan
    if args.tree:
        print(json.dumps({"plan": "tree", "tree": args.tree,
                          "ms": times(load_tree(args.tree)[0])}), flush=True)
    served = shipped(N, R, K, D, hd, 66, 2)
    print(json.dumps({"plan": "shipped", "images": N, "prefix": K,
                      "served": served, "blocks_per_sm": per_sm(served),
                      "served_k9": shipped(N, R, K, D, hd, 66, 2, 1, 1),
                      "served_k6": shipped(N, R, K, D, hd, 66, 2, 1, 2, True),
                      "ms": times(da)}), flush=True)

    def make_plan(tile_of, stages, budget, threads):
        """A stand-in for attention_plan: tile_of(rows, K) slots a chunk,
        the deepest ring of at most `stages` within `budget` bytes, or
        None."""
        def plan(N_, R_, K_, D_, hd_, n_gen, itemsize, cache_size=None,
                 prefix_size=None, inreg=False):
            G = n_gen + 1
            rows_ = min(R_, da.ATTN_ROW_GROUP)
            tile = max(1, min(G, tile_of(rows_, K_)))
            nchunks = -(-G // tile)
            for nbuf in range(min(2 * (1 + nchunks), stages), 1, -1):
                smem = da._attention_smem(R_, K_, hd_, itemsize, tile, nbuf,
                                          threads, n_gen, cache_size,
                                          prefix_size, inreg)
                if smem <= budget:
                    return dict(grid=(D_ // hd_, N_,
                                      -(-R_ // da.ATTN_ROW_GROUP)),
                                threads=threads, tile=tile, nbuf=nbuf,
                                nchunks=nchunks, smem=smem, widened=False)
            return None
        return plan

    if args.tiles:
        grid = [(dict(tile=t, stages=s),
                 make_plan(lambda rows, K_, t=t: t, s, da.SMEM_MAX, 128))
                for t, s in itertools.product(args.tiles, args.stages)]
    else:
        grid = [(dict(budget_kb=b, stages=s, tile_prefixes=m, threads=t),
                 make_plan(lambda rows, K_, m=m: m * -(-K_ // rows), s,
                           b * 1024, t))
                for b, s, m, t in itertools.product(
                    (30, 37, 45, 75), args.stages, (1, 2, 3, 4), (96, 128))]
    rows = []
    for label, plan in grid:
        if any(plan(N, r, K, D, hd, 66, 2, *kind) is None
               for r in (R, 1) for kind in ((), (1, 1), (1, 2, True))):
            continue
        da.attention_plan = plan
        try:
            ms = times(da)
        finally:
            da.attention_plan = shipped
        main_plan = plan(N, R, K, D, hd, 66, 2)
        rows.append(dict(**label, served=main_plan,
                         blocks_per_sm=per_sm(main_plan),
                         served_k9=plan(N, R, K, D, hd, 66, 2, 1, 1),
                         served_k6=plan(N, R, K, D, hd, 66, 2, 1, 2, True),
                         ms=ms))
    for row in sorted(rows, key=lambda r: r["ms"]["66"]):
        print(json.dumps(row))
    for key in ("33", "k9_66", "k9_greedy_66", "k6_66"):
        best = min(rows, key=lambda r: r["ms"][key])
        print(json.dumps({"best_for": key, **best}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

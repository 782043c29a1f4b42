#!/usr/bin/env python3
"""K2 (beam_decode_attention_rowmajor) against the beam count, on one
NVIDIA GPU.

    python3 scripts/torch_wide_beam_steps.py

The attention kernel serves a block's rows in groups of at most 16 on the
grid's third axis, so a beam of 33 runs three groups per (head, image),
the last of one row. This script times K2 in bf16 at the served shapes'
last step (64 images, K = 40, E = 72, step 66, GPT-2 124M's 12 x 64
heads) for R = 5, 16, 17, 32, 33 and 48, beside SDPA on keys
concatenated beforehand and the bound (each input read once, the output
written once, at 3.35 TB/s), with the time per row group and per beam
row. At R = 33 it also times the kernel under plans with larger chunks
(the tile of m ceil(K / 16) slots for m = 1-4, under budgets of 37, 75
and 112 KB a block). Each call reads one layer's generated cache, 233 MB
at R = 33, past the L2. It prints the card's name and power limit, then
one JSON line per measurement.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

BEAMS = (5, 16, 17, 32, 33, 48)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_wide_beam_steps: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from capdec_tpu_torch.ops import decode_attention as da
    from capdec_tpu_torch.utils.torch_setup import setup_torch

    setup_torch()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    N, L, K, E, D, H = (cs.MAIN[k] for k in ("N", "L", "K", "E", "D", "H"))
    hd, step, layer = D // H, cs.MAIN["entry_length"] - 1, L // 2
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)

    def rand(*s):
        return torch.randn(*s, generator=gen, device="cuda").to(
            torch.bfloat16)

    B_max = N * max(BEAMS)
    qkv = rand(B_max, 3 * D)
    pk, pv = rand(L, N, K, D), rand(L, N, K, D)
    gk, gv = rand(B_max, L, E, D), rand(B_max, L, E, D)

    def inputs(R):
        q, kn, vn = qkv[:N * R].split(D, dim=-1)
        return q, kn, vn, pk, pv, gk[:N * R], gv[:N * R]

    def call(R):
        q, kn, vn, pk_, pv_, gk_, gv_ = inputs(R)
        return lambda: da.beam_decode_attention_rowmajor(
            q, kn, vn, pk_, pv_, gk_, gv_, step, layer, beams_per_image=R,
            head_dim=hd, e_cap=E)

    for R in BEAMS:
        B = N * R
        q, kn, vn, _, _, gk_, gv_ = inputs(R)
        keys, vals = (torch.cat([p[layer].repeat_interleave(R, 0),
                                 g[:, layer, :step], n[:, None]], 1)
                      for p, g, n in ((pk, gk_, kn), (pv, gv_, vn)))
        nbytes = 3 * B * D * 2 + 2 * N * K * D * 2 + 2 * B * step * D * 2 \
            + B * D * 4
        b_ms, b_by = cs.bound_ms(nbytes, 4.0 * B * D * (K + step + 1),
                                 torch.bfloat16)
        plan = da.attention_plan(N, R, K, D, hd, step, 2)
        ms = cs.time_ms(call(R), iters=40)
        groups = plan["grid"][2]
        print(json.dumps(dict(
            R=R, grid=list(plan["grid"]), tile=plan["tile"],
            smem=plan["smem"], ms=ms, bound_ms=b_ms, bound_by=b_by,
            share=b_ms / ms, library_ms=cs.sdpa_ms(q, keys, vals, H),
            ms_per_row_group=ms / groups, us_per_beam_row=ms * 1e3 / R)),
            flush=True)
        del keys, vals

    shipped = da.attention_plan
    R = 33
    for budget_kb in (37, 75, 112):
        for mult in (1, 2, 3, 4):
            def plan(N_, R_, K_, D_, hd_, n_gen, itemsize, cache_size=None,
                     prefix_size=None, inreg=False, budget_kb=budget_kb,
                     mult=mult):
                G = n_gen + 1
                rows = min(R_, da.ATTN_ROW_GROUP)
                tile = max(1, min(G, mult * -(-K_ // rows)))
                smem = da._attention_smem(R_, K_, hd_, itemsize, tile,
                                          da.ATTN_STAGES, da.ATTN_THREADS,
                                          n_gen, cache_size, prefix_size,
                                          inreg)
                if smem > budget_kb * 1024:
                    return None
                return dict(grid=(D_ // hd_, N_, -(-R_ // rows)),
                            threads=da.ATTN_THREADS, tile=tile,
                            nbuf=da.ATTN_STAGES, nchunks=-(-G // tile),
                            smem=smem, widened=False)
            p = plan(N, R, K, D, hd, step, 2)
            if p is None:
                continue
            da.attention_plan = plan
            try:
                ms = cs.time_ms(call(R), iters=40)
            finally:
                da.attention_plan = shipped
            print(json.dumps(dict(R=R, budget_kb=budget_kb,
                                  tile_prefixes=mult, tile=p["tile"],
                                  smem=p["smem"], ms=ms)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

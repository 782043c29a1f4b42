#!/usr/bin/env python3
"""Times of the int8-cache kernels K6 and K5 on one NVIDIA GPU, beside
K9's, and the registers and spills of every kernel.

    python3 scripts/torch_int8_steps.py [--tree DIR]

At the served shape (N = 64 images x R = 5 beams, L = 12, K = 40 prefix
slots, E = 72, D = 768, 12 heads x 64, a bf16 q over int8 caches) it times
`beam_decode_attention_rowmajor_q` (K6, e_cap = E) at
chip_smoke.ATTN_STEPS, once on one layer and once rotated over the
layers, beside SDPA on keys and values dequantised and joined beforehand
and the bound (chip_smoke.attention_step_times);
`write_gen_slot_chunk_q` (K5) over bf16 new K/V sets and slots rotated
past the L2 (chip_smoke.quantising_write_call) beside its bound; and
`beam_decode_attention_chunked_q` (K9) at the three shapes of
scripts/torch_attn_steps.py, to show whether they moved. It prints the
card's name and power limit, then one JSON line.

`--tree DIR` also loads the `capdec_tpu_torch` of another checkout (e.g.
an exported parent commit) in the same process, with its own kernel
library (scripts/torch_attn_steps.load_tree), and times both versions on
the same inputs by the same code, in turns (tree, this, this, tree).
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent


def _module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def int8_times(da, cr, cs, tas, gen) -> dict:
    """K6's, K5's and K9's times for the modules da (decode_attention) and
    cr (cache_reorder) of one version, on inputs made from `gen`."""
    N, R, L, K, E, D, H = (cs.MAIN[k] for k in ("N", "R", "L", "K", "E", "D",
                                                "H"))
    B, hd = N * R, D // H
    rand = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(
        torch.bfloat16)
    lev = lambda *s: torch.randint(-127, 128, s, generator=gen,
                                   device="cuda", dtype=torch.int8)
    q, kn, vn = rand(B, 3 * D).split(D, dim=-1)
    pk, pv, gk, gv = rand(L, N, K, D), rand(L, N, K, D), lev(B, L, E, D), \
        lev(B, L, E, D)
    gks, gvs = (torch.rand(B, L, 1, E, generator=gen, device="cuda") * 3 / 127
                for _ in range(2))
    last = cs.ATTN_STEPS[-1]
    gks[..., last:] = float("nan")  # above every timed step: never read
    gvs[..., last:] = float("nan")
    out = {"beam_decode_attention_rowmajor_q": cs.attention_step_times(
        lambda s, l: da.beam_decode_attention_rowmajor_q(
            q, kn, vn, pk, pv, gk, gv, gks, gvs, s, l, beams_per_image=R,
            head_dim=hd, e_cap=E),
        q, kn, vn, pk, pv, gk, gv, R, H, scales=(None, None, gks, gvs))}
    del q, kn, vn, pk, pv, gk, gv, gks, gvs
    k, v = lev(B, L, E, D), lev(B, L, E, D)
    ks, vs = (torch.rand(B, L, 1, E, generator=gen, device="cuda")
              for _ in range(2))
    sets = cs.new_kv_sets(gen, (B, L, D))
    b_ms, b_by = cs.bound_ms(2 * B * L * D * 2 + 2 * B * L * (D + 4),
                             6.0 * 2 * B * L * D, torch.float32)
    out["write_gen_slot_chunk_q"] = dict(
        ms=cs.time_ms(cs.quantising_write_call(cr.write_gen_slot_chunk_q, k,
                                               v, ks, vs, sets)),
        bound_ms=b_ms, bound_by=b_by, sets=len(sets))
    del k, v, ks, vs, sets
    for name, (call, inputs, opts) in tas.attention_calls(da, cs,
                                                          gen).items():
        if name.startswith("beam_decode_attention_chunked_q"):
            out[name] = cs.attention_step_times(call, *inputs[:7], inputs[7],
                                                H, **opts)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tree", default=None,
                   help="another checkout whose capdec_tpu_torch is timed "
                        "beside this one's")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_int8_steps: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    cs = _module("chip_smoke", HERE / "chip_smoke.py")
    tas = _module("torch_attn_steps", HERE / "scripts" / "torch_attn_steps.py")
    from capdec_tpu_torch.ops import _build, cache_reorder
    from capdec_tpu_torch.ops import decode_attention as da
    from capdec_tpu_torch.utils.torch_setup import setup_torch

    setup_torch()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    versions = {"this": (da, cache_reorder, _build)}
    if args.tree:
        tda, tbuild = tas.load_tree(args.tree)
        versions["tree"] = (tda, importlib.import_module(
            "tree_capdec_tpu_torch.ops.cache_reorder"), tbuild)
    built = {}
    for name, (_, _, bld) in versions.items():
        so = bld.library_path()
        bld.library()
        log = so.with_suffix(".log")
        report = cs.ptxas_report(log.read_text()) if log.exists() else {}
        built[name] = dict(
            library=so.name, build_s=bld.build_seconds,
            ptxas={n: r for n, r in report.items()
                   if "write_gen_slot_q" in n or "attn" in n})
    order = ["tree", "this", "this", "tree"] if args.tree else ["this"]
    times = {}
    for i, name in enumerate(order):
        da_v, cr_v, _ = versions[name]
        times[f"{name}_{i}"] = int8_times(
            da_v, cr_v, cs, tas,
            torch.Generator(device="cuda").manual_seed(cs.SEED))
        torch.cuda.empty_cache()
    print(smi)
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "tree": args.tree, "built": built,
                      "steps": times}, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Times of the bf16 decode-attention kernels K2, K8, K9 and K15 against
the step, on one NVIDIA GPU, and the registers and spills of every kernel.

    python3 scripts/torch_attn_steps.py [--tree DIR]

At the served shape (N = 64 images x R = 5 beams, L = 12, K = 40 prefix
slots, E = 72, D = 768, 12 heads x 64) it times
`beam_decode_attention_rowmajor` (K2, e_cap = E),
`beam_decode_attention_chunked` (K8, chunk 8),
`beam_decode_attention_chunked_q` (K9, chunk 8, an int8 cache: R = 5 with
an int8 prefix as path (b) serves it and with a bf16 prefix, and R = 1
with the int8 prefix as path (e) serves it) and `beam_decode_attention`
(K15 over L cache sets [B, E, D], its slot write included) at
chip_smoke.ATTN_STEPS, beside SDPA on keys joined beforehand (dequantised
for K9; followed by `index_copy_` of the slot for K15) and the bound: each
once on one layer and once rotated over the layers or cache sets (SDPA
over key sets), so that the reads come from device memory
(chip_smoke.attention_step_times). It prints the card's name and power
limit, then one JSON line.

`--tree DIR` also loads the `capdec_tpu_torch` of another checkout (e.g.
an exported parent commit) in the same process, as a package of another
name with its own kernel library, and times both versions on the same
inputs by the same code, in turns (tree, this, this, tree); chip_smoke.py
always comes from this script's checkout.
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


def load_tree(tree: str):
    """The decode_attention and _build modules of `tree`'s
    capdec_tpu_torch, imported as package `tree_capdec_tpu_torch` (the
    ops modules import each other relatively, and _build builds the
    tree's own sources into the tree's own library)."""
    root = Path(tree).resolve() / "capdec_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "tree_capdec_tpu_torch", root / "__init__.py",
        submodule_search_locations=[str(root)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = pkg
    spec.loader.exec_module(pkg)
    return (importlib.import_module("tree_capdec_tpu_torch.ops."
                                    "decode_attention"),
            importlib.import_module("tree_capdec_tpu_torch.ops._build"))


def attention_calls(da, cs, gen):
    """name -> (call(step, layer), attention_step_times' inputs, options)
    for the kernels of module `da`, on inputs made from `gen`."""
    N, R, L, K, E, D, H = (cs.MAIN[k] for k in ("N", "R", "L", "K", "E", "D",
                                                "H"))
    B, hd = N * R, D // H
    rand = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(
        torch.bfloat16)
    q, kn, vn = rand(B, 3 * D).split(D, dim=-1)
    pk, pv, gk, gv = rand(L, N, K, D), rand(L, N, K, D), rand(B, L, E, D), \
        rand(B, L, E, D)
    kw = dict(beams_per_image=R, head_dim=hd)
    calls = {
        "beam_decode_attention_rowmajor": (lambda s, l: (
            da.beam_decode_attention_rowmajor(q, kn, vn, pk, pv, gk, gv, s, l,
                                              e_cap=E, **kw)),
            (q, kn, vn, pk, pv, gk, gv, R), {}),
        "beam_decode_attention_chunked": (lambda s, l: (
            da.beam_decode_attention_chunked(q, kn, vn, pk, pv, gk, gv, s, l,
                                             chunk=8, **kw)),
            (q, kn, vn, pk, pv, gk, gv, R), {})}
    lev = lambda *s: torch.randint(-127, 128, s, generator=gen,
                                   device="cuda", dtype=torch.int8)
    scl = lambda *s: torch.rand(*s, generator=gen, device="cuda") * 3 / 127
    pk8, pv8, pks, pvs = lev(L, N, K, D), lev(L, N, K, D), \
        scl(L, N, 1, K), scl(L, N, 1, K)
    for name, r, int8_prefix in (("int8_prefix", R, True),
                                 ("bf16_prefix", R, False),
                                 ("greedy_r1", 1, True)):
        qr, knr, vnr = rand(N * r, 3 * D).split(D, dim=-1)
        g8 = (lev(N * r, L, E, D), lev(N * r, L, E, D),
              scl(N * r, L, 1, E), scl(N * r, L, 1, E))
        pre = (pk8, pv8) if int8_prefix else (pk, pv)
        ps = dict(pks=pks, pvs=pvs) if int8_prefix else {}
        calls[f"beam_decode_attention_chunked_q {name}"] = (
            lambda s, l, qr=qr, knr=knr, vnr=vnr, g8=g8, pre=pre, ps=ps, r=r:
            da.beam_decode_attention_chunked_q(
                qr, knr, vnr, *pre, *g8, s, l, beams_per_image=r,
                head_dim=hd, chunk=8, **ps),
            (qr, knr, vnr, *pre, *g8[:2], r),
            dict(scales=(ps.get("pks"), ps.get("pvs"), *g8[2:])))
    # K15: one layer's caches [B, E, D], L sets of them
    gk1, gv1 = rand(L, B, E, D), rand(L, B, E, D)
    slot = [torch.tensor([s], device="cuda") for s in range(E)]

    def write(step, l):
        gk1[l].index_copy_(1, slot[step], kn[:, None])
        gv1[l].index_copy_(1, slot[step], vn[:, None])

    calls["beam_decode_attention"] = (
        lambda s, l: da.beam_decode_attention(q, kn, vn, pk[l], pv[l],
                                              gk1[l], gv1[l], s, **kw),
        (q, kn, vn, pk, pv, gk1.transpose(0, 1), gv1.transpose(0, 1), R),
        dict(write=write))
    return calls


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tree", default=None,
                   help="another checkout whose capdec_tpu_torch is timed "
                        "beside this one's")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_attn_steps: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from capdec_tpu_torch.ops import _build
    from capdec_tpu_torch.ops import decode_attention as da
    from capdec_tpu_torch.utils.torch_setup import setup_torch

    setup_torch()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    versions = {"this": (da, _build)}
    if args.tree:
        versions["tree"] = load_tree(args.tree)
    built = {}
    for name, (_, bld) in versions.items():
        so = bld.library_path()
        bld.library()
        log = so.with_suffix(".log")
        built[name] = dict(library=so.name, build_s=bld.build_seconds,
                           ptxas=cs.ptxas_report(log.read_text())
                           if log.exists() else {})
    H = cs.MAIN["H"]
    order = ["tree", "this", "this", "tree"] if args.tree else ["this"]
    times = {}
    for i, name in enumerate(order):
        calls = attention_calls(versions[name][0], cs, torch.Generator(
            device="cuda").manual_seed(cs.SEED))
        times[f"{name}_{i}"] = {
            kernel: cs.attention_step_times(call, *inputs[:7], inputs[7], H,
                                            **opts)
            for kernel, (call, inputs, opts) in calls.items()}
        del calls
        torch.cuda.empty_cache()
    print(smi)
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "tree": args.tree, "built": built,
                      "steps": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

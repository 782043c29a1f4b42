#!/usr/bin/env python3
"""Times of the bf16 decode-attention kernels K2 and K8 against the step,
on one NVIDIA GPU, and the registers and spills of every kernel.

    python3 scripts/torch_attn_steps.py [--tree DIR]

At the served shape (N = 64 images x R = 5 beams, L = 12, K = 40 prefix
slots, E = 72, D = 768, 12 heads x 64) it times
`beam_decode_attention_rowmajor` (K2, e_cap = E) and
`beam_decode_attention_chunked` (K8, chunk 8) at chip_smoke.ATTN_STEPS,
beside SDPA on keys joined beforehand and the bound: each once on one
layer and once rotated over the layers (SDPA over key sets), so that the
reads come from device memory (chip_smoke.attention_step_times). It
prints the card's name and power limit, then one JSON line.

`--tree DIR` imports `capdec_tpu_torch` from another checkout (e.g. an
exported parent commit), so that two versions of the kernels are timed
by the same code; chip_smoke.py always comes from this script's
checkout.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tree", default=str(HERE),
                   help="checkout whose capdec_tpu_torch is timed")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_attn_steps: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.tree).resolve()))
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
    so = _build.library_path()
    _build.library()
    log = so.with_suffix(".log")
    ptxas = cs.ptxas_report(log.read_text()) if log.exists() else {}
    N, R, L, K, E, D, H = (cs.MAIN[k] for k in ("N", "R", "L", "K", "E", "D",
                                                "H"))
    B, hd = N * R, D // H
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    rand = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(
        torch.bfloat16)
    q, kn, vn = rand(B, 3 * D).split(D, dim=-1)
    pk, pv, gk, gv = rand(L, N, K, D), rand(L, N, K, D), rand(B, L, E, D), \
        rand(B, L, E, D)
    kw = dict(beams_per_image=R, head_dim=hd)
    calls = {
        "beam_decode_attention_rowmajor": lambda s, l: (
            da.beam_decode_attention_rowmajor(q, kn, vn, pk, pv, gk, gv, s, l,
                                              e_cap=E, **kw)),
        "beam_decode_attention_chunked": lambda s, l: (
            da.beam_decode_attention_chunked(q, kn, vn, pk, pv, gk, gv, s, l,
                                             chunk=8, **kw))}
    times = {name: cs.attention_step_times(call, q, kn, vn, pk, pv, gk, gv,
                                           R, H)
             for name, call in calls.items()}
    print(smi)
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "tree": str(args.tree),
                      "library": so.name, "build_s": _build.build_seconds,
                      "ptxas": ptxas, "steps": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

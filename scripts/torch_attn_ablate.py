#!/usr/bin/env python3
"""Where K9's time goes beyond K8's: the decode-attention kernel with one
part of its int8 policy taken out, timed beside the kernel as shipped,
on one NVIDIA GPU.

    python3 scripts/torch_attn_ablate.py

Each variant is a copy of `capdec_tpu_torch` under `_ablate/<name>/`
(git-ignored) with one edit to csrc/decode_attention_async.cu, built
into its own library and loaded in a process of its own (as
scripts/torch_attn_steps.py's `load_tree` loads another checkout):
  * no_widen: int8 stages are read as they landed, not widened to bf16;
  * no_scale_mul: no K scale on a score, no V scale on a probability;
  * no_scale_copy: the generated slots' scales are not copied.
The variants compute wrong values: they are timings only. Each run times
K8 (`beam_decode_attention_chunked`, bf16 caches) and K9
(`beam_decode_attention_chunked_q`: an int8 cache with a bf16 prefix and
with an int8 prefix) at the served shape (N = 64 images x R = 5, L = 12,
K = 40, E = 72, D = 768, 12 heads x 64, chunk 8) at steps 0 and 66 on
one layer. An edit that no longer matches the source exactly once stops
the script. It prints the card's name and power limit, then one JSON
line per variant ("shipped" first and last).
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent
SOURCE = "csrc/decode_attention_async.cu"
VARIANTS = {
    "no_widen": [(
        "  auto narrow = [&](int s) { return chunk_of(s) < 0 ? kNarrowP : "
        "kNarrowC; };",
        "  auto narrow = [&](int s) { return false; };")],
    "no_scale_mul": [
        ("    return ks && s != cur_s ? ks[r * kst + s] : 1.f;",
         "    return 1.f;"),
        ("        if (s >= K && s - K < n_gen) w *= sgv[r * n_gen + s - K];",
         "        ;"),
        ("        if (s < K) w *= scl[K + s];", "        ;")],
    "no_scale_copy": [(
        "    if constexpr (kNarrowC) {\n"
        "      for (int i = lane; i < Rb * n_gen; i += 32) {",
        "    if constexpr (false) {\n"
        "      for (int i = lane; i < Rb * n_gen; i += 32) {")],
}


def make_tree(name: str) -> Path:
    """_ablate/<name>/capdec_tpu_torch with the variant's edits."""
    root = HERE / "_ablate" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(HERE / "capdec_tpu_torch", root / "capdec_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = root / "capdec_tpu_torch" / SOURCE
    text = path.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the edit no longer matches {SOURCE}: "
                             f"{old!r}")
        text = text.replace(old, new)
    path.write_text(text)
    return root


def time_tree(tree: str) -> dict:
    """K8 and K9's times of one tree's kernels (this checkout's if
    empty)."""
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(HERE / "scripts"))
    import chip_smoke as cs
    if tree:
        from torch_attn_steps import load_tree
        da = load_tree(tree)[0]
    else:
        from capdec_tpu_torch.ops import decode_attention as da
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    N, R, L, K, E, D, H = (cs.MAIN[k] for k in ("N", "R", "L", "K", "E", "D",
                                                "H"))
    B = N * R
    rand = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(
        torch.bfloat16)
    lev = lambda *s: torch.randint(-127, 128, s, generator=gen,
                                   device="cuda", dtype=torch.int8)
    scl = lambda *s: torch.rand(*s, generator=gen, device="cuda") * 3 / 127
    q, kn, vn = rand(B, 3 * D).split(D, dim=-1)
    pk, pv, gk, gv = rand(L, N, K, D), rand(L, N, K, D), rand(B, L, E, D), \
        rand(B, L, E, D)
    gk8, gv8, pk8, pv8 = lev(B, L, E, D), lev(B, L, E, D), lev(L, N, K, D), \
        lev(L, N, K, D)
    gks, gvs, pks, pvs = scl(B, L, 1, E), scl(B, L, 1, E), scl(L, N, 1, K), \
        scl(L, N, 1, K)
    kw = dict(beams_per_image=R, head_dim=D // H, chunk=8)
    layer = L // 2
    out = {}
    for step in (0, 66):
        out[step] = dict(
            k8=cs.time_ms(lambda: da.beam_decode_attention_chunked(
                q, kn, vn, pk, pv, gk, gv, step, layer, **kw), iters=50),
            k9_bf16_prefix=cs.time_ms(
                lambda: da.beam_decode_attention_chunked_q(
                    q, kn, vn, pk, pv, gk8, gv8, gks, gvs, step, layer, **kw),
                iters=50),
            k9_int8_prefix=cs.time_ms(
                lambda: da.beam_decode_attention_chunked_q(
                    q, kn, vn, pk8, pv8, gk8, gv8, gks, gvs, step, layer,
                    pks=pks, pvs=pvs, **kw), iters=50))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--time", default=None, metavar="TREE",
                   help=argparse.SUPPRESS)  # one variant, in this process
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_attn_ablate: no CUDA device", file=sys.stderr)
        return 1
    if args.time is not None:
        print(json.dumps(time_tree(args.time)))
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    for name in ("shipped", *VARIANTS, "shipped"):
        tree = "" if name == "shipped" else str(make_tree(name))
        run = subprocess.run([sys.executable, __file__, "--time", tree],
                             capture_output=True, text=True, timeout=900)
        if run.returncode:
            raise SystemExit(f"{name}: exit {run.returncode}\n"
                             f"{run.stderr[-3000:]}")
        print(json.dumps({"variant": name,
                          "ms": json.loads(run.stdout.splitlines()[-1])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

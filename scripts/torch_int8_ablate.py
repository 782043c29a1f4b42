#!/usr/bin/env python3
"""Where K6's and K5's time goes: the int8-cache kernels with one part taken
out, timed beside the kernels as shipped, on one NVIDIA GPU.

    python3 scripts/torch_int8_ablate.py

Each variant is a copy of `capdec_tpu_torch` under `_ablate/<name>/`
(git-ignored) with one edit, built into its own library (all builds run
together) and loaded into this process as a package of its own name:
  * k6_no_score: K6 scores no int8 chunk (its K stages are only waited on);
  * k6_no_value: K6 sums no int8 chunk's values;
  * k6_no_compute: both, leaving the copies, the prefix and the softmax;
  * k6_rows_3: blocks of at most 3 rows (two blocks an image at R = 5, a
    grid of two waves) in place of 16 (one block an image);
  * k5_no_levels: K5 stores zero levels (loads, absmax, scale and stores
    remain);
  * k5_ieee_div: K5 takes every level from the IEEE division (as the
    kernel before it did), not from the division-free quotient;
  * k5_8_per_sm: K5 on a grid of at most 8 blocks an SM, each warp
    looping over items, in place of one warp an item.
The variants compute wrong values (except k6_rows_3, k5_ieee_div and
k5_8_per_sm): they are timings only. Each is timed at the served shape
(N = 64 images x R = 5, L = 12, K = 40, E = 72, D = 768, 12 heads x 64, a
bf16 q over int8 caches): K6 (`beam_decode_attention_rowmajor_q`, e_cap =
E) at steps 1, 33 and 66 on one layer and at step 66 rotated over the
layers, and K5 (`write_gen_slot_chunk_q`) over new K/V sets and slots
rotated past the L2 (chip_smoke.quantising_write_call), in two rounds
(variants in order, then in reverse). An edit that no longer matches its
source exactly once stops the script. It prints the card's name and power
limit, then one JSON line per variant.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent
ATTN, QUANT = "csrc/decode_attention_async.cu", "csrc/cache_reorder.cu"
NO_SCORE = (ATTN, "        score_q8(land8(s), chunk_of(s));",
            "        land8(s);")
NO_VALUE = (ATTN, "      values_q8(land8(v0), chunk_of(v0), acc8);",
            "      land8(v0);")
VARIANTS = {
    "k6_no_score": [NO_SCORE],
    "k6_no_value": [NO_VALUE],
    "k6_no_compute": [NO_SCORE, NO_VALUE],
    "k6_rows_3": [
        (ATTN, "constexpr int kRowGroup = 16;",
         "constexpr int kRowGroup = 3;"),
        (ATTN, "a.R > 2 * kRowGroup)", "a.R > 32)"),
        ("ops/decode_attention.py", "ATTN_ROW_GROUP = 16",
         "ATTN_ROW_GROUP = 3")],
    "k5_no_levels": [(
        QUANT, "            w[i / 4] |= level_fma(x[i], s, inv) << "
               "(8 * (i % 4));", "            w[i / 4] |= 0u;")],
    "k5_ieee_div": [(
        QUANT, "            w[i / 4] |= level_fma(x[i], s, inv) << "
               "(8 * (i % 4));",
        "            w[i / 4] |= level_div(x[i], s) << (8 * (i % 4));")],
    "k5_8_per_sm": [(
        "ops/cache_reorder.py",
        "    return dict(blocks=-(-items // (QUANT_THREADS // 32)),",
        "    return dict(blocks=min(-(-items // (QUANT_THREADS // 32)), "
        "132 * 8),")],
}


def make_tree(name: str) -> Path:
    """_ablate/<name>/capdec_tpu_torch with the variant's edits."""
    root = HERE / "_ablate" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(HERE / "capdec_tpu_torch", root / "capdec_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for source, old, new in VARIANTS[name]:
        path = root / "capdec_tpu_torch" / source
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the edit no longer matches {source}: "
                             f"{old!r}")
        path.write_text(text.replace(old, new))
    return root


def load(name: str, root: Path):
    """(decode_attention, cache_reorder, _build) of the capdec_tpu_torch
    under `root`, imported as package `ablate_<name>`."""
    pkg_name = f"ablate_{name}"
    spec = importlib.util.spec_from_file_location(
        pkg_name, root / "capdec_tpu_torch" / "__init__.py",
        submodule_search_locations=[str(root / "capdec_tpu_torch")])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[pkg_name] = pkg
    spec.loader.exec_module(pkg)
    return tuple(importlib.import_module(f"{pkg_name}.ops.{m}")
                 for m in ("decode_attention", "cache_reorder", "_build"))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_int8_ablate: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from capdec_tpu_torch.ops import _build, cache_reorder
    from capdec_tpu_torch.ops import decode_attention as da

    versions = {"shipped": (da, cache_reorder, _build)}
    versions.update({name: load(name, make_tree(name)) for name in VARIANTS})
    with ThreadPoolExecutor(4) as pool:  # one nvcc a source in each build
        list(pool.map(lambda v: v[2].library(), versions.values()))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    N, R, L, K, E, D, H = (cs.MAIN[k] for k in ("N", "R", "L", "K", "E", "D",
                                                "H"))
    B, hd = N * R, D // H
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    rand = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(
        torch.bfloat16)
    lev = lambda *s: torch.randint(-127, 128, s, generator=gen,
                                   device="cuda", dtype=torch.int8)
    q, kn, vn = rand(B, 3 * D).split(D, dim=-1)
    pk, pv, gk, gv = rand(L, N, K, D), rand(L, N, K, D), lev(B, L, E, D), \
        lev(B, L, E, D)
    gks, gvs = (torch.rand(B, L, 1, E, generator=gen, device="cuda") * 3 / 127
                for _ in range(2))
    quant = (lev(B, L, E, D), lev(B, L, E, D),
             torch.rand(B, L, 1, E, generator=gen, device="cuda"),
             torch.rand(B, L, 1, E, generator=gen, device="cuda"),
             cs.new_kv_sets(gen, (B, L, D)))
    times = {name: [] for name in versions}
    for name in [*versions, *reversed(versions)]:
        da_v, cr_v, _ = versions[name]

        def k6(step, layer):
            return da_v.beam_decode_attention_rowmajor_q(
                q, kn, vn, pk, pv, gk, gv, gks, gvs, step, layer,
                beams_per_image=R, head_dim=hd, e_cap=E)
        t = {f"k6_{step}": cs.time_ms(lambda: k6(step, L // 2), iters=40)
             for step in (1, 33, 66)}
        t["k6_66_rotated"] = cs.time_ms(
            cs.rotating(lambda i: k6(66, i), L), iters=40)
        t["k5"] = cs.time_ms(cs.quantising_write_call(
            cr_v.write_gen_slot_chunk_q, *quant), iters=40)
        times[name].append(t)
    for name, runs in times.items():
        print(json.dumps({"variant": name, "ms": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

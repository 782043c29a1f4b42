#!/usr/bin/env python3
"""The beam engine's fork copy (K4, `copy_forked_rows_bounded`) on one
NVIDIA GPU, at the shapes the port serves, against another checkout's.

    python3 scripts/torch_fork_copy_steps.py [--tree DIR]

At four shapes of the bf16 row-major cache [N R, L, E, D] (R 5, L 12, E
72, 66 live slots; fork sources from chip_smoke._lane_src: each image
keeps its beam in a random half of its lanes, the others copy a kept one):
  * n1: one image (the demo, a lightly loaded server), D 768;
  * b320: batch 64 (the smoke's served paths), D 768;
  * tp2: batch 64 at a tp=2 rank's D 384;
  * b2560: batch 512 (serving at 512), D 768;
it times, by chip_smoke.time_ms, each version's K4 in turns (tree, this,
this, tree), and for this checkout also the empty kernel on its grid
(`floor_ms`), the plain version and the bound (each source row's live slots read once, each forked row's
written once, over 3.35 TB/s). Each timed call is first checked
bit-equal to the plain version. It prints the card's name and power
limit, then one JSON line.

`--tree DIR` loads the `capdec_tpu_torch` of another checkout (e.g. the
parent commit exported under a git-ignored directory) in the same
process, with its own kernel library (scripts/torch_attn_steps.load_tree).
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
R, L, E, COUNT = 5, 12, 72, 66
SHAPES = {"n1": (1, 768), "b320": (64, 768), "tp2": (64, 384),
          "b2560": (512, 768)}


def _module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def inputs(cs, N, D):
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    k, v = (torch.randn(N * R, L, E, D, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    src = cs._lane_src(torch.Generator().manual_seed(cs.SEED), N, R).to(
        "cuda")
    return k, v, src


def timed(cs, cr, k, v, src) -> float:
    """The version's K4, checked bit-equal to the plain version on
    copies, then timed in place."""
    fn = cr.copy_forked_rows_bounded
    want = cr.copy_forked_rows_bounded_plain(k.clone(), v.clone(), src,
                                             COUNT)
    got = fn(k.clone(), v.clone(), src, COUNT)
    torch.cuda.synchronize()
    assert torch.equal(got["k"], want["k"]) and \
        torch.equal(got["v"], want["v"]), "K4 differs from plain"
    return cs.time_ms(lambda: fn(k, v, src, COUNT))


def this_only(cs, cr, build, k, v, src) -> dict:
    """This checkout's K4 floor, plain version and bound."""
    B, _, _, D = k.shape
    plan = cr.fork_copy_plan(B, L, COUNT, D * 2)
    forked = src != torch.arange(B, device="cuda")
    forks, sources = int(forked.sum()), int(src[forked].unique().numel())
    b_ms, b_by = cs.bound_ms(2 * (sources + forks) * L * COUNT * D * 2, 0,
                             torch.bfloat16)
    return dict(plan=plan,
                floor_ms=cs.time_ms(cs.empty_grid_call(plan)),
                plain_ms=cs.time_ms(lambda: cr.copy_forked_rows_bounded_plain(
                    k, v, src, COUNT)),
                bound_ms=b_ms, bound_by=b_by, forks=forks, sources=sources)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tree", default=None,
                   help="another checkout whose capdec_tpu_torch is timed "
                        "beside this one's")
    p.add_argument("--shapes", default=",".join(SHAPES),
                   help="comma-separated subset of " + ",".join(SHAPES))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_fork_copy_steps: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    cs = _module("chip_smoke", HERE / "chip_smoke.py")
    from capdec_tpu_torch.ops import _build, cache_reorder
    from capdec_tpu_torch.utils.torch_setup import setup_torch

    setup_torch()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    versions = {"this": (cache_reorder, _build)}
    if args.tree:
        tas = _module("torch_attn_steps",
                      HERE / "scripts" / "torch_attn_steps.py")
        _, tbuild = tas.load_tree(args.tree)
        versions["tree"] = (importlib.import_module(
            "tree_capdec_tpu_torch.ops.cache_reorder"), tbuild)
    built = {}
    for name, (_, bld) in versions.items():
        so = bld.library_path()
        bld.library()
        log = so.with_suffix(".log")
        report = cs.ptxas_report(log.read_text()) if log.exists() else {}
        built[name] = dict(library=so.name, build_s=bld.build_seconds,
                           ptxas={n: r for n, r in report.items()
                                  if "copy_forked_rows_bounded" in n})
    order = ["tree", "this", "this", "tree"] if args.tree else ["this"]
    shapes = {}
    for shape in args.shapes.split(","):
        N, D = SHAPES[shape]
        k, v, src = inputs(cs, N, D)
        runs = {f"{name}_{i}": timed(cs, versions[name][0], k, v, src)
                for i, name in enumerate(order)}
        shapes[shape] = dict(N=N, D=D, ms=runs, this=this_only(
            cs, cache_reorder, _build, k, v, src))
        del k, v, src
        torch.cuda.empty_cache()
    print(smi)
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "tree": args.tree, "built": built,
                      "shapes": shapes}, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())

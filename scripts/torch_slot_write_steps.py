#!/usr/bin/env python3
"""The slot write of one decode step on one NVIDIA GPU: K3 (the row-major
cache of the beam paths, which K14 shares) and K13 (the seq-major cache
of path (d)), each reading the layers' K/V where they lie, against the
route that stacked them first.

    python3 scripts/torch_slot_write_steps.py [--tree DIR]

The step's K/V are the per-layer k and v thirds of [B, 3D] qkv buffers,
rotated with the slots past the L2 (chip_smoke.qkv_view_sets,
chip_smoke.views_write_call), bf16, L = 12 layers, E = 72 slots. K3 runs
at four shapes: B 320 (batch 64 x R 5), a tp=2 rank's D 384 at B 320,
B 2560 (batch 512) and B 5 (one image); K13 at path (d)'s L 12, B 64, D
768. For each version of `capdec_tpu_torch` it times, by
chip_smoke.time_ms:
  * `step_ms`: the slot write as that version's decode_step issues it:
    one launch from the views where the version's kernel takes them,
    else `torch.stack` of each side and the kernel on the stacked
    tensors;
  * `stacked_ms` (K13): `torch.stack` of each side and K13, whichever
    version;
  * `tensor_ms`: the kernel alone from stacked tensors
    (chip_smoke.slot_write_times, the smoke's measure before the
    kernels took views);
  * `floor_ms`: the empty kernel on that version's grid for the call
    (the parent's K3: a 128-thread block a (row, layer));
  * `host_us`: the host's µs per call of the step route (the median and
    the least of 7 runs of 200 calls enqueued while the card sleeps; on
    a host-bound path the step pays this);
and, for this checkout, K13 under blocks of 1, 2, 4 and 8 warps
(`warps_ms`), the plain versions, the library routes (stack, then
`index_copy_`) and the bounds. It prints the card's name and power
limit, then one JSON line.

`--tree DIR` also loads the `capdec_tpu_torch` of another checkout (e.g.
the parent commit exported under a git-ignored directory) in the same
process, with its own kernel library (scripts/torch_attn_steps.load_tree),
and times both on the same inputs by the same code, in turns (tree, this,
this, tree).
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent


def _module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_us(cs, fn, n=200, reps=7) -> dict:
    """Host µs per call of fn(), over `reps` runs of n calls each
    enqueued while the card sleeps, so that no call waits for the card:
    the median and the least of the runs (the host is shared, so single
    runs spread)."""
    fn()
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(cs.SLEEP_CYCLES)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        runs.append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    runs.sort()
    return dict(median=runs[len(runs) // 2], least=runs[0])


# K3's shapes: name -> (B rows, D)
K3_SHAPES = {"b320": (320, 768), "tp2": (320, 384), "b2560": (2560, 768),
             "b5": (5, 768)}


def _views(cr) -> bool:
    """Whether the version's slot writes take per-layer views (K13 since
    one version, K3 and K14 since a later one that plans them both)."""
    return hasattr(cr, "slot_write_plan")


def _floor(cs, build, blocks, threads) -> float:
    lib, stream = build.library(), build.stream(torch.device("cuda"))
    return cs.time_ms(lambda: build.check(lib.capdec_empty_grid(
        blocks, threads, stream), "empty_grid"))


def k3_times(cr, build, cs, gen, B, D) -> dict:
    """K3 of one version's cache_reorder `cr` at B rows of D, on inputs
    made from `gen`."""
    L, E = (cs.MAIN[k] for k in ("L", "E"))
    k, v = (torch.randn(B, L, E, D, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    sets = cs.qkv_view_sets(gen, L, B, D)
    k3 = cr.write_gen_slot_chunk
    views = _views(cr)
    step = cs.views_write_call(k3, k, v, sets,
                               stack_dim=None if views else 1)
    if views:
        plan = cr.slot_write_plan(L, B, D, 2,
                                  build.sm_count(torch.device("cuda")))
        blocks, threads = plan["blocks"], plan["threads"]
    else:  # one 128-thread block a (row, layer)
        blocks, threads = B * L, 128
    out = dict(takes_views=views, step_ms=cs.time_ms(step),
               host_us=host_us(cs, step),
               tensor_ms=cs.slot_write_times(
                   gen, k3, cr.write_gen_slot_chunk_plain, k, v,
                   (B, L, D))["ms"],
               floor_ms=_floor(cs, build, blocks, threads), sets=len(sets))
    del k, v, sets
    torch.cuda.empty_cache()
    return out


def k3_this(cr, cs, gen, B, D) -> dict:
    """This checkout's K3 beside its plain version, the library route and
    the bound."""
    L, E = (cs.MAIN[k] for k in ("L", "E"))
    k, v = (torch.randn(B, L, E, D, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    sets = cs.qkv_view_sets(gen, L, B, D)
    b_ms, b_by = cs.bound_ms(2 * 2 * L * B * D * 2, 0, torch.bfloat16)
    out = dict(
        plain_ms=cs.time_ms(cs.views_write_call(
            cr.write_gen_slot_chunk_plain, k, v, sets)),
        library_ms=cs.time_ms(cs.views_write_call(
            cs.stack_index_copy(E, dim=1), k, v, sets)),
        bound_ms=b_ms, bound_by=b_by)
    del k, v, sets
    torch.cuda.empty_cache()
    return out


def step_times(cr, build, cs, gen) -> dict:
    """K13's slot-write times of one version's cache_reorder `cr`, on
    inputs made from `gen`."""
    N, L, E, D = (cs.MAIN[k] for k in ("N", "L", "E", "D"))
    k, v = (torch.randn(L, N, E, D, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    sets = cs.qkv_view_sets(gen, L, N, D)
    k13 = cr.write_gen_slot_chunk_seqmajor
    step = cs.views_write_call(k13, k, v, sets)  # K13 took views first
    stacked = cs.views_write_call(k13, k, v, sets, stack_dim=0)
    out = dict(step_ms=cs.time_ms(step), stacked_ms=cs.time_ms(stacked),
               host_us=host_us(cs, step),
               stacked_host_us=host_us(cs, stacked),
               tensor_ms=cs.slot_write_times(
                   gen, k13, cr.write_gen_slot_chunk_seqmajor_plain, k, v,
                   (L, N, D))["ms"], sets=len(sets))
    del k, v, sets
    torch.cuda.empty_cache()
    return out


def this_only(cr, build, cs, gen) -> dict:
    """This checkout's K13 from views beside the floor, other block
    sizes, its plain version, the library route and the bound."""
    N, L, E, D = (cs.MAIN[k] for k in ("N", "L", "E", "D"))
    k, v = (torch.randn(L, N, E, D, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    sets = cs.qkv_view_sets(gen, L, N, D)
    k13 = cr.write_gen_slot_chunk_seqmajor
    plan = cr.slot_write_plan(L, N, D, 2,
                              build.sm_count(torch.device("cuda")))
    warps_ms, shipped = {}, cr.SLOT_WARPS
    try:
        for w in (1, 2, 4, 8):
            cr.SLOT_WARPS = w
            warps_ms[w] = cs.time_ms(cs.views_write_call(k13, k, v, sets))
    finally:
        cr.SLOT_WARPS = shipped
    b_ms, b_by = cs.bound_ms(2 * 2 * L * N * D * 2, 0, torch.bfloat16)
    return dict(
        plan=plan, views_ms=cs.time_ms(cs.views_write_call(k13, k, v,
                                                           sets)),
        floor_ms=cs.time_ms(cs.empty_grid_call(plan)), warps_ms=warps_ms,
        plain_ms=cs.time_ms(cs.views_write_call(
            cr.write_gen_slot_chunk_seqmajor_plain, k, v, sets)),
        library_ms=cs.time_ms(cs.views_write_call(
            cs.stack_index_copy(E), k, v, sets)),
        bound_ms=b_ms, bound_by=b_by)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tree", default=None,
                   help="another checkout whose capdec_tpu_torch is timed "
                        "beside this one's")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_slot_write_steps: no CUDA device", file=sys.stderr)
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
                                  if "write_gen_slot" in n})
    order = ["tree", "this", "this", "tree"] if args.tree else ["this"]
    seeded = lambda: torch.Generator(device="cuda").manual_seed(cs.SEED)
    k3 = {}
    for shape, (B, D) in K3_SHAPES.items():
        k3[shape] = {f"{name}_{i}": k3_times(*versions[name], cs, seeded(),
                                             B, D)
                     for i, name in enumerate(order)}
        k3[shape]["this"] = k3_this(cache_reorder, cs, seeded(), B, D)
    times = {f"{name}_{i}": step_times(*versions[name], cs, seeded())
             for i, name in enumerate(order)}
    this = this_only(cache_reorder, _build, cs, seeded())
    print(smi)
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "tree": args.tree, "built": built,
                      "k3": k3, "steps": times, "this": this},
                     default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The seq-major slot write of one decode step (K13, path (d)) on one
NVIDIA GPU: K13 reading the layers' K/V where they lie against the route
that stacked them first.

    python3 scripts/torch_slot_write_steps.py [--tree DIR]

At path (d)'s shape (L = 12 layers, B = 64 rows, E = 72 slots, D = 768,
bf16) the step's K/V are the per-layer k and v thirds of [B, 3D] qkv
buffers, rotated with the slots past the L2 (chip_smoke.qkv_view_sets,
chip_smoke.seqmajor_write_call). For each version of `capdec_tpu_torch`
it times, by chip_smoke.time_ms:
  * `step_ms`: the slot write as that version's decode_step issues it:
    one K13 launch from the views where its K13 takes them, else
    `torch.stack` of each side and K13 on the stacked tensors;
  * `stacked_ms`: `torch.stack` of each side and K13, whichever version;
  * `k13_tensor_ms`: K13 alone from [L, B, D] tensors
    (chip_smoke.slot_write_times, the smoke's measure before K13 took
    views);
  * `host_us`: the host's µs per call of the step route (the median and
    the least of 7 runs of 200 calls enqueued while the card sleeps; on
    a host-bound path the step pays this), and `stacked_host_us` that
    of the stack route;
and, for this checkout, `views_ms` (K13 from the views), the empty kernel
on K13's grid (`floor_ms`, the least one launch of that grid costs on
this timer), K13 under blocks of 1, 2, 4 and 8 warps (`warps_ms`), the
plain version, the library route (stack, then `index_copy_`) and the
bound. It prints the card's name and power limit, then one JSON line.

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


def step_times(cr, cs, gen) -> dict:
    """The slot-write times of one version's cache_reorder `cr`, on
    inputs made from `gen`."""
    N, L, E, D = (cs.MAIN[k] for k in ("N", "L", "E", "D"))
    k, v = (torch.randn(L, N, E, D, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    sets = cs.qkv_view_sets(gen, L, N, D)
    k13 = cr.write_gen_slot_chunk_seqmajor
    views = hasattr(cr, "seqmajor_write_plan")  # K13 takes the views
    step = cs.seqmajor_write_call(k13, k, v, sets, stack=not views)
    stacked = cs.seqmajor_write_call(k13, k, v, sets, stack=True)
    out = dict(takes_views=views, step_ms=cs.time_ms(step),
               stacked_ms=cs.time_ms(stacked), host_us=host_us(cs, step),
               stacked_host_us=host_us(cs, stacked),
               k13_tensor_ms=cs.slot_write_times(
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
    plan = cr.seqmajor_write_plan(L, N, D, 2,
                                  build.sm_count(torch.device("cuda")))
    warps_ms, shipped = {}, cr.SEQ_WARPS
    try:
        for w in (1, 2, 4, 8):
            cr.SEQ_WARPS = w
            warps_ms[w] = cs.time_ms(cs.seqmajor_write_call(k13, k, v, sets))
    finally:
        cr.SEQ_WARPS = shipped
    b_ms, b_by = cs.bound_ms(2 * 2 * L * N * D * 2, 0, torch.bfloat16)
    return dict(
        plan=plan, views_ms=cs.time_ms(cs.seqmajor_write_call(k13, k, v,
                                                              sets)),
        floor_ms=cs.time_ms(cs.empty_grid_call(plan)), warps_ms=warps_ms,
        plain_ms=cs.time_ms(cs.seqmajor_write_call(
            cr.write_gen_slot_chunk_seqmajor_plain, k, v, sets)),
        library_ms=cs.time_ms(cs.seqmajor_write_call(
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
                                  if "write_gen_slot_seqmajor" in n})
    order = ["tree", "this", "this", "tree"] if args.tree else ["this"]
    times = {}
    for i, name in enumerate(order):
        times[f"{name}_{i}"] = step_times(
            versions[name][0], cs,
            torch.Generator(device="cuda").manual_seed(cs.SEED))
    this = this_only(cache_reorder, _build, cs,
                     torch.Generator(device="cuda").manual_seed(cs.SEED))
    print(smi)
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "tree": args.tree, "built": built,
                      "steps": times, "this": this}, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())

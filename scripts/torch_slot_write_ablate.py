#!/usr/bin/env python3
"""Where K13's time goes: the seq-major slot write with one part changed
or taken out, timed beside the kernel as shipped, on one NVIDIA GPU.

    python3 scripts/torch_slot_write_ablate.py [--tree DIR]

Each variant is a copy of `capdec_tpu_torch` under `_ablate/<name>/`
(git-ignored) with one edit, built into its own library (all builds run
together) and loaded into this process as a package of its own name:
  * params_16: the parameter struct sized for 16 layers (384 bytes) in
    place of 64 (1536 bytes);
  * static_layer: every item's source pointer and row stride read from
    layer 0's entries at a fixed offset (with row l B + b: the same
    addresses for the [L, B, 3D] buffers timed here), so that no lane
    indexes the parameter struct by a computed layer;
  * no_store: loads kept, the stores taken out (a store only for a
    word no input holds);
  * no_load: the stores kept, each word made in registers;
  * kv_pair: one warp a (layer, row) takes both its K and its V row (six
    loads a lane in flight at D 768 bf16, half the warps), in blocks of
    two warps (the shipped grid's 384 blocks);
  * lane_word: one warp a 32-word piece of an item's row, one word a
    lane (three warps an item at D 768 bf16), in blocks of eight warps;
  * scalar_srcs: the sources as four scalar parameters (layer 0's K and V
    bases and row strides, row l B + b: the same addresses for the
    buffers timed here) in place of the struct, as K13 took its
    sources before;
  * row_block: the grid of K13 before it took views, one 128-thread
    block a (row, layer), a thread taking word i of the K row and of the
    V row (plain loads), with the sources read from the struct;
  * plain_loads: `ld.global` in place of `ld.global.nc`;
  * store_cs: the stores with the evict-first hint (`st.global.cs`);
  * floor_struct: the empty kernel on K13's grid given the 1536-byte
    struct by value.
no_store and no_load compute wrong values: they are timings only. Each
is timed at path (d)'s shape (L = 12, B = 64, E = 72, D = 768, bf16)
from per-layer views of qkv buffers rotated past the L2
(chip_smoke.qkv_view_sets, chip_smoke.seqmajor_write_call), with the
empty kernel on its grid, in two rounds (variants in order, then in
reverse), and the empty kernel on grids of 1, 132, 384 and 1536 blocks.
`--tree DIR` also times another checkout's K13 from [L, B, D]
tensors (e.g. the parent's, which takes no views) beside this one's in
the same rounds. An edit that no longer matches its source as often as
it expects (once, unless it says) stops the script. It prints the card's
name and power limit, then one JSON line per variant.
"""
from __future__ import annotations

import argparse
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
CU = "csrc/cache_reorder.cu"
PLAN = "ops/cache_reorder.py"
# K13's item loop as shipped, and three other cuts of the same copy
LOOP = """  for (int it = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       it < items; it += warps) {
    const int row = it >> 1;  // l·B + b
"""
KV_PAIR = """\
  for (int it = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       it < items / 2; it += warps) {
    const int l = it / B, b = it - l * B;
    const uint4* sk = src.k[l] + (size_t)b * src.k_row16[l];
    const uint4* sv = src.v[l] + (size_t)b * src.v_row16[l];
    uint4* dk = k + ((size_t)it * E + step) * row16;
    uint4* dv = v + ((size_t)it * E + step) * row16;
    for (int base = lane; base < row16; base += 32 * W) {
      uint4 wk[W], wv[W];
#pragma unroll
      for (int c = 0; c < W; ++c)
        if (base + 32 * c < row16) {
          wk[c] = __ldg(sk + base + 32 * c);
          wv[c] = __ldg(sv + base + 32 * c);
        }
#pragma unroll
      for (int c = 0; c < W; ++c)
        if (base + 32 * c < row16) {
          dk[base + 32 * c] = wk[c];
          dv[base + 32 * c] = wv[c];
        }
    }
  }
  for (int it = items; it < items; it += warps) {
    const int row = it >> 1;  // l·B + b
"""
LANE_WORD = """  const int chunks = (row16 + 31) / 32;
  for (int jt = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       jt < items * chunks; jt += warps) {
    const int it = jt / chunks, i = (jt - it * chunks) * 32 + lane;
    const int row = it >> 1, l = row / B, b = row - l * B;
    const bool is_v = it & 1;
    const uint4* s = is_v ? src.v[l] + (size_t)b * src.v_row16[l]
                          : src.k[l] + (size_t)b * src.k_row16[l];
    uint4* d = (is_v ? v : k) + ((size_t)row * E + step) * row16;
    if (i < row16) d[i] = __ldg(s + i);
  }
  for (int it = items; it < items; it += warps) {
    const int row = it >> 1;  // l·B + b
"""
ROW_BLOCK = """  {
    const int l = blockIdx.y, b = blockIdx.x, row = l * B + b;
    const uint4* sk = src.k[l] + (size_t)b * src.k_row16[l];
    const uint4* sv = src.v[l] + (size_t)b * src.v_row16[l];
    uint4* dk = k + ((size_t)row * E + step) * row16;
    uint4* dv = v + ((size_t)row * E + step) * row16;
    for (int i = threadIdx.x; i < row16; i += blockDim.x) {
      dk[i] = sk[i];
      dv[i] = sv[i];
    }
  }
  for (int it = items; it < items; it += warps) {
    const int row = it >> 1;  // l·B + b
"""
# the source row of an item, and a lane's loads, as shipped
SOURCE = ("    const uint4* s = is_v ? src.v[l] + (size_t)b * src.v_row16[l]\n"
          "                          : src.k[l] + (size_t)b * "
          "src.k_row16[l];")
LOAD = ("        if (base + 32 * c < row16) w[c] = __ldg(s + base + 32 * "
        "c);")
VARIANTS = {
    "params_16": [
        (CU, "constexpr int kSeqMaxLayers = 64;",
         "constexpr int kSeqMaxLayers = 16;"),
        ("ops/_build.py", "SEQ_MAX_LAYERS = 64", "SEQ_MAX_LAYERS = 16")],
    "static_layer": [(
        CU, SOURCE,
        "    const uint4* s = is_v ? src.v[0] + (size_t)row * "
        "src.v_row16[0]\n                          : src.k[0] + "
        "(size_t)row * src.k_row16[0];")],
    "no_store": [(
        CU, "        if (base + 32 * c < row16) d[base + 32 * c] = w[c];",
        "        if (base + 32 * c < row16 && w[c].x == 0x7fc00001u)\n"
        "          d[base + 32 * c] = w[c];")],
    "no_load": [(
        CU, LOAD,
        "        if (base + 32 * c < row16) w[c] = make_uint4(it, base, c, "
        "0);")],
    "kv_pair": [
        (CU, LOOP, KV_PAIR), (PLAN, "SEQ_WARPS = 4", "SEQ_WARPS = 2"),
        (PLAN, "                blocks=-(-items // warps), items=items,",
         "                blocks=-(-items // (2 * warps)), items=items,")],
    "lane_word": [
        (CU, LOOP, LANE_WORD),
        (PLAN, "SEQ_WARPS = 4", "SEQ_WARPS = 8"),
        (PLAN, "                blocks=-(-items // warps), items=items,",
         "                blocks=-(-items * -(-row16 // 32) // warps), "
         "items=items,")],
    "scalar_srcs": [
        (CU, "const __grid_constant__ SeqmajorSources src, int B,",
         "const uint4* __restrict__ k0, const uint4* __restrict__ v0, "
         "int rk, int rv, int B,"),
        (CU, SOURCE,
         "    const uint4* s = is_v ? v0 + (size_t)row * rv : k0 + "
         "(size_t)row * rk;"),
        (CU, "k4, v4, *src, B, E, step, r, n);",
         "k4, v4, src->k[0], src->v[0], src->k_row16[0], src->v_row16[0], B, "
         "E, step, r, n);", 4)],
    "row_block": [
        (CU, LOOP, ROW_BLOCK),
        (CU, "  const dim3 grid(blocks), block(32 * warps);",
         "  const dim3 grid(B, L), block(128);")],
    "plain_loads": [(
        CU, LOAD,
        "        if (base + 32 * c < row16) w[c] = s[base + 32 * c];")],
    "store_cs": [(
        CU, "        if (base + 32 * c < row16) d[base + 32 * c] = w[c];",
        "        if (base + 32 * c < row16) __stcs(d + base + 32 * c, "
        "w[c]);")],
    "floor_struct": [
        (CU, "__global__ void empty_grid() {}",
         "__global__ void empty_grid(const __grid_constant__ SeqmajorSources) "
         "{}"),
        (CU, "  capdec::empty_grid<<<blocks, threads, 0, stream>>>();",
         "  capdec::empty_grid<<<blocks, threads, 0, stream>>>(\n"
         "      capdec::SeqmajorSources{});")],
}


def make_tree(name: str) -> Path:
    """_ablate/<name>/capdec_tpu_torch with the variant's edits."""
    root = HERE / "_ablate" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(HERE / "capdec_tpu_torch", root / "capdec_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for source, old, new, *times in VARIANTS[name]:
        path = root / "capdec_tpu_torch" / source
        text = path.read_text()
        if text.count(old) != (times or [1])[0]:
            raise SystemExit(f"{name}: the edit no longer matches {source}: "
                             f"{old!r}")
        path.write_text(text.replace(old, new))
    return root


def load(pkg_name: str, root: Path):
    """(cache_reorder, _build) of the capdec_tpu_torch under `root`,
    imported as package `pkg_name`."""
    spec = importlib.util.spec_from_file_location(
        pkg_name, root / "capdec_tpu_torch" / "__init__.py",
        submodule_search_locations=[str(root / "capdec_tpu_torch")])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[pkg_name] = pkg
    spec.loader.exec_module(pkg)
    return tuple(importlib.import_module(f"{pkg_name}.ops.{m}")
                 for m in ("cache_reorder", "_build"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tree", default=None,
                   help="another checkout whose K13 is timed from tensors")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_slot_write_ablate: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from capdec_tpu_torch.ops import _build, cache_reorder

    versions = {"shipped": (cache_reorder, _build)}
    versions.update({name: load(f"ablate_{name}", make_tree(name))
                     for name in VARIANTS})
    if args.tree:
        versions["tree"] = load("tree_capdec_tpu_torch",
                                Path(args.tree).resolve())
    with ThreadPoolExecutor(4) as pool:  # one nvcc a source in each build
        list(pool.map(lambda v: v[1].library(), versions.values()))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    N, L, E, D = (cs.MAIN[k] for k in ("N", "L", "E", "D"))
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    k, v = (torch.randn(L, N, E, D, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    sets = cs.qkv_view_sets(gen, L, N, D)
    stacked = [tuple(torch.stack(side) for side in s) for s in sets]
    plan = cache_reorder.seqmajor_write_plan(L, N, D, 2, _build.sm_count(
        torch.device("cuda")))
    stream = _build.stream(torch.device("cuda"))
    times = {name: [] for name in versions}
    for name in [*versions, *reversed(versions)]:
        cr, bld = versions[name]
        lib = bld.library()
        floor = lambda: bld.check(lib.capdec_empty_grid(
            plan["blocks"], plan["threads"], stream), "empty_grid")
        t = {}
        if name != "tree":  # the views and the floor: this checkout's
            t["floor_ms"] = cs.time_ms(floor, iters=40)
            t["views_ms"] = cs.time_ms(cs.seqmajor_write_call(
                cr.write_gen_slot_chunk_seqmajor, k, v, sets), iters=40)
        t["tensors_ms"] = cs.time_ms(cs.seqmajor_write_call(
            cr.write_gen_slot_chunk_seqmajor, k, v, stacked), iters=40)
        times[name].append(t)
    lib = _build.library()  # the floor against the grid's size
    floors = {n: cs.time_ms(lambda n=n: _build.check(lib.capdec_empty_grid(
        n, plan["threads"], stream), "empty_grid"), iters=40)
        for n in (1, 132, 384, 1536)}
    print(json.dumps({"floor_ms_by_blocks": floors}))
    for name, runs in times.items():
        print(json.dumps({"variant": name, "ms": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

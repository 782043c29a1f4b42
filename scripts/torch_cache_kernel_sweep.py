#!/usr/bin/env python3
"""K3 (the row-major slot write, with K13 on the same kernel) and K4 (the
bounded fork copy) under other launch plans and kernel variants, on one
NVIDIA GPU, beside the shipped ones and another checkout's.

    python3 scripts/torch_cache_kernel_sweep.py [--tree DIR]

Each variant is a copy of `capdec_tpu_torch` under `_ablate/<name>/`
(git-ignored) with one edit, built in parallel with the others and
loaded as a package of its own name; an edit that no longer matches its
source stops the script. Every timed call is first checked bit-equal to
the plain version; the timings only decide the designs.

K4, at the shapes of scripts/torch_fork_copy_steps.py (n1, b320, tp2,
b2560), the shipped fork-major kernel (4 words a lane) and the variants
  * source_major: a warp a group of 5 rows (an image's lanes at R 5;
    the grid's other warps exit at once) loads each distinct source's
    tile among the group's forks once and stores it to each of them;
  * fork_w1, fork_w2, fork_w8: 1, 2 and 8 words a lane;
and, with `--tree`, that checkout's K4 (as the beam engine calls it).

K3 from per-layer views of qkv buffers rotated past the L2 (the step's
write as decode_step issues it; chip_smoke.views_write_call) at B 5,
320, 2560 and a tp=2 rank's D 384 at B 320 (L 12, E 72, bf16), and K13
at path (d)'s L 12, B 64 (`k13`): the shipped kernel (a warp a (row,
K|V) of layer blockIdx.y) under blocks of 1, 2 and 8 warps, and the
variants
  * loop_grid: one grid axis over every (layer, row, K|V) item, the layer
    and row from a division (K13's grid before this kernel served K3);
  * kv_pair: one warp a (layer, row) takes both its K and its V row
    (2 W words a lane in flight, half the warps);
  * row_block: the grid of K3 before it took views, one 128-thread block
    a (row, layer), a thread taking word i of the K row and of the V row;
  * plain_loads: `ld.global` in place of `ld.global.nc`;
  * static_layer: every item's source from layer 0's struct entries at
    fixed offsets, row l B + b (the same addresses for the [L, B, 3D]
    qkv buffers timed here), so that no lane indexes the struct by layer;
  * scalar_srcs: the sources as four scalar parameters (layer 0's K and V
    bases and row strides, row l B + b) in place of the struct;
  * params_16: the struct sized for 16 layers (384 bytes) in place of 64
    (1536 bytes);
and, with `--tree`, that checkout's K3 (from [B, L, D] tensors stacked
beforehand, outside the timing, where it takes no views) and K13. The
versions are timed in two rounds (in order, then in reverse). It prints
the card's name and power limit, then one JSON line per part.
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
R, L, E, COUNT = 5, 12, 72, 66
FORK_SHAPES = {"n1": (1, 768), "b320": (64, 768), "tp2": (64, 384),
               "b2560": (512, 768)}
SLOT_SHAPES = {"b5": (5, 768), "b320": (320, 768), "tp2": (320, 384),
               "b2560": (2560, 768), "k13": (64, 768)}
# the slot write's body as shipped, and its parts that variants edit
HEAD = """  const int l = blockIdx.y;
  const int j = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (j >= 2 * B) return;
  const int b = j >> 1, lane = threadIdx.x & 31;
  const bool is_v = j & 1;
"""
SOURCE = """  const uint4* s = is_v ? src.v[l] + (size_t)b * src.v_row16[l]
                        : src.k[l] + (size_t)b * src.k_row16[l];
"""
BODY = HEAD + SOURCE + """\
  const size_t slot_row = kRowMajor ? (size_t)b * L + l : (size_t)l * B + b;
  uint4* d = (is_v ? v : k) + (slot_row * E + step) * row16;
  for (int base = lane; base < row16; base += 32 * W) {
    uint4 w[W];
#pragma unroll
    for (int c = 0; c < W; ++c)
      if (base + 32 * c < row16) w[c] = __ldg(s + base + 32 * c);
#pragma unroll
    for (int c = 0; c < W; ++c)
      if (base + 32 * c < row16) d[base + 32 * c] = w[c];
  }
}
"""
LOAD = "      if (base + 32 * c < row16) w[c] = __ldg(s + base + 32 * c);"
GRID = "  const dim3 grid(blocks, L), block(32 * warps);"
LOOP_GRID = """  const int it = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (it >= 2 * L * B) return;
  const int row = it >> 1;  // l·B + b
  const int l = row / B, b = row - l * B, lane = threadIdx.x & 31;
  const bool is_v = it & 1;
"""
KV_PAIR = """\
  const int l = blockIdx.y;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;
  const int lane = threadIdx.x & 31;
  const uint4* sk = src.k[l] + (size_t)b * src.k_row16[l];
  const uint4* sv = src.v[l] + (size_t)b * src.v_row16[l];
  const size_t slot_row = kRowMajor ? (size_t)b * L + l : (size_t)l * B + b;
  uint4* dk = k + (slot_row * E + step) * row16;
  uint4* dv = v + (slot_row * E + step) * row16;
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
"""
ROW_BLOCK = """\
  const int b = blockIdx.x, l = blockIdx.y;
  const uint4* sk = src.k[l] + (size_t)b * src.k_row16[l];
  const uint4* sv = src.v[l] + (size_t)b * src.v_row16[l];
  const size_t slot_row = kRowMajor ? (size_t)b * L + l : (size_t)l * B + b;
  uint4* dk = k + (slot_row * E + step) * row16;
  uint4* dv = v + (slot_row * E + step) * row16;
  for (int i = threadIdx.x; i < row16; i += blockDim.x) {
    const uint4 a = __ldg(sk + i), c = __ldg(sv + i);
    dk[i] = a;
    dv[i] = c;
  }
}
"""
FORK = """  const long b = (rest >> 1) / L;
  const int64_t s = src[b];
  if (s == b) return;  // the row kept its lane: nothing moves
  const long w0 = tile * 32 * W + (threadIdx.x & 31);  // the lane's word
  const long slab = ((rest >> 1) % L) * E * row16 + w0;
  uint4* cache = (rest & 1) ? v : k;
  const uint4* from = cache + s * L * E * row16 + slab;
  uint4* to = cache + b * L * E * row16 + slab;
  uint4 w[W];
#pragma unroll
  for (int c = 0; c < W; ++c)
    if (w0 + 32 * c < slab16) w[c] = __ldg(from + 32 * c);
#pragma unroll
  for (int c = 0; c < W; ++c)
    if (w0 + 32 * c < slab16) to[32 * c] = w[c];
}
"""
SOURCE_MAJOR = """  const long first = (rest >> 1) / L, B = items / (2L * L * tiles);
  if (first % 5) return;  // one warp a group of 5 rows
  const int lane = threadIdx.x & 31;
  const long r = first + lane;
  const int64_t s = lane < 5 && r < B ? src[r] : r;
  const bool fork = s != r;
  const long w0 = tile * 32 * W + lane;
  const long slab = ((rest >> 1) % L) * E * row16 + w0;
  uint4* cache = (rest & 1) ? v : k;
  unsigned todo = __ballot_sync(0xffffffffu, fork);
  while (todo) {
    const int64_t from = __shfl_sync(0xffffffffu, s, __ffs(todo) - 1);
    const unsigned same = __ballot_sync(0xffffffffu, fork && s == from);
    todo &= ~same;
    const uint4* sp = cache + from * L * E * row16 + slab;
    uint4 w[W];
#pragma unroll
    for (int c = 0; c < W; ++c)
      if (w0 + 32 * c < slab16) w[c] = __ldg(sp + 32 * c);
    for (unsigned m = same; m; m &= m - 1) {
      uint4* to = cache + (first + __ffs(m) - 1) * L * E * row16 + slab;
#pragma unroll
      for (int c = 0; c < W; ++c)
        if (w0 + 32 * c < slab16) to[32 * c] = w[c];
    }
  }
}
"""
VARIANTS = {
    "loop_grid": [
        (CU, HEAD, LOOP_GRID),
        (CU, GRID, "  const dim3 grid((2 * L * B + warps - 1) / warps), "
                   "block(32 * warps);")],
    "kv_pair": [
        (CU, BODY, KV_PAIR),
        (CU, GRID, "  const dim3 grid((B + warps - 1) / warps, L), "
                   "block(32 * warps);")],
    "row_block": [(CU, BODY, ROW_BLOCK),
                  (CU, GRID, "  const dim3 grid(B, L), block(128);")],
    "plain_loads": [(CU, LOAD, "      if (base + 32 * c < row16) w[c] = "
                               "s[base + 32 * c];")],
    "static_layer": [(CU, SOURCE, """\
  const uint4* s = is_v ? src.v[0] + ((size_t)l * B + b) * src.v_row16[0]
                        : src.k[0] + ((size_t)l * B + b) * src.k_row16[0];
""")],
    "scalar_srcs": [
        (CU, "const __grid_constant__ LayerSources src, int L, int B,",
         "const uint4* __restrict__ k0, const uint4* __restrict__ v0, "
         "int rk, int rv, int L, int B,"),
        (CU, SOURCE, """\
  const uint4* s = is_v ? v0 + ((size_t)l * B + b) * rv
                        : k0 + ((size_t)l * B + b) * rk;
"""),
        (CU, "k4, v4, *src, L, B, E, step, r);",
         "k4, v4, src->k[0], src->v[0], src->k_row16[0], src->v_row16[0], L, "
         "B, E, step, r);", 4)],
    "params_16": [
        (CU, "constexpr int kSlotMaxLayers = 64;",
         "constexpr int kSlotMaxLayers = 16;"),
        ("ops/_build.py", "SLOT_MAX_LAYERS = 64", "SLOT_MAX_LAYERS = 16")],
    "source_major": [(CU, FORK, SOURCE_MAJOR)],
    **{f"fork_w{w}": [(CU, "constexpr int kForkWords = 4;",
                       f"constexpr int kForkWords = {w};"),
                      (PLAN, "FORK_W = 4", f"FORK_W = {w}")]
       for w in (1, 2, 8)},
}
FORK_VARIANTS = ("source_major", "fork_w1", "fork_w2", "fork_w8")


def _module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    imported as package `pkg_name` (its _build builds that tree's sources
    into that tree's library)."""
    spec = importlib.util.spec_from_file_location(
        pkg_name, root / "capdec_tpu_torch" / "__init__.py",
        submodule_search_locations=[str(root / "capdec_tpu_torch")])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[pkg_name] = pkg
    spec.loader.exec_module(pkg)
    return tuple(importlib.import_module(f"{pkg_name}.ops.{m}")
                 for m in ("cache_reorder", "_build"))


def fork_sweep(cs, versions) -> dict:
    """K4 of each version at each shape."""
    tfs = _module("torch_fork_copy_steps",
                  HERE / "scripts" / "torch_fork_copy_steps.py")
    names = ["shipped", *FORK_VARIANTS] + (["tree"] if "tree" in versions
                                           else [])
    out = {}
    for shape, (N, D) in FORK_SHAPES.items():
        k, v, src = tfs.inputs(cs, N, D)
        res = {name: [] for name in names}
        for name in [*names, *reversed(names)]:
            res[name].append(tfs.timed(cs, versions[name][0], k, v, src))
        out[shape] = res
        del k, v, src
        torch.cuda.empty_cache()
    return out


def slot_inputs(cs, B, D, seq):
    """Caches ([L, B, E, D] for K13, else [B, L, E, D]), qkv view sets
    rotated past the L2 and the same K/V stacked."""
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    shape = (L, B, E, D) if seq else (B, L, E, D)
    k, v = (torch.randn(*shape, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    sets = cs.qkv_view_sets(gen, L, B, D)
    stacked = [tuple(torch.stack(s, dim=0 if seq else 1) for s in pair)
               for pair in sets]
    return k, v, sets, stacked


def slot_ms(cs, cr, k, v, sets, stacked, seq) -> float:
    """The version's K3 (K13 with `seq`) from the views where it takes
    them, else from the same K/V stacked beforehand; checked against the
    plain version."""
    if seq:
        fn, plain = (cr.write_gen_slot_chunk_seqmajor,
                     cr.write_gen_slot_chunk_seqmajor_plain)
    else:
        fn, plain = cr.write_gen_slot_chunk, cr.write_gen_slot_chunk_plain
    data = sets if seq or hasattr(cr, "slot_write_plan") else stacked
    want = plain(k.clone(), v.clone(), *data[0], 3)
    got = fn(k.clone(), v.clone(), *data[0], 3)
    torch.cuda.synchronize()
    assert torch.equal(got["k"], want["k"]) and \
        torch.equal(got["v"], want["v"])
    return cs.time_ms(cs.views_write_call(fn, k, v, data), iters=40)


def slot_plans(cs, cr, k, v, sets, stacked, seq) -> dict:
    """The shipped K3 (K13) under blocks of 1, 2 and 8 warps."""
    out, shipped = {}, cr.SLOT_WARPS
    try:
        for w in (1, 2, 8):
            cr.SLOT_WARPS = w
            out[f"warps{w}"] = slot_ms(cs, cr, k, v, sets, stacked, seq)
    finally:
        cr.SLOT_WARPS = shipped
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tree", default=None,
                   help="another checkout whose K3 is timed beside")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_cache_kernel_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    cs = _module("chip_smoke", HERE / "chip_smoke.py")
    from capdec_tpu_torch.ops import _build, cache_reorder

    versions = {"shipped": (cache_reorder, _build)}
    versions.update({name: load(f"sweep_{name}", make_tree(name))
                     for name in VARIANTS})
    if args.tree:
        versions["tree"] = load("tree_capdec_tpu_torch",
                                    Path(args.tree).resolve())
    with ThreadPoolExecutor(4) as pool:  # one nvcc a source in each build
        list(pool.map(lambda v: v[1].library(), versions.values()))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    print(json.dumps({"k4": fork_sweep(cs, versions)}))
    slot_versions = [n for n in versions if n not in FORK_VARIANTS]
    for shape, (B, D) in SLOT_SHAPES.items():
        seq = shape == "k13"
        k, v, sets, stacked = slot_inputs(cs, B, D, seq)
        times = {name: [] for name in slot_versions}
        for name in [*slot_versions, *reversed(slot_versions)]:
            times[name].append(slot_ms(cs, versions[name][0], k, v, sets,
                                       stacked, seq))
        plans = slot_plans(cs, cache_reorder, k, v, sets, stacked, seq)
        floor = cs.time_ms(cs.empty_grid_call(cache_reorder.slot_write_plan(
            L, B, D, 2, _build.sm_count(torch.device("cuda")))), iters=40)
        print(json.dumps({"k3": shape, "variants": times, "plans": plans,
                          "floor_ms": floor}))
        del k, v, sets, stacked
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

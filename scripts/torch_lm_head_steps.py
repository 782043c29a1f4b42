#!/usr/bin/env python3
"""Times of the bf16 K1 kernel (fused LM head, top-R and logsumexp) at
the served shapes, on one NVIDIA GPU, beside another checkout's K1.

    python3 scripts/torch_lm_head_steps.py [--tree DIR] [--shapes a,b]

At the beam paths' shape (B = 320 rows, R = 5), greedy's (B = 64,
R = 1) and the offline cells' (B = 2560, R = 5), with GPT-2 124M's
V = 50257 and D = 768; at the Kimi-VL-A3B cell's untied head (B = 2560,
R = 5, V = 163840, D = 2048); and at GPT-2 medium's and large's widths
(D = 1024, 1280; B = 2560, R = 5, V = 50257), all in bf16, it times
`lm_head_topk` (device time of back-to-back calls, chip_smoke.time_ms),
the host time of one call (the wrapper, its plan and the launch, without
waiting for the card), the cuBLAS product alone (`torch.matmul(h, w.t())`,
the logits written) and the bound (the larger of the bytes over 3.35
TB/s and the operations over 989 TFLOP/s). It checks each version's
top-R indices against the plain version on operands whose sums are exact
in f32. It prints the card's name and power limit, then one JSON line
with the registers and spills of every K1 instance, each shape's plan
and each version's times. `--shapes` times only the named shapes.

`--tree DIR` also loads the `capdec_tpu_torch` of another checkout (e.g.
an exported parent commit) in the same process, as a package of another
name with its own kernel library (scripts/torch_attn_steps.load_tree),
and times both versions on the same inputs by the same code, in turns
(tree, this, this, tree).
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
# key: (B rows, R, V, D)
SHAPES = {"beam": (320, 5, 50257, 768), "greedy_r1": (64, 1, 50257, 768),
          "serve512": (2560, 5, 50257, 768),
          "kimi_d2048": (2560, 5, 163840, 2048),
          "d1024": (2560, 5, 50257, 1024), "d1280": (2560, 5, 50257, 1280)}
HOST_CALLS = 200


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_us(fn) -> float:
    """Host microseconds of one call, the card kept busy so that no call
    waits for it (the launches queue)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / HOST_CALLS * 1e6


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tree", default=None,
                   help="another checkout whose capdec_tpu_torch is timed "
                        "beside this one's")
    p.add_argument("--shapes", default=",".join(SHAPES),
                   help="comma-separated keys of SHAPES to time")
    args = p.parse_args(argv)
    shape_of = {k: SHAPES[k] for k in args.shapes.split(",")}
    if not torch.cuda.is_available():
        print("torch_lm_head_steps: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    cs = _module(HERE / "chip_smoke.py", "chip_smoke")
    steps = _module(HERE / "scripts" / "torch_attn_steps.py",
                    "torch_attn_steps")
    from capdec_tpu_torch.ops import _build, lm_head
    from capdec_tpu_torch.utils.torch_setup import setup_torch

    setup_torch()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    versions = {"this": (lm_head, _build)}
    if args.tree:
        _, tree_build = steps.load_tree(args.tree)
        versions["tree"] = (importlib.import_module(
            "tree_capdec_tpu_torch.ops.lm_head"), tree_build)
    built = {}
    for name, (_, bld) in versions.items():
        so = bld.library_path()
        bld.library()
        log = so.with_suffix(".log")
        report = cs.ptxas_report(log.read_text()) if log.exists() else {}
        built[name] = dict(library=so.name, build_s=bld.build_seconds,
                           ptxas={cs.lm_head_instance(k): v
                                  for k, v in report.items()
                                  if "lm_head_" in k})
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    # operands on a coarse grid (h in quarters, w in eighths): every sum
    # is exact in f32, so the indices must equal the plain version's
    weights = {}
    for _, _, V, D in shape_of.values():
        if (V, D) not in weights:
            weights[V, D] = (torch.randint(-4, 5, (V, D), generator=gen,
                                           device="cuda") / 8).bfloat16()
    inputs = {key: (torch.randint(-4, 5, (B, D), generator=gen,
                                  device="cuda") / 4).bfloat16()
              for key, (B, _, _, D) in shape_of.items()}
    shapes = {}
    for key, (B, R, V, D) in shape_of.items():
        h, w = inputs[key], weights[V, D]
        _, pi, _ = lm_head.lm_head_topk_plain(h, w, R)
        b_ms, b_by = cs.bound_ms((V * D + B * D) * 2 + B * R * 12 + B * 4,
                                 2.0 * B * D * V, torch.bfloat16)
        shapes[key] = dict(B=B, R=R, V=V, D=D, bound_ms=b_ms, bound_by=b_by,
                           plan=lm_head.lm_head_plan(B, V, D, R, 2),
                           cublas_ms=cs.time_ms(lambda: torch.matmul(h,
                                                                     w.t())),
                           plain_idx=pi)
    order = ["tree", "this", "this", "tree"] if args.tree else ["this"]
    times = {}
    for i, name in enumerate(order):
        mod = versions[name][0]
        turn = {}
        for key, (B, R, V, D) in shape_of.items():
            h, w = inputs[key], weights[V, D]
            call = lambda: mod.lm_head_topk(h, w, R)  # noqa: E731
            idx = call()[1]
            torch.cuda.synchronize()
            cs.require(torch.equal(idx, shapes[key]["plain_idx"]),
                       f"{name}: K1 indices differ from the plain version "
                       f"at B={B}")
            turn[key] = dict(ms=cs.time_ms(call, iters=50),
                             host_us=host_us(call))
        times[f"{name}_{i}"] = turn
    for shape in shapes.values():
        del shape["plain_idx"]
    print(smi)
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "tree": args.tree, "built": built,
                      "shapes": shapes, "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where one training step of the PyTorch port spends its time, on one
NVIDIA GPU.

    python3 scripts/torch_train_profile.py [--mode j|k|both] [--steps 10]

Builds chip_smoke.py's full-width model (seeded GPT-2 124M + 8-layer
TransformerMapper, prefix 640 -> 40, bf16 products over f32 master
weights) and its train step at the reference's COCO preset (batch 30,
captions of 40 tokens, noise variance 0.016), mode (j) `only_prefix`
(GPT-2 frozen, the mapper trains) or (k) both trained. After 3 warm-up
steps it times `--steps` steps back to back (host clock, one synchronise
at the end), then `--steps` steps each waiting for its loss (as the loop
does when it logs every step), and profiles 3 more under torch.profiler
(kernels only: user annotations such as the optimizer's are not device
work of their own). Prints one JSON
line per mode: the card and its power limit, ms per step, samples/s, MFU
(utils/flops.train_step_matmul_flops over 989 TFLOP/s bf16 dense), the
device time per step and the device busy share (device time over the
unprofiled step time), kernel launches per step, device ms and launches
per step by kernel family, and the top device-time kernels.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# substrings of a kernel's name -> its family, first match wins
FAMILIES = (("gemm", ("gemm", "xmma", "nvjet", "cutlass", "matmul")),
            ("optimizer", ("multi_tensor", "adam", "Adam")),
            ("softmax", ("softmax",)),
            ("layernorm", ("layer_norm", "LayerNorm")),
            ("index/gather/scatter", ("index", "gather", "scatter",
                                      "embedding")),
            ("reduction", ("reduce", "Reduce")),
            ("copy/cast", ("copy", "Copy")),
            ("elementwise", ("elementwise",)),
            ("fill", ("fill",)))


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def profile_mode(only_prefix: bool, steps: int) -> dict:
    import chip_smoke
    from capdec_tpu_torch.models import caption_model
    from capdec_tpu_torch.train import optim, step
    from capdec_tpu_torch.utils import flops

    tr, main = chip_smoke.TRAIN, chip_smoke.MAIN
    cfg = chip_smoke.model_config(only_prefix=only_prefix)
    model = caption_model.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(chip_smoke.SEED),
        device="cuda")
    opt, sched = optim.make_optimizer(caption_model.set_trainable(model, cfg),
                                      tr["lr"], 0, 1000)
    state = step.init_train_state(model, opt, sched)
    fn = step.make_train_step(cfg, step.NoiseConfig(variance=tr["variance"]))
    rng = np.random.RandomState(chip_smoke.SEED)
    B, T, K = tr["batch"], tr["T"], main["K"]
    batch = {"tokens": rng.randint(1, 256, (B, T)).astype(np.int32),
             "mask": np.ones((B, K + T), np.float32),
             "prefix": rng.randn(B, main["prefix_size"]).astype(np.float32)}
    for _ in range(3):
        fn(state, batch, chip_smoke.SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn(state, batch, chip_smoke.SEED)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    t0 = time.perf_counter()
    for _ in range(steps):  # as the loop runs when it logs every step
        float(fn(state, batch, chip_smoke.SEED)[1])
    synced_ms = (time.perf_counter() - t0) * 1e3 / steps
    n_prof = 3
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(n_prof):
            fn(state, batch, chip_smoke.SEED)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events()
               if e.device_type == cuda and not e.is_user_annotation]
    device_ms = sum(e.device_time_total for e in kernels) / 1e3 / n_prof
    fams, by_name = {}, {}
    for e in kernels:
        f = fams.setdefault(family(e.name), [0, 0.0])
        f[0] += 1
        f[1] += e.device_time_total
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time_total)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    flop = flops.train_step_matmul_flops(cfg, B, T)
    del state, model, opt
    torch.cuda.empty_cache()
    return {
        "mode": "j only_prefix" if only_prefix else "k both train",
        "batch": B, "T": T, "step_ms": step_ms,
        "step_ms_synced_each_step": synced_ms,
        "samples_per_s": B * 1e3 / step_ms,
        "mfu": flop / (step_ms / 1e3) / chip_smoke.PEAK_FLOPS[torch.bfloat16],
        "step_matmul_tflop": flop / 1e12,
        "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / step_ms,
        "launches_per_step": len(kernels) / n_prof,
        "families": {f: {"ms_per_step": t / 1e3 / n_prof,
                         "launches_per_step": n / n_prof}
                     for f, (n, t) in sorted(fams.items(),
                                             key=lambda kv: -kv[1][1])},
        "top_device_ms_per_step": [
            {"kernel": k[:90], "launches_per_step": n / n_prof,
             "ms": t / 1e3 / n_prof} for k, (n, t) in top],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mode", choices=("j", "k", "both"), default="both")
    p.add_argument("--steps", type=int, default=10,
                   help="steps timed back to back, after 3 warm-up steps")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 1
    from capdec_tpu_torch.utils.torch_setup import setup_torch

    setup_torch()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    modes = {"j": (True,), "k": (False,), "both": (True, False)}[args.mode]
    for only_prefix in modes:
        print(json.dumps({"card": torch.cuda.get_device_name(0),
                          "nvidia_smi": smi,
                          **profile_mode(only_prefix, args.steps)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

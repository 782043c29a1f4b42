#!/usr/bin/env python3
"""Where the port's CLIP encoding spends its time, on one NVIDIA GPU.

    python3 scripts/torch_clip_profile.py

Makes chip_smoke.py's clip inputs (RN50x4 and ViT-B/32 from the port's
random init at seed 0, saved as fp16 OpenAI-layout checkpoints; 128
synthetic JPEGs of mixed sizes; the synthetic BPE) and, for each model in
float32 with TF32 off, measures what chip_smoke.py's clip phase does not:
  * the host: loading the checkpoint (wall), `load_and_preprocess` per
    image (decode, bicubic resize, crop, normalise; mean over the 128
    files) and `tokenize_with_truncation` per caption;
  * the card: one call of the image tower on CLIP_RUN["tower_images"]
    preprocessed images and of the text tower on
    CLIP_RUN["tower_captions"] captions (chip_smoke.py's batches) under
    torch.profiler: device ms and launches by kernel family, the top
    kernels, and the device busy share (device time over the profiled
    call's wall time).
The towers' rates at those batches are chip_smoke.py's (CUDA events).
Prints one JSON line per model beside the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# substrings of a kernel's name -> its family, first match wins
FAMILIES = (("batch norm", ("batch_norm", "bn_fw")),
            ("layout transpose", ("nchwToNhwc", "nhwcToNchw")),
            ("convolution", ("conv", "fprop", "winograd", "implicit", "fft",
                             "complex")),
            ("gemm", ("gemm", "xmma", "nvjet", "cutlass", "matmul")),
            ("pool", ("pool",)),
            ("softmax", ("softmax",)),
            ("layernorm", ("layer_norm", "LayerNorm")),
            ("index/gather", ("index", "gather", "embedding")),
            ("reduction", ("reduce", "Reduce")),
            ("copy/cast", ("copy", "Copy")),
            ("elementwise", ("elementwise",)))


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def profiled(fn) -> dict:
    """One call of fn under torch.profiler: device ms and launches by
    family, the top kernels and the busy share."""
    fn()
    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    fams, names = {}, {}
    for e in kernels:
        f = fams.setdefault(family(e.name), [0.0, 0])
        f[0] += e.device_time_total / 1e3
        f[1] += 1
        names[e.name] = names.get(e.name, 0.0) + e.device_time_total / 1e3
    device_ms = sum(f[0] for f in fams.values())
    top = sorted(names.items(), key=lambda kv: -kv[1])[:6]
    return dict(device_ms=device_ms, wall_ms=wall_ms,
                busy_share=device_ms / wall_ms, launches=len(kernels),
                by_family={k: {"ms": v[0], "launches": v[1]}
                           for k, v in sorted(fams.items(),
                                              key=lambda kv: -kv[1][0])},
                top_kernels=[{"name": n[:120], "ms": ms} for n, ms in top])


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_clip_profile: no CUDA device is available",
              file=sys.stderr)
        return 1
    import chip_smoke
    from capdec_tpu_torch.data.image_ops import load_and_preprocess
    from capdec_tpu_torch.models import clip
    from capdec_tpu_torch.utils.clip_tokenizer import (
        CLIPTokenizer, tokenize_with_truncation)
    from capdec_tpu_torch.utils.torch_setup import setup_torch
    setup_torch()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        ins = chip_smoke.clip_inputs(tmp, np.random.RandomState(
            chip_smoke.SEED + 2))
        n_images = chip_smoke.CLIP_RUN["tower_images"]
        n_captions = chip_smoke.CLIP_RUN["tower_captions"]
        files = sorted(Path(ins["images"]).glob("*.jpg"))
        with open(ins["karpathy"]) as f:
            captions = [s["raw"] for im in json.load(f)["images"]
                        for s in im["sentences"]]
        tok = CLIPTokenizer(ins["bpe"])
        t0 = time.perf_counter()
        rows = [tokenize_with_truncation(tok, c)[0][0] for c in captions]
        tokenize_ms = (time.perf_counter() - t0) * 1e3 / len(captions)
        tokens = torch.from_numpy(np.stack(rows[:n_captions])).cuda()
        for name, ckpt in ins["ckpts"].items():
            t0 = time.perf_counter()
            model, cfg = clip.load_openai_checkpoint(ckpt, name,
                                                     device="cuda")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            n_px = cfg.vision.image_resolution
            t0 = time.perf_counter()
            imgs = [load_and_preprocess(str(f), n_px) for f in files]
            preprocess_ms = (time.perf_counter() - t0) * 1e3 / len(files)
            batch = torch.from_numpy(np.stack(imgs[:n_images])).cuda()
            print(json.dumps({
                "model": name, "card": torch.cuda.get_device_name(0),
                "nvidia_smi": smi, "checkpoint_load_s": load_s,
                "preprocess_ms_per_image": preprocess_ms,
                "tokenize_ms_per_caption": tokenize_ms,
                "image_tower": dict(batch=n_images, profile=profiled(
                    lambda: model.encode_image(batch))),
                "text_tower": dict(batch=n_captions, profile=profiled(
                    lambda: model.encode_text(tokens)))}),
                flush=True)
            del model
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""CLIP encoder throughput on one card, on the PyTorch port (counterpart
of scripts/embed_throughput.py). The reference's embedding generator runs
batch-1 per record (embeddings_generator.py:58-89); this measures the
port's batched towers on the same card, each beside that batch-1
structure (one record per call, its embedding copied to the host).

Usage: python scripts/torch_embed_throughput.py [image=1] [vit=1|rn=1]
       [--device cpu]
Default measures the text tower (ViT-B/32's, 512-d); image=1 adds the
image towers (ViT-B/32 and/or RN50x4, the two eval encoders,
predictions_runner:157-161). Random weights from seeds 0-2; float32 with
TF32 off, as the port runs CLIP.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# batch sizes: the text tower, ViT-B/32's and RN50x4's image towers
TEXT_BATCH, VIT_BATCH, RN_BATCH = 1024, 256, 64
BATCH1_CALLS = 20


def _time_batched(fn, x, iters, sync):
    out = fn(x)
    sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(x)
    sync(out)
    return (time.perf_counter() - t0) / iters


def _time_batch1(fn, x, sync):
    """The reference's structure: one record per call, each copied to the
    host before the next."""
    sync(fn(x[:1]))
    t0 = time.perf_counter()
    for i in range(BATCH1_CALLS):
        sync(fn(x[i % len(x):i % len(x) + 1]))
    return (time.perf_counter() - t0) / BATCH1_CALLS


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("opts", nargs="*", help="image=1 vit=1 rn=1")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    opts = dict(kv.split("=") for kv in args.opts)

    import numpy as np
    import torch

    from capdec_tpu_torch.models import clip as clip_lib
    from capdec_tpu_torch.utils.torch_setup import resolve_device

    device = resolve_device(args.device)

    def sync(o):
        o[0, :1].cpu()

    rates = {}
    cfg = clip_lib.MODEL_CONFIGS["ViT-B/32"]
    model = clip_lib.build_model(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    B = TEXT_BATCH
    rng = np.random.RandomState(0)
    ctx = cfg.text.context_length
    toks = np.zeros((B, ctx), np.int64)
    lens = rng.randint(4, 30, size=B)
    for i, L in enumerate(lens):
        toks[i, 0] = 49406
        toks[i, 1:L - 1] = rng.randint(1, 49000, size=L - 2)
        toks[i, L - 1] = 49407
    t_dev = torch.from_numpy(toks).to(device)
    with torch.no_grad():
        dt = _time_batched(model.encode_text, t_dev, 10, sync)
        dt1 = _time_batch1(model.encode_text, t_dev, sync)
    rates["text"] = (B / dt, 1 / dt1)
    print(f"CLIP text encode: {B / dt:.0f} captions/s (batch {B})")
    print(f"reference batch-1 structure: {1 / dt1:.1f} captions/s "
          f"-> {B / dt / (1 / dt1):.0f}x", flush=True)
    if not int(opts.get("image", 0)):
        return rates

    towers = []
    if int(opts.get("vit", 1)):
        towers.append(("ViT-B/32", model, VIT_BATCH))
    if int(opts.get("rn", 1)):
        towers.append(("RN50x4", None, RN_BATCH))
    for seed, (name, tower, BI) in enumerate(towers, start=1):
        if tower is None:
            tower = clip_lib.build_model(
                clip_lib.MODEL_CONFIGS[name],
                torch.Generator(device=device).manual_seed(seed),
                device=device)
        n_px = clip_lib.MODEL_CONFIGS[name].vision.image_resolution
        imgs = torch.from_numpy(rng.randn(BI, n_px, n_px, 3).astype(
            np.float32)).to(device)
        with torch.no_grad():
            dt = _time_batched(tower.encode_image, imgs, 5, sync)
            dt1 = _time_batch1(tower.encode_image, imgs, sync)
        rates[name] = (BI / dt, 1 / dt1)
        print(f"CLIP {name} image encode: {BI / dt:.0f} images/s "
              f"(batch {BI}); batch-1 structure {1 / dt1:.1f} images/s "
              f"-> {BI / dt / (1 / dt1):.0f}x", flush=True)
        del tower
    return rates


if __name__ == "__main__":
    main()

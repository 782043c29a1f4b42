"""Train-throughput batch scaling on one card, on the PyTorch port
(counterpart of scripts/train_scaling.py).

The reference's COCO preset pins bs=30; this measures how samples/s scales
when the batch grows, at full width (GPT-2 124M + the 8-layer mapper, bf16
products over f32 weights, only_prefix, noise 0.016, T 40), K optimizer
steps per dispatch with a host sync on the last loss. CE_CHUNK=C runs the
loss's LM head in chunks of C rows (caption_model.loss_sums).

Usage: python scripts/torch_train_scaling.py [bs ...] [--device cpu]
       (default sizes 30 120 240)
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

T, K = 40, 8  # caption tokens; optimizer steps per dispatch


def model_config(ce_chunk: int):
    import torch
    from capdec_tpu_torch.models import caption_model, gpt2
    return caption_model.CaptionModelConfig(
        prefix_length=40, clip_length=40, prefix_size=640, num_layers=8,
        mapping_type="transformer", only_prefix=True, ce_chunk_rows=ce_chunk,
        gpt2=gpt2.GPT2Config(compute_dtype=torch.bfloat16))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("sizes", nargs="*", type=int, default=[30, 120, 240])
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from capdec_tpu_torch.models import caption_model
    from capdec_tpu_torch.train import optim as optim_lib
    from capdec_tpu_torch.train import step as step_lib
    from capdec_tpu_torch.utils.torch_setup import resolve_device

    device = resolve_device(args.device)
    sync = torch.cuda.synchronize if device.type == "cuda" else lambda: None
    ce_chunk = int(os.environ.get("CE_CHUNK", "0"))
    rates = {}
    for bs in args.sizes:
        cfg = model_config(ce_chunk)
        model = caption_model.init_params(
            cfg, torch.Generator(device=device).manual_seed(1),
            device=device)
        opt, sched = optim_lib.make_optimizer(
            caption_model.set_trainable(model, cfg), 2e-5, 5000, 100000)
        state = step_lib.init_train_state(model, opt, sched)
        rng = np.random.RandomState(0)
        hb = {"tokens": rng.randint(1, cfg.gpt2.vocab_size, (bs, T)),
              "mask": np.ones((bs, cfg.prefix_length + T), np.float32),
              "prefix": rng.randn(bs, cfg.prefix_size).astype(np.float32)}
        stacked = {k: torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(v, (K,) + v.shape))).to(device)
            for k, v in hb.items()}
        multi_step = step_lib.make_train_multi_step(
            cfg, step_lib.NoiseConfig(variance=0.016))
        state, losses = multi_step(state, stacked, 2)
        float(losses[-1])
        sync()
        t0 = time.perf_counter()
        iters = 4
        for _ in range(iters):
            state, losses = multi_step(state, stacked, 2)
        float(losses[-1])
        sync()
        dt = (time.perf_counter() - t0) / iters
        rates[bs] = bs * K / dt
        print(f"bs={bs} ce_chunk={ce_chunk}: {bs * K / dt:.0f} samples/s "
              f"({dt / K * 1000:.1f} ms/step)", flush=True)
        del state, model, opt, stacked
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rates


if __name__ == "__main__":
    main()

"""Sequence-packing probe for the PyTorch port's training step
(counterpart of scripts/train_packing_probe.py).

Packing P=2 (prefix+caption) segments per row (S=160, block-diagonal
causal mask, per-segment position reset, the same samples per step) asks
whether fuller products raise samples/s on the card. What packing changes,
stated before the measurement:
  * QKV/MLP/LM-head matmuls: identical FLOPs and identical [rows=B*S]
    shapes (B halves, S doubles).
  * Attention scores/values: the block-diagonal [S,S] is computed DENSE,
    so attention matmul FLOPs DOUBLE at P=2, and the softmax's
    elementwise work on [B,H,S,S] likewise.

The probe first proves the packed loss equal (f32 tolerance) to the
unpacked loss over the same samples on the CPU, then measures both at
full width (GPT-2 124M + the 8-layer mapper, bf16 products, only_prefix,
noise 0.016) with a host sync on each K-step dispatch's last loss.

Usage: python scripts/torch_train_packing_probe.py [--bs 120] [--steps 8]
       [--check-only] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def packed_loss_forward(model, cfg, tokens, prefix, mask):
    """Masked-mean CE over P packed (prefix+caption) segments per row.

    tokens [B, P, T] int, prefix [B, P, Dp] f32, mask [B, P, K+T]. Equals
    caption_model.loss_forward over the same B*P samples: CE is
    sum(nll*valid)/sum(valid) either way, segments are isolated by the
    block-diagonal causal bias, and positions restart per segment."""
    import torch
    from capdec_tpu_torch.models import gpt2

    B, P, T = tokens.shape
    K = cfg.prefix_length
    seg_len = K + T
    toks = tokens.reshape(B * P, T).long()
    tok_e = gpt2.embed_tokens(model.gpt, toks)
    pre_e = model.clip_project(prefix.reshape(B * P, -1)).to(tok_e.dtype)
    D = tok_e.shape[-1]
    seg = torch.cat([pre_e, tok_e], dim=1)             # [B*P, K+T, D]
    seg = seg.reshape(B, P * seg_len, D)
    blk = torch.ones(seg_len, seg_len, device=seg.device).tril()
    eye = torch.eye(P, device=seg.device)
    bias = torch.where(torch.kron(eye, blk) > 0, 0.0,
                       gpt2.NEG_INF)                    # [S, S] block-diag
    positions = torch.arange(seg_len, device=seg.device).repeat(P)
    hidden = gpt2.forward_hidden(
        model.gpt, cfg.gpt2, seg, mask.reshape(B, P * seg_len),
        attention_bias=bias, positions=positions)
    hidden = hidden.reshape(B * P, seg_len, D)
    scored = hidden[:, K - 1:K + T - 1]                 # loss_forward's slice
    logits = gpt2.final_logits(model.gpt, cfg.gpt2, scored).float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, toks[..., None])[..., 0]
    valid = (toks != 0).float()
    return ((lse - picked) * valid).sum() / valid.sum().clamp_min(1.0)


def _tiny_cfg():
    from capdec_tpu_torch.models import caption_model, gpt2
    return caption_model.CaptionModelConfig(
        prefix_length=6, clip_length=6, prefix_size=16, num_layers=2,
        mapping_type="transformer",
        gpt2=gpt2.GPT2Config(n_layer=2, n_embd=64, n_head=2, vocab_size=300,
                             n_positions=64))


def check_inputs(cfg):
    """The correctness check's samples: B=4 rows of P=2 segments of T=5
    tokens (one caption ragged), their masks and prefixes."""
    rng = np.random.RandomState(0)
    B, P, T = 4, 2, 5
    K = cfg.prefix_length
    tokens = rng.randint(1, 300, (B, P, T)).astype(np.int32)
    tokens[0, 0, 3:] = 0  # ragged caption: pad + loss mask must agree
    mask = np.concatenate([np.ones((B, P, K), np.float32),
                           (tokens != 0).astype(np.float32)], axis=-1)
    prefix = rng.randn(B, P, cfg.prefix_size).astype(np.float32)
    return tokens, prefix, mask


def check_correctness():
    """Packed loss == unpacked loss over the same samples (CPU, tiny)."""
    import torch
    from capdec_tpu_torch.models import caption_model

    cfg = _tiny_cfg()
    model = caption_model.init_params(cfg, torch.Generator().manual_seed(0))
    tokens, prefix, mask = check_inputs(cfg)
    B, P, T = tokens.shape
    t, x, m = (torch.from_numpy(a) for a in (tokens, prefix, mask))
    with torch.no_grad():
        packed = float(packed_loss_forward(model, cfg, t, x, m))
        flat = float(caption_model.loss_forward(
            model, cfg, t.reshape(B * P, T).long(),
            x.reshape(B * P, -1), m.reshape(B * P, -1)))
    print(f"packed loss {packed:.6f}  unpacked loss {flat:.6f}")
    assert abs(packed - flat) < 1e-4, "packing changed the loss"
    print("OK: packed == unpacked over the same samples")
    return packed, flat


def model_config():
    """The bench's flagship training configuration (only_prefix, bf16)."""
    import torch
    from capdec_tpu_torch.models import caption_model, gpt2
    return caption_model.CaptionModelConfig(
        prefix_length=40, clip_length=40, prefix_size=640, num_layers=8,
        mapping_type="transformer", only_prefix=True,
        gpt2=gpt2.GPT2Config(compute_dtype=torch.bfloat16))


def measure(args) -> dict:
    import torch

    from capdec_tpu_torch.models import caption_model
    from capdec_tpu_torch.ops import noise as noise_ops
    from capdec_tpu_torch.train import optim as optim_lib
    from capdec_tpu_torch.utils.torch_setup import resolve_device

    device = resolve_device(args.device)
    cfg = model_config()
    T, K = 40, cfg.prefix_length
    V, Dp = cfg.gpt2.vocab_size, cfg.prefix_size
    rng = np.random.RandomState(0)
    samples = args.bs  # per optimizer step, both variants
    sync = torch.cuda.synchronize if device.type == "cuda" else lambda: None

    def run(packed: bool) -> float:
        model = caption_model.init_params(
            cfg, torch.Generator(device=device).manual_seed(1),
            device=device)
        opt, sched = optim_lib.make_optimizer(
            caption_model.set_trainable(model, cfg), 2e-5, 5000, 100000)
        gen = torch.Generator(device=device).manual_seed(2)

        def one_step(batch):
            noised = noise_ops.noise_injection(
                batch["prefix"].reshape(-1, Dp), variance=0.016,
                generator=gen).reshape(batch["prefix"].shape)
            if packed:
                loss = packed_loss_forward(model, cfg, batch["tokens"],
                                           noised, batch["mask"])
            else:
                loss = caption_model.loss_forward(
                    model, cfg, batch["tokens"], noised, batch["mask"])
            loss.backward()
            optim_lib.apply_updates(opt, sched)
            return loss.detach()

        def make_batch():
            shape = (samples // 2, 2) if packed else (samples,)
            return {"tokens": torch.from_numpy(rng.randint(
                        1, V, shape + (T,))).long().to(device),
                    "mask": torch.ones(shape + (K + T,), device=device),
                    "prefix": torch.from_numpy(rng.randn(
                        *shape, Dp).astype(np.float32)).to(device)}

        batches = [make_batch() for _ in range(2)]

        def dispatch(batch):
            losses = [one_step(batch) for _ in range(args.steps)]
            float(losses[-1])  # honest per-dispatch sync

        dispatch(batches[0])  # warm
        iters = 4
        sync()
        t0 = time.perf_counter()
        for i in range(iters):
            dispatch(batches[i % 2])
        sync()
        return samples * args.steps * iters / (time.perf_counter() - t0)

    flat_sps = run(packed=False)
    print(f"unpacked bs={samples}: {flat_sps:.1f} samples/s", flush=True)
    packed_sps = run(packed=True)
    print(f"packed   bs={samples // 2}x2 (S=160): {packed_sps:.1f} samples/s",
          flush=True)
    out = {"unpacked_sps": flat_sps, "packed_sps": packed_sps,
           "packed_speedup": packed_sps / flat_sps,
           "samples_per_step": samples}
    print(json.dumps(out))
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bs", type=int, default=120)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device of the throughput probe (default: "
                         "the CUDA card)")
    return ap


if __name__ == "__main__":
    a = build_parser().parse_args()
    if a.check_only:
        check_correctness()
    else:
        # the correctness check runs on the CPU in a child of its own
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--check-only"], check=True)
        measure(a)

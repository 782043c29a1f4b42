#!/usr/bin/env python3
"""The port's dp x tp path across several cards on NCCL, against one card.

    torchrun --standalone --nproc_per_node 4 scripts/torch_mesh_cards.py
    torchrun --standalone --nproc_per_node 4 scripts/torch_mesh_cards.py \\
        --device cpu --tiny        # a rehearsal on gloo, tiny widths

One process per card (torchrun's LOCAL_RANK picks it). Every rank builds
chip_smoke.py's full-width model from seed 0 (GPT-2 124M + the 8-layer
TransformerMapper, bf16 products over f32 weights).

  * train: modes (j) only_prefix and (k) both trained, a global batch of
    32 captions of 40 tokens (noise variance 0.016, lr 1e-4), 3 warm-up
    and `--steps` timed steps, first on rank 0 alone without a mesh (the
    other ranks wait), then on every rank under the meshes (dp, tp) =
    (n, 1) and (n / 2, 2). Each step's loss is the global batch's; the
    losses' largest relative difference from one card's is reported (bf16
    products summed in other orders differ by rounding; a missing or
    doubled reduction moves the loss by far more) and must stay below
    2e-2. ms per step: host clock, synchronised after each step.
  * decode: beam 5 over n x 64 images, on rank 0 alone in n batches of
    64, then dp-sharded over all n ranks (64 each: the same batches, so
    the tokens must be identical), then over (n / 2, 2) with a tp-split
    GPT-2 (the share of top-beam tokens equal to one card's is reported:
    a reassociated bf16 sum may move a near-tie). captions/s of the
    decode alone (host clock, synchronised).

Prints one JSON line per phase (rank 0), each with every card's name and
power limit (nvidia-smi), then `mesh_cards ok`. It exits non-zero if a
check fails.
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
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

LOSS_REL_TOL = 2e-2


def config(tiny: bool, only_prefix: bool):
    from capdec_tpu_torch.models import caption_model, gpt2
    if tiny:
        g = gpt2.GPT2Config(vocab_size=300, n_positions=128, n_embd=64,
                            n_layer=2, n_head=4)
        return caption_model.CaptionModelConfig(
            prefix_length=8, clip_length=8, prefix_size=32, num_layers=1,
            only_prefix=only_prefix, gpt2=g)
    import chip_smoke
    return chip_smoke.model_config(only_prefix=only_prefix)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fresh_model(cfg, device):
    from capdec_tpu_torch.models import caption_model
    gen = torch.Generator(device=device).manual_seed(0)
    return caption_model.init_params(cfg, gen, device=device)


def train_run(cfg, device, mesh, batches, warm) -> dict:
    """Losses and ms per step of the timed steps (after `warm`)."""
    from capdec_tpu_torch.models import caption_model
    from capdec_tpu_torch.parallel import mesh as mesh_lib
    from capdec_tpu_torch.train import optim, step
    model = fresh_model(cfg, device)
    if mesh is not None:
        mesh_lib.shard_params(model, mesh,
                              mesh_lib.caption_model_param_specs(model))
    opt, sched = optim.make_optimizer(
        caption_model.set_trainable(model, cfg), 1e-4, 0, 1000)
    state = step.init_train_state(model, opt, sched)
    fn = step.make_train_step(cfg, step.NoiseConfig(variance=0.016), mesh)
    losses, times = [], []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        state, loss = fn(state, b, 0)
        loss = float(loss)
        sync(device)
        if i >= warm:
            times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    del model, state, opt
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return dict(losses=losses, ms_per_step=float(np.median(times)))


def decode_rows(gpt, cfg, prefixes, device):
    """Top-beam tokens and lengths of beam 5 over `prefixes` [N, K, D]."""
    from capdec_tpu_torch.decode import BeamConfig, beam_search, \
        beam_top_select
    toks, lens, _, order = beam_search(gpt, cfg.gpt2, prefixes,
                                       BeamConfig(entry_length=67))
    return beam_top_select(toks, lens, order)


def timed(fn, device):
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()

    from capdec_tpu_torch.decode.beam import cast_params_for_decode
    from capdec_tpu_torch.models import caption_model, gpt2
    from capdec_tpu_torch.parallel import mesh as mesh_lib

    device = mesh_lib.init_distributed(args.device)
    rank, world = dist.get_rank(), dist.get_world_size()
    if world < 2 or world % 2:
        raise SystemExit("run under torchrun with an even number of ranks")
    main_rank = rank == 0
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
           if device.type == "cuda" else ["cpu (no card)"])
    meshes = [mesh_lib.make_mesh(dp=world, tp=1, device=device),
              mesh_lib.make_mesh(dp=world // 2, tp=2, device=device)]
    shapes = [f"{m.dp}x{m.tp}" for m in meshes]

    def log(**kw):
        if main_rank:
            print(json.dumps({**kw, "cards": smi, "world": world}),
                  flush=True)

    rng = np.random.RandomState(0)
    B, T, warm = 32, 40, 3
    for only_prefix in (True, False):
        cfg = config(args.tiny, only_prefix)
        K, V = cfg.prefix_length, cfg.gpt2.vocab_size
        batches = []
        for _ in range(warm + args.steps):
            tokens = rng.randint(1, V, size=(B, T))
            tokens[:B // 2, T // 3:] = 0  # unequal valid counts over dp
            batches.append({
                "tokens": tokens,
                "mask": np.concatenate([np.ones((B, K), np.float32),
                                        (tokens > 0).astype(np.float32)], 1),
                "prefix": rng.randn(B, cfg.prefix_size).astype(np.float32)})
        one = train_run(cfg, device, None, batches, warm) if main_rank \
            else None
        dist.barrier()
        runs = {"1x1": one}
        for m, shape in zip(meshes, shapes):
            runs[shape] = train_run(cfg, device, m, batches, warm)
        if main_rank:
            ref = np.asarray(one["losses"])
            rel = {s: float(np.max(np.abs(np.asarray(r["losses"]) - ref)
                                   / np.abs(ref)))
                   for s, r in runs.items() if s != "1x1"}
            ok = all(np.isfinite(r["losses"]).all() for r in runs.values())
            log(phase="train", mode="j only_prefix" if only_prefix
                else "k both train", batch=B, T=T, steps=args.steps,
                ms_per_step={s: r["ms_per_step"] for s, r in runs.items()},
                samples_per_s={s: B / r["ms_per_step"] * 1e3
                               for s, r in runs.items()},
                loss_max_rel_diff=rel, first_losses={
                    s: r["losses"][:3] for s, r in runs.items()})
            if not ok or max(rel.values()) > LOSS_REL_TOL:
                raise SystemExit(f"train: losses {rel} beyond "
                                 f"{LOSS_REL_TOL} of one card's")

    cfg = config(args.tiny, False)
    N = 64
    prefixes = torch.from_numpy((rng.randn(world * N, cfg.prefix_size)
                                 / np.sqrt(cfg.prefix_size)).astype(
        np.float32)).to(device)
    model = fresh_model(cfg, device).eval()
    embeds = caption_model.map_prefix(model, cfg, prefixes)
    gpt = cast_params_for_decode(model.gpt, cfg.gpt2)
    one = None
    if main_rank:
        decode_rows(gpt, cfg, embeds[:N], device)  # warm
        got, wall1 = timed(lambda: [decode_rows(gpt, cfg, embeds[i:i + N],
                                                device)
                                    for i in range(0, len(embeds), N)],
                           device)
        one = (torch.cat([t for t, _ in got]), torch.cat([n for _, n in got]))
    dist.barrier()
    dp = meshes[0]
    rows = mesh_lib.shard_batch(embeds, dp)
    decode_rows(gpt, cfg, rows, device)  # warm
    (toks, lens), wall_dp = timed(lambda: decode_rows(gpt, cfg, rows, device),
                                  device)
    toks, lens = mesh_lib.gather_batch(toks, dp), mesh_lib.gather_batch(lens,
                                                                        dp)
    tp_mesh = meshes[1]
    tp_gpt = gpt2.params_from_torch_state_dict(
        gpt2.params_to_torch_state_dict(model.gpt), cfg.gpt2, device=device)
    mesh_lib.shard_params(tp_gpt, tp_mesh, mesh_lib.gpt2_model_specs(tp_gpt))
    tp_gpt = cast_params_for_decode(tp_gpt, cfg.gpt2)
    tp_rows = mesh_lib.shard_batch(embeds, tp_mesh)
    decode_rows(tp_gpt, cfg, tp_rows[:N], device)  # warm
    (ttoks, tlens), wall_tp = timed(
        lambda: decode_rows(tp_gpt, cfg, tp_rows, device), device)
    ttoks = mesh_lib.gather_batch(ttoks, tp_mesh)
    tlens = mesh_lib.gather_batch(tlens, tp_mesh)
    if main_rank:
        same_dp = bool(torch.equal(toks, one[0]) and torch.equal(lens, one[1]))
        span = torch.maximum(tlens, one[1]).long()
        pos = torch.arange(ttoks.shape[1], device=device)[None]
        mask = pos < span[:, None]
        share = float(((ttoks == one[0]) & mask).sum() / mask.sum())
        n = len(embeds)
        log(phase="decode", images=n, batch_per_rank=N,
            captions_per_s={"1x1": n / wall1, shapes[0]: n / wall_dp,
                            shapes[1]: n / wall_tp},
            dp_tokens_identical=same_dp, tp_token_share=share)
        if not same_dp:
            raise SystemExit("decode: dp tokens differ from one card's")
        print("mesh_cards ok", flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""On-card smoke run of the capdec_tpu_torch port (one NVIDIA GPU, sm_90a).

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. The card's name and power limit (nvidia-smi) and the build of the
     hand-written kernels from capdec_tpu_torch/csrc.
  2. Each kernel (K1-K15) against its plain PyTorch version on the
     card, at the served paths' shapes (K1 at both: B 320 rows, R 5 for
     the beam paths and B 64, R 1 for greedy, each with its own bound and
     beside the cuBLAS product alone; its instances must build without
     spills), in bf16 and f32 (int8 caches for
     K5-K7 and K9, with and without K9's int8 prefix, and for the gathers
     K10-K12; NaN in the slots or scales the attention kernels must not
     read); the kernel's time beside the plain version's, one PyTorch
     library call's where one computes the same function, and the bound
     (the least time the card could take). The slot writes K3, K5, K13
     and K14 are timed over inputs and slots rotated through more than
     twice the L2, so that they read device memory as their bound
     assumes (K5's four instances, the eight of K3/K13/K14's kernel and
     K4's one must build without spills); K3, K13 and K14 are
     checked and timed from the per-layer views of qkv buffers, as
     decode_step hands them over (and checked from stacked tensors),
     beside the empty kernel on the grid, the floor of one launch, and
     the library route (torch.stack, then index_copy_); K4 beside the
     empty kernel on its grid, also checked on sources that cross
     images; K2, K6, K8,
     K9 and K15 (one kernel, decode_attention_async.cu, whose 24
     instances must build without spills) and their SDPA yardstick at
     steps 1, 33 and 66, on one layer and rotated over the layers or
     cache sets (SDPA over key sets); K9 at R = 5 with both prefix kinds
     and at R = 1 with the int8 prefix; K2 at ClipCap's served shape
     (N 512 x R 5, a prefix of 10 slots) on its widened plan, checked with
     NaN in the slots it must not read and timed at steps 0, 33 and 66
     (check_short_prefix_attention). Then decode_step's fused
     epilogues (csrc/epilogue.cu: bias_cast, bias_gelu_cast,
     bias_residual_layernorm, embed_layernorm; their twelve instances
     must build without spills) at B 2560, 5 and 333 in bf16 and f32
     against the op chains they replace, timed in bf16 at B 2560 (rotated
     past the L2, and warm) and B 5, each with its wrapper's host µs.
     Then the MLA-MoE decoder (models/mla_moe.py, Kimi-VL-A3B's text
     model; check_mla_moe) at its served shapes, batch 512 x beam 5:
     K16 (mla_decode_attention) at steps 0, 33, 66 and 71 and at one
     image, timed beside its plain version, its bound and SDPA over the
     gathered latent; mla_prep, residual_rmsnorm, moe_route,
     moe_dispatch, swiglu and moe_combine at 2560 rows; the grouped
     expert products (torch._grouped_mm) over 15360 rows against the
     per-expert loop, beside cuBLAS's dense products; K1 at (2560,
     163840, 2048) (the `d2048` key of its row); K3 and K4 on the
     one-tensor latent cache [2560, 27, 72, 576] (the `latent` key of
     their rows); the new kernels' instances without spills. Then the
     decoder served (mla_moe_path): full width, 1 dense + 1 routed
     layer, 512 requests as one batch through CaptionServer, its
     kernels launched and no other, the expert_rows counter full.
  3. The served paths: a CaptionServer on full-width weights made from a
     seed (GPT-2 124M + the 8-layer TransformerMapper, prefix 640 -> 40,
     bf16, batch 64, entry_length 67) serves 128 requests on each path;
     the kernels' launch counters are zeroed just before each and read
     just after, and each path must have launched its kernels and no
     other, the four epilogues on every path (each decodes GPT-2 124M at
     one rank), and no attention kernel on a widened plan (the prefix is
     40 slots): beam 5 (K1-K4); int8 KV (K1, K5-K7); (a) slot-bounded beam,
     fused_slot_chunks=8 (K1, K8, K3, K4); (b) its int8 form with the
     int8 prefix (K1, K9, K5, K4); (c) greedy, the default ToppConfig
     (K1); (d) greedy with chunk_slot_write (K1, K13); (e) greedy's fused
     chunked int8 route (K1, K9, K5); (f) non-lane beam, lane_beams=False
     (K1, K2, K3, K10); (g) seq-major beam, rowmajor_cache=False (K1,
     K11); (h) the K14 slot write, chunk_slot_write=False with
     pallas_slot_write (K1, K2, K14, K4); (i) ancestry=True (K1, K3).
     Path (d) launches K13 once a step, and one of its batches is
     profiled for every CUDA kernel it launches per step.
     K12 and K15 lie on no served path (the JAX engine calls neither)
     and must launch on none; K15 (the v1 attention with its fused slot
     write) is checked at the beam path's per-layer shapes in phase 2.
     Then beam 33 (beam33): 64 images at beam_size 33 on the bf16 beam
     path (K1-K4; K2 in three row groups of 16), and K2 at R 33 timed
     against its plain version, SDPA and its bound.
  4. Kernels against plain versions over whole decodes, in f32: 8 images
     on the beam path, (a), (c), (d), (f)-(i) and beam 33 give identical
     tokens
     (the bf16 path's token share with f32 is reported), and (f)'s
     tokens, lengths and beam order equal the beam path's (the cache
     moves are exact copies); a batch of 64 images on
     the int8 path, (b) and (e) shares >= 0.98 of the top-beam (greedy:
     all) tokens (a level that rounds the other way may move a near-tie;
     exact identity and the share with the fp path are reported).
  5. Training at full width (GPT-2 124M + the 8-layer mapper, bf16
     products over f32 weights, batch 30, captions of 40 tokens, noise
     variance 0.016) through train.loop.train on a corpus pickle made
     from the seed: (j) only_prefix and (k) both trained, each 3 warm-up
     steps and 20 timed ones (samples/s, ms per step, MFU against 989
     TFLOP/s bf16); finite losses, the no-noise loss on the corpus's
     rows falling, (j) leaving GPT-2 bit-unchanged, no decode kernel
     launched, and the saved `smoke-000.pt` serving a batch of 64. Then
     one f32 step at batch 2 on the card against the CPU (loss and
     mapper gradient). Then the two other mappers (mappers):
     transformer_decoder and mapping_network at full width, 3 steps of
     (j) each (finite losses, the no-noise loss falling), the loop's `.pt`
     read back with an inferred config and serving 64 captions on K1-K4,
     and each mapper's f32 forward at batch 2, card against CPU, within
     1e-4 relative L2. Then the predict CLI (predict) on the card from
     (j)'s `smoke-000.pt` with --infer_model_config, --embeddings_pickle
     (128 records) and --score_gt at batch 64: beam (K1-K4), --int8_kv
     (K1, K5-K7) and --no_beam (K1), 128 captions each, the beam run's
     first 64 equal to CaptionServer's for the same embeddings. Then the
     CLIP chain (clip), the README Quickstart at full width from caption
     text and image files: ViT-B/32 and RN50x4 from the port's random
     init at seed 0, saved as fp16 OpenAI-layout .pt files; a synthetic
     BPE merge file (CAPDEC_CLIP_BPE_PATH); a synthetic Karpathy JSON (128
     test images of mixed sizes and aspects as JPEG files, 128 val
     captions, 600 train captions of random words, some with gender terms,
     six longer than 77 tokens). parse_corpus karpathy; embeddings_generator
     text mode with RN50x4 and --fix_gender_imbalance_mode 1; the train
     CLI (one epoch of --only_prefix, 10 steps); predict --clip_checkpoint
     --infer_model_config --score_gt at batch 64, beam 5, on the 128 image
     files (K1-K4, the epilogues and no other kernel, 128 captions), whose
     captions must equal predict's from the pickle embeddings_generator writes
     in image mode on the same images. ViT-B/32: image mode, and predict
     --text_autoencoder on its text tower (a 512-wide checkpoint trained
     the same way). Each tower's f32 output on a batch of 4, card against
     CPU, within 1e-4 relative L2; RN50x4's activations after each stage
     finite; images/s and captions/s of each CLI call and of each tower
     beside the card's name and power limit. Then the mesh phase
     (mesh): a world-1 NCCL process group in this process and a (dp 1,
     tp 1) mesh (parallel/mesh.py); 3 steps of (j) at full width through
     train.loop.train with the mesh and without it (plain, mesh, mesh,
     plain), whose losses and mapper weights must be bit-equal; predict
     --mesh 1 (beam and --int8_kv, 128 records) and CaptionServer under
     the mesh (128 requests), whose captions and launch counts must
     equal the runs without it; torch_entry.entry()'s flagship loss
     finite; K2, K3 and K4 at a tp=2 rank's shapes (D 384, 6 heads, N 64
     x R 5) against their plain versions (the `tp2` key of their rows);
     the world-1 overhead per train step and the captions/s beside the
     card's name and power limit. The process group is destroyed after.
     Then the lifecycle phase (lifecycle): the predict CLI (--mesh 1, 16
     of those records, beam at batch 64) and the train CLI (--mesh 1,1
     --max_steps 2 at full width) each as a process of its own under
     `python -m torch.distributed.run --standalone --nproc_per_node 1`
     on NCCL, both at once: rc 0 and neither PyTorch's
     destroy_process_group warning nor an abort in stderr (each CLI ends
     the group it started), predict's captions equal to an in-process run's
     without a mesh and its launches K1-K4 and the epilogues only, train's two
     losses finite. Then the cache-api phase (cache_api): GPT-2's
     single-cache API (init_kv_cache, forward_with_cache) at full width,
     GPT-2 124M, 5 rows of a 40-slot prefix prefilled and 26 greedy
     decode steps over S_max 67: in f32 each step's logits within 1e-4
     relative of the full forward's; in bf16 within 2e-2 of the bf16 full
     forward's, and the tokens equal to the greedy engine's but at a bf16
     rounding tie (cache_api_phase says which).
     Then the recipes phase (recipes), on the clip phase's artifacts:
     (a) examples/torch_inference_demo.py on one test JPEG at full width
     (RN50x4, GPT-2 124M, the 8-layer mapper, bf16): the beam launches K1-K4
     and the epilogues only, greedy K1 and the epilogues; in f32 its beam and
     greedy decodes through the kernels equal those through the plain versions;
     K1 at B 5, R 5 and B 1, R 1 and K2-K4 at N 1 against their plain versions
     (the `demo` key of their rows); beam 0 equals the predict CLI's
     caption of that image at --batch_size 1; (b)
     scripts/torch_zoo_parity.sh on the same full-width stand-ins with the
     gates off: PARITY OK, 128 predictions, float CIDEr and Bleu_4, K1-K4
     only (its python processes count their launches through a
     sitecustomize first on PYTHONPATH); (c)
     scripts/torch_serve_throughput.py at --n 2048 --batch 512 (2560 beam
     rows, a 3.4 GB bf16 K cache) for beam (K1-K4), --int8 (K1, K5-K7)
     and --no_beam (K1): captions/s, p50/p99 latency, launches and the
     busy share; at batch 512 in f32 (entry_length cut to 24 for the
     plain path's time; the cache still spans more than 2^31 bytes) the
     kernel path's tokens equal the plain path's on every image but
     rounding ties of the plain path itself (images it decodes otherwise
     in batches of 64: f32 products round by shape), where they must
     equal the plain path's in batches of 64, and the int8 share is at
     least 0.98; K1 at B 2560, R 5 and B 512, R 1 and K2-K4 at N 512
     timed against their plain versions, bounds and library calls (the
     `n512` key of their rows); (d) scripts/torch_int8_quality_probe.py
     at its defaults (K1-K7): every decode stops at '.' before its cap
     at least once; flips and deltas reported; on its trained model
     (V 256, D 128, 2 heads, a 4-slot prefix) the f32 exact beam through
     the kernels equals the plain path, the int8 beam's share with its
     plain version is at least 0.98, and K1 at B 320, R 5 is held against
     its plain version (the `probe` key of its row).
  6. A JSON line of the kernels, then {"ok": true, "device": ...} last.
Without a CUDA device it exits 1 and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import itertools
import json
import math
import os
import pathlib
import re
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# The main path's shapes: batch_size 64 images x beam 5, GPT-2 124M,
# prefix 40, entry_length 67 (cache slots rounded up to 72).
MAIN = dict(N=64, R=5, L=12, H=12, D=768, V=50257, K=40, E=72,
            entry_length=67, prefix_size=640, mapper_layers=8,
            requests=128, identity_images=8, int8_images=64)
DEVICE = "cuda"
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def log(*parts):
    print(*parts, flush=True)


# Cycles the card sleeps before a timed run (about 50 ms at the H100's
# clocks): long enough for the host to enqueue every timed call.
SLEEP_CYCLES = 100_000_000


def time_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls. The card
    sleeps while the host enqueues the calls, so a wrapper whose Python
    takes longer than its kernel leaves no gaps between the launches for
    the events to time (a call that synchronises still waits)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rotating(fn, n: int):
    """A call of fn(i) for i = 0, 1, 2, ... mod n: each call touches other
    buffers or slots, so that a pass over them exceeds the card's 50 MB
    L2 and the timed calls read device memory, as their bound assumes."""
    count = itertools.count()
    return lambda: fn(next(count) % n)


# Bytes a rotation must cover: twice the H100's L2.
L2_FLUSH_BYTES = 100 * 2 ** 20


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def n_kv_sets(shape) -> int:
    """How many bf16 (new_k, new_v) pairs of `shape` one pass must read
    to read more than L2_FLUSH_BYTES."""
    return -(-L2_FLUSH_BYTES // (2 * int(np.prod(shape)) * 2))


def new_kv_sets(gen, shape):
    """n_kv_sets(shape) random bf16 (new_k, new_v) pairs of `shape`."""
    return [tuple(torch.randn(*shape, generator=gen, device=DEVICE).to(
        torch.bfloat16) for _ in range(2)) for _ in range(n_kv_sets(shape))]


def slot_write_times(gen, kernel, plain, k, v, shape):
    """Time a bf16 slot write (K3, K13), its plain version and
    `index_copy_` on the slot axis: call i writes new K/V set i of a
    rotation into slot i mod E of the caches k/v. Also the bound: the new
    K/V read once and written once."""
    E = k.shape[2]
    sets = new_kv_sets(gen, shape)
    idx = [torch.tensor([s], device=DEVICE) for s in range(E)]
    n = len(sets)

    def call(fn):
        return rotating(lambda i: fn(k, v, *sets[i % n], i % E), n * E)

    def library(i):
        nk, nv = sets[i % n]
        k.index_copy_(2, idx[i % E], nk.unsqueeze(2))
        v.index_copy_(2, idx[i % E], nv.unsqueeze(2))

    b_ms, b_by = bound_ms(2 * 2 * int(np.prod(shape)) * 2, 0, torch.bfloat16)
    return dict(ms=time_ms(call(kernel)), plain_ms=time_ms(call(plain)),
                library_ms=time_ms(rotating(library, n * E)),
                bound_ms=b_ms, bound_by=b_by)


def sdpa_ms(q, keys, vals, H, more=(), after=None) -> float:
    """Time of scaled_dot_product_attention of rows q [B, D] over keys and
    values [B, S, D] concatenated beforehand: the attention kernels'
    library yardstick. With `more` (further (keys, vals) pairs of the same
    shape) call i reads pair i mod the count; `after(i)` (K15's slot
    write) runs after call i."""
    B, S, D = keys.shape
    heads = lambda t, s: t.reshape(B, s, H, D // H).transpose(1, 2)
    sq = heads(q.contiguous(), 1)
    sets = [(heads(k, S), heads(v, S)) for k, v in ((keys, vals), *more)]

    def call(i):
        torch.nn.functional.scaled_dot_product_attention(
            sq, *sets[i % len(sets)])
        if after is not None:
            after(i % len(sets))
    return time_ms(rotating(call, len(sets)))


# Steps at which the bf16 attention kernels K2, K8, K9 and K15 are timed:
# the slope over them is the time per generated slot, the intercept the
# prefix and the fixed cost.
ATTN_STEPS = (1, 33, MAIN["entry_length"] - 1)


def attention_step_times(call, q, kn, vn, pk, pv, gk, gv, R, H,
                         scales=None, write=None, steps=ATTN_STEPS) -> dict:
    """An attention kernel's bf16 times at each of `steps` beside SDPA's
    and the bound. `call(step, layer)` runs the kernel. `ms`
    repeats one layer (part of its 50-75 MB stays in the L2); `rotated_ms`
    walks the layers i mod L, and `library_rotated_ms` SDPA over at least
    two key sets of other layers (each pass over more than twice the L2),
    so that both read device memory as the bound assumes. `scales`
    (pks, pvs, gks, gvs; pks/pvs None for a prefix of q's type): K9's int8
    levels, which the bound counts at a byte each with their f32 scales
    and SDPA reads dequantised beforehand. `write(step, layer)`: K15's
    slot write, which the bound counts (k_new/v_new read and written) and
    which follows each SDPA call as `index_copy_`."""
    L, N, K, D = pk.shape
    B, layer = q.shape[0], L // 2
    pks, pvs, gks, gvs = scales or (None,) * 4
    out = {}
    for step in steps:
        S = K + step + 1

        def joined(l):
            def deq(x, sc):  # levels times their scales, in q's type
                return x if sc is None else (x.float() * sc[..., None]).to(
                    q.dtype)
            return tuple(torch.cat([
                deq(p[l], None if ps is None else ps[l, :, 0]
                    ).repeat_interleave(R, 0),
                deq(g[:, l, :step], None if gs is None else
                    gs[:, l, 0, :step]), n[:, None]], 1)
                for p, ps, g, gs, n in ((pk, pks, gk, gks, kn),
                                        (pv, pvs, gv, gvs, vn)))

        n_sets = max(2, -(-L2_FLUSH_BYTES // (2 * B * S * D * 2)))
        sets = [joined((layer + i) % L) for i in range(n_sets)]
        nbytes = (3 * B * D * q.element_size()
                  + 2 * N * K * D * pk.element_size()
                  + 2 * B * step * D * gk.element_size() + B * D * 4)
        if pks is not None:
            nbytes += 2 * N * K * 4
        if gks is not None:
            nbytes += 2 * B * step * 4
        if write is not None:
            nbytes += 2 * B * D * q.element_size()
        b_ms, b_by = bound_ms(nbytes, 4.0 * B * D * S, torch.bfloat16)
        after = None if write is None else (
            lambda i: write(step, (layer + i) % L))
        out[step] = dict(
            ms=time_ms(lambda: call(step, layer)),
            rotated_ms=time_ms(rotating(lambda i: call(step, i), L)),
            library_ms=sdpa_ms(q, *sets[0], H, after=after),
            library_rotated_ms=sdpa_ms(q, *sets[0], H, more=sets[1:],
                                       after=after),
            bound_ms=b_ms, bound_by=b_by)
        del sets
    return out


def ptxas_report(log_text: str) -> dict:
    """Registers and spill bytes of each kernel in `_build`'s -Xptxas -v
    log: {mangled name: {"registers": n, "spill_stores": n,
    "spill_loads": n}}."""
    report, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            report[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            report[name].update(spill_stores=int(m.group(1)),
                                spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report[name]["registers"] = int(m.group(1))
    return report


def async_attn_instance(mangled: str) -> str:
    """'bf16 cache int8 prefix int8 hd64' for the mangled name of
    async_attn<T, C, P, HD, kInReg> (int8_t mangles as 'a'; a repeated T
    as a substitution), with ' inreg' for K6's policy (kInReg true)."""
    m = re.search(r"async_attnI(13__nv_bfloat16|f)(.*?)Li(\d+)ELb([01])E",
                  mangled)
    t = "bf16" if m.group(1) != "f" else "f32"
    cache = "int8" if m.group(2).startswith("a") else t
    prefix = "int8" if m.group(2) == "aa" else t
    inreg = " inreg" if m.group(4) == "1" else ""
    return f"{t} cache {cache} prefix {prefix} hd{m.group(3)}{inreg}"


def quant_write_instance(mangled: str) -> str:
    """'write_gen_slot_q<bf16, 4>' (value type, units a lane) for K5's
    mangled kernel name."""
    m = re.search(r"write_gen_slot_qI(13__nv_bfloat16|f)Li(\d+)E", mangled)
    t = "bf16" if m.group(1) != "f" else "f32"
    return f"write_gen_slot_q<{t}, {m.group(2)}>"


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def lm_head_instance(mangled: str) -> str:
    """'lm_head_wgmma<128>', 'lm_head_wgmma_streamed', 'lm_head_merge',
    'lm_head_pass1<bf16>', ... for a mangled kernel name of
    csrc/lm_head.cu."""
    m = re.search(r"\d(lm_head_[a-z0-9_]+?)(ILi(\d+)E|I13__nv_bfloat16E|IfE)?"
                  r"E", mangled)
    arg = {None: "", "I13__nv_bfloat16E": "<bf16>", "IfE": "<f32>"}.get(
        m.group(2), f"<{m.group(3)}>")
    return m.group(1) + arg


def lm_head_times(gen, shapes, V=MAIN["V"], D=MAIN["D"]) -> dict:
    """K1 against its plain version at each of `shapes` ({key: (B rows,
    R)}) over a vocab of V rows of width D, in bf16 and f32: the top-R
    indices equal, the values and logsumexp within 2e-3 (bf16) and 1e-4
    (f32); the all-ties case; the bf16 time beside the plain version's,
    the bound and the cuBLAS product alone (`torch.matmul` of h and w^T
    in bf16, the logits written) as a yardstick of the product's rate."""
    from capdec_tpu_torch.ops import _build, lm_head
    # Operands on a coarse grid (h in quarters, w in eighths, |.| <= 1):
    # every partial sum is exact in f32, so any summation order gives the
    # same logits and the top-R indices (with their many exact ties) must
    # match the plain version's exactly.
    w = torch.randint(-4, 5, (V, D), generator=gen, device=DEVICE) / 8
    out = {}
    for key, (B, R) in shapes.items():
        h = torch.randint(-4, 5, (B, D), generator=gen, device=DEVICE) / 4
        res = {}
        for dtype, tol in ((torch.bfloat16, 2e-3), (torch.float32, 1e-4)):
            hd, wd = h.to(dtype), w.to(dtype)
            kv, ki, kl = lm_head.lm_head_topk(hd, wd, R)
            pv, pi, pl = lm_head.lm_head_topk_plain(hd, wd, R)
            torch.cuda.synchronize()
            require(torch.equal(ki, pi),
                    f"K1 {dtype} B={B}: top-R indices differ")
            err = max(max_err(kv, pv), max_err(kl, pl))
            require(err <= tol, f"K1 {dtype} B={B}: max abs err {err} > "
                    f"{tol}")
            res[dtype] = (err, hd, wd)
        # all ties: the lowest indices win, in order
        ties = lm_head.lm_head_topk(
            torch.zeros(B, D, device=DEVICE, dtype=torch.bfloat16),
            torch.ones(V, D, device=DEVICE, dtype=torch.bfloat16), R)[1]
        require(torch.equal(ties.cpu(), torch.arange(R).expand(B, R)),
                f"K1 B={B}: all-ties case must return indices 0..R-1")
        err, hd, wd = res[torch.bfloat16]
        b_ms, b_by = bound_ms((V * D + B * D) * 2 + B * R * 12 + B * 4,
                              2.0 * B * D * V, torch.bfloat16)
        out[key] = dict(
            max_abs_err=err, max_abs_err_f32=res[torch.float32][0],
            ms=time_ms(lambda: lm_head.lm_head_topk(hd, wd, R)),
            plain_ms=time_ms(lambda: lm_head.lm_head_topk_plain(hd, wd, R)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            cublas_ms=time_ms(lambda: torch.matmul(hd, wd.t())),
            plan=lm_head.lm_head_plan(B, V, D, R, 2,
                                      _build.sm_count(hd.device)),
            shape=f"B={B} V={V} D={D} R={R} bf16")
    return out


def check_lm_head(gen, ptxas):
    """K1 at both served shapes of the batch-64 paths (lm_head_times): the
    beam paths' B = 320 rows, R = 5 and greedy's B = 64, R = 1 (under
    "greedy_r1"), each with its own bound; its instances must build
    without spills (no one PyTorch call computes K1: `library_ms` is
    null)."""
    from capdec_tpu_torch.ops import lm_head
    n0 = lm_head.lm_head_topk.streamed_launches
    out = lm_head_times(gen, {"beam": (MAIN["N"] * MAIN["R"], MAIN["R"]),
                              "greedy_r1": (MAIN["N"], 1)})
    require(lm_head.lm_head_topk.streamed_launches == n0,
            f"K1 at D {MAIN['D']} took the streamed kernel")
    k1 = {lm_head_instance(name): rep for name, rep in ptxas.items()
          if "lm_head_" in name}
    require(not ptxas or "lm_head_wgmma<128>" in k1,
            f"ptxas: K1 instances {sorted(k1)}")
    for name, rep in k1.items():
        require(rep.get("spill_stores") == 0 and rep.get("spill_loads") == 0,
                f"{name} spills: {rep}")
    return dict(name="lm_head_topk", route="cuda",
                source="capdec_tpu_torch/csrc/lm_head.cu",
                replaces="capdec_tpu/ops/lm_head.py:259", **out["beam"],
                greedy_r1=out["greedy_r1"], ptxas=k1)


def check_decode_attention(gen):
    """K2 against its plain version: bf16 and f32, steps 1, 17 and 66
    under e_cap 16 and 72, NaN in the slots it must not read (at and above
    the step, and the next layer's slot 0). Timed at ATTN_STEPS."""
    from capdec_tpu_torch.ops import decode_attention as da
    N, R, L, K, E, D, H = (MAIN[k] for k in ("N", "R", "L", "K", "E", "D",
                                             "H"))
    B, hd, layer = N * R, D // H, L // 2

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)

    errs = {}
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        qkv = rand(B, 3 * D, dtype=dtype)  # q/k/v as views, as on the path
        q, kn, vn = qkv.split(D, dim=-1)
        pk, pv = rand(L, N, K, D, dtype=dtype), rand(L, N, K, D, dtype=dtype)
        gk0, gv0 = rand(B, L, E, D, dtype=dtype), rand(B, L, E, D, dtype=dtype)
        err = 0.0
        for step in (1, 17, MAIN["entry_length"] - 1):
            gk, gv = gk0.clone(), gv0.clone()
            gk[:, :, step:] = float("nan")  # stale slots must never be read
            gv[:, :, step:] = float("nan")
            gk[:, layer + 1, 0] = float("nan")  # nor the next layer's
            gv[:, layer + 1, 0] = float("nan")
            for e_cap in (16, E):
                args = (q, kn, vn, pk, pv, gk, gv, step, layer)
                kw = dict(beams_per_image=R, head_dim=hd, e_cap=e_cap)
                out = da.beam_decode_attention_rowmajor(*args, **kw)
                ref = da.beam_decode_attention_rowmajor_plain(*args, **kw)
                torch.cuda.synchronize()
                require(bool(torch.isfinite(out).all()),
                        f"K2 {dtype} step {step}: non-finite output")
                require(torch.allclose(out, ref, atol=tol, rtol=tol),
                        f"K2 {dtype} step {step} e_cap {e_cap}: "
                        f"max abs err {max_err(out, ref)}")
                err = max(err, max_err(out, ref))
        errs[dtype] = err
        if dtype == torch.bfloat16:
            timed = (q, kn, vn, pk, pv, gk, gv)
    # time the longest read: the last step under the last stage bound,
    # and the steps ATTN_STEPS, each also rotated past the L2
    q, kn, vn, pk, pv, gk, gv = timed
    step = MAIN["entry_length"] - 1
    args = (q, kn, vn, pk, pv, gk, gv, step, layer)
    kw = dict(beams_per_image=R, head_dim=hd, e_cap=E)
    steps = attention_step_times(
        lambda s, l: da.beam_decode_attention_rowmajor(
            q, kn, vn, pk, pv, gk, gv, s, l, **kw), *timed, R, H)
    return dict(
        name="beam_decode_attention_rowmajor", route="cuda",
        source="capdec_tpu_torch/csrc/decode_attention_async.cu",
        replaces="capdec_tpu/ops/decode_attention.py:719",
        max_abs_err=errs[torch.bfloat16],
        max_abs_err_f32=errs[torch.float32],
        **{k: steps[step][k] for k in ("ms", "rotated_ms", "bound_ms",
                                       "bound_by", "library_ms",
                                       "library_rotated_ms")},
        plain_ms=time_ms(
            lambda: da.beam_decode_attention_rowmajor_plain(*args, **kw)),
        steps=steps,
        library_note="scaled_dot_product_attention on keys concatenated "
                     "beforehand",
        shape=f"N={N} R={R} K={K} step={step} e_cap={E} D={D} bf16")


# ClipCap's served shape: the MLP mapper's prefix of 10 slots at batch 512
# x beam 5, where K2's plan widens its chunks (ops/decode_attention.py
# attention_plan)
SHORT = dict(N=512, K=10)
SHORT_STEPS = (0, 33, MAIN["entry_length"] - 1)


def check_short_prefix_attention(gen) -> dict:
    """K2 at ClipCap's served shape (N 512 x R 5, K 10, bf16): against its
    plain version at steps 0, 16, 17 and 66 under e_cap 16 and 72, NaN in
    the slots it must not read, every call on a widened plan; timed at
    SHORT_STEPS, one layer and rotated, beside its bytes bound, the plain
    version and SDPA on keys concatenated beforehand (the `k10` key of
    K2's row)."""
    from capdec_tpu_torch.ops import decode_attention as da
    R, L, E, D, H = (MAIN[k] for k in ("R", "L", "E", "D", "H"))
    N, K = SHORT["N"], SHORT["K"]
    B, hd, layer = N * R, D // H, L // 2
    rand = lambda *s: torch.randn(*s, generator=gen, device=DEVICE).to(
        torch.bfloat16)
    q, kn, vn = rand(B, 3 * D).split(D, dim=-1)
    pk, pv = rand(L, N, K, D), rand(L, N, K, D)
    gk, gv = rand(B, L, E, D), rand(B, L, E, D)
    k2 = da.beam_decode_attention_rowmajor
    err, calls, w0 = 0.0, 0, k2.widened_launches
    for step in (0, 16, 17, MAIN["entry_length"] - 1):
        sk, sv = gk.clone(), gv.clone()
        sk[:, :, step:] = float("nan")  # stale slots must never be read
        sv[:, :, step:] = float("nan")
        sk[:, layer + 1, 0] = float("nan")  # nor the next layer's
        sv[:, layer + 1, 0] = float("nan")
        for e_cap in (16, E):
            args = (q, kn, vn, pk, pv, sk, sv, step, layer)
            kw = dict(beams_per_image=R, head_dim=hd, e_cap=e_cap)
            out = k2(*args, **kw)
            ref = da.beam_decode_attention_rowmajor_plain(*args, **kw)
            torch.cuda.synchronize()
            calls += 1
            require(bool(torch.isfinite(out).all()) and
                    torch.allclose(out, ref, atol=2e-2, rtol=2e-2),
                    f"K2 at K {K}, step {step} e_cap {e_cap}: max abs err "
                    f"{max_err(out, ref)}")
            err = max(err, max_err(out, ref))
        del sk, sv
    require(k2.widened_launches - w0 == calls,
            f"K2 at K {K}: {k2.widened_launches - w0} of {calls} calls "
            f"on a widened plan")
    step = MAIN["entry_length"] - 1
    kw = dict(beams_per_image=R, head_dim=hd, e_cap=E)
    steps = attention_step_times(
        lambda s, l: k2(q, kn, vn, pk, pv, gk, gv, s, l, **kw),
        q, kn, vn, pk, pv, gk, gv, R, H, steps=SHORT_STEPS)
    for s in SHORT_STEPS:
        steps[s]["plain_ms"] = time_ms(
            lambda: da.beam_decode_attention_rowmajor_plain(
                q, kn, vn, pk, pv, gk, gv, s, layer, **kw))
        steps[s]["plan"] = da.attention_plan(N, R, K, D, hd, s, 2)
    return dict(max_abs_err=err, widened_calls=calls, **steps[step],
                steps=steps, shape=f"N={N} R={R} K={K} step={step} "
                                   f"e_cap={E} D={D} bf16")


def _lane_src(gen, N, R):
    """Fork sources obeying the lane invariant: each image keeps its beam
    in a random half of its lanes; the other lanes copy a kept one."""
    src = torch.arange(N * R)
    for n in range(N):
        keep = torch.randperm(R, generator=gen)[:max(1, R // 2)]
        for r in range(R):
            if r not in keep:
                j = torch.randint(len(keep), (1,), generator=gen).item()
                src[n * R + r] = n * R + keep[j]
    return src


def rowmajor_write_checks(gen, fn, plain, what, B, L, E, D, steps,
                          dtypes=(torch.bfloat16, torch.float32)):
    """The row-major slot write `fn` (K3 or K14) bit-identical to `plain`
    on caches [B, L, E, D], from the per-layer views of a qkv buffer, as
    decode_step hands them over, and from [B, L, D] tensors (the JAX
    form), at each of `steps` in each of `dtypes`; every other slot and
    the sources untouched. Returns the bf16 caches."""
    out = None
    for dtype in dtypes:
        rand = lambda *s: torch.randn(*s, generator=gen,
                                      device=DEVICE).to(dtype)
        k0, v0 = rand(B, L, E, D), rand(B, L, E, D)
        (views,) = qkv_view_sets(gen, L, B, D, dtype, n=1)
        held = [t.clone() for t in views[0] + views[1]]
        stacked = tuple(torch.stack(side, dim=1) for side in views)
        for step in steps:
            other = torch.arange(E, device=DEVICE) != step
            for form, (nk, nv) in (("views", views), ("tensors", stacked)):
                a = fn(k0.clone(), v0.clone(), nk, nv, step)
                b = plain(k0.clone(), v0.clone(), nk, nv, step)
                torch.cuda.synchronize()
                require(torch.equal(a["k"], b["k"]) and
                        torch.equal(a["v"], b["v"]),
                        f"{what} {dtype} {form} step {step}: slot write "
                        "differs from the plain version")
                require(torch.equal(a["k"][:, :, other], k0[:, :, other]) and
                        torch.equal(a["v"][:, :, other], v0[:, :, other]),
                        f"{what} {dtype} {form} step {step}: touched "
                        "another slot")
                del a, b
        require(all(torch.equal(t, h) for t, h in
                    zip(views[0] + views[1], held)),
                f"{what} {dtype}: a source changed")
        if dtype == torch.bfloat16:
            out = (k0, v0)
        del views, held, stacked
    return out


def rowmajor_write_times(gen, fn, plain, k, v) -> dict:
    """Time a bf16 row-major slot write `fn` (K3, K14) as decode_step
    issues it, from the per-layer views of qkv buffers rotated with the
    slots past the L2; beside it the write after stacking each side
    (`stacked_ms`, decode_step's route before the write took views), its
    plain version, the library route (stack, then `index_copy_`), the
    empty kernel on its grid (`floor_ms`), the bound (the new K/V read
    once and written once) and, from [B, L, D] tensors, the write and
    `index_copy_` alone (slot_write_times)."""
    from capdec_tpu_torch.ops import _build, cache_reorder as cr
    B, L, E, D = k.shape
    sets = qkv_view_sets(gen, L, B, D)
    plan = cr.slot_write_plan(L, B, D, 2, _build.sm_count(k.device))
    tensors = slot_write_times(gen, fn, plain, k, v, (B, L, D))
    b_ms, b_by = bound_ms(2 * 2 * B * L * D * 2, 0, torch.bfloat16)
    return dict(
        ms=time_ms(views_write_call(fn, k, v, sets)),
        stacked_ms=time_ms(views_write_call(fn, k, v, sets, stack_dim=1)),
        plain_ms=time_ms(views_write_call(plain, k, v, sets)),
        library_ms=time_ms(views_write_call(stack_index_copy(E, dim=1), k, v,
                                            sets)),
        bound_ms=b_ms, bound_by=b_by,
        floor_ms=time_ms(empty_grid_call(plan)),
        tensor_form_ms=tensors["ms"],
        library_tensor_ms=tensors["library_ms"], plan=plan, sets=len(sets))


def fork_copy_checks(k, v, src, count, what) -> dict:
    """K4 on the caches k/v [B, L, E, D] bit-identical to its plain
    version, rows that keep their lane and slots >= count untouched.
    Timed beside its plain version, the empty kernel on its grid and the
    bound: each source row's slots < count read once, each forked row's
    written once."""
    from capdec_tpu_torch.ops import cache_reorder as cr
    B, L, E, D = k.shape
    forked = src != torch.arange(B, device=DEVICE)
    a = cr.copy_forked_rows_bounded(k.clone(), v.clone(), src, count)
    b = cr.copy_forked_rows_bounded_plain(k.clone(), v.clone(), src, count)
    torch.cuda.synchronize()
    require(torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"]),
            f"K4 {what}: fork copy differs from the plain version")
    require(torch.equal(a["k"][~forked], k[~forked]) and
            torch.equal(a["v"][:, :, count:], v[:, :, count:]),
            f"K4 {what}: touched rows or slots outside its contract")
    del a, b
    forks = int(forked.sum())
    sources = int(src[forked].unique().numel())
    b4, by4 = bound_ms(2 * (sources + forks) * L * count * D *
                       k.element_size(), 0, torch.bfloat16)
    plan = cr.fork_copy_plan(B, L, count, D * k.element_size())
    return dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: cr.copy_forked_rows_bounded(k, v, src, count)),
        plain_ms=time_ms(
            lambda: cr.copy_forked_rows_bounded_plain(k, v, src, count)),
        bound_ms=b4, bound_by=by4, library_ms=None,
        floor_ms=time_ms(empty_grid_call(plan)), plan=plan,
        shape=f"B={B} forks={forks} sources={sources} L={L} count={count} "
              f"D={D} {str(k.dtype)[6:]} ({what})")


def _spread_src(gen, B):
    """Fork sources that keep the lane invariant but cross images: a
    random half of the rows keep their beam, each other row copies one of
    them, anywhere in the batch."""
    keep = torch.randperm(B, generator=gen)[:B // 2]
    pick = torch.randint(len(keep), (B,), generator=gen)
    src = keep[pick]
    src[keep] = keep
    return src


def check_cache_kernels(gen, ptxas):
    """K3 (rowmajor_write_checks' cases at steps 0, 7, 8, 66) and K4 at
    the main path's shapes, bf16 and f32; K4 also on sources that cross
    images; each kernel's instances built without spills."""
    from capdec_tpu_torch.ops import cache_reorder as cr
    N, R, L, E, D = (MAIN[k] for k in ("N", "R", "L", "E", "D"))
    B = N * R
    regs3 = {t: rep for t, rep in instances(
        ptxas, "write_gen_slot_views", slot_write_instance, 8).items()
        if t.endswith("row>")}
    regs4 = instances(ptxas, "copy_forked_rows_bounded", fork_copy_instance,
                      1)
    k0, v0 = rowmajor_write_checks(
        gen, cr.write_gen_slot_chunk, cr.write_gen_slot_chunk_plain, "K3", B,
        L, E, D, (0, 7, 8, MAIN["entry_length"] - 1))
    cpu_gen = torch.Generator().manual_seed(SEED)
    src = _lane_src(cpu_gen, N, R).to(DEVICE)
    count = MAIN["entry_length"] - 1
    k4_f32 = fork_copy_checks(k0.float(), v0.float(), src, count, "f32")
    spread = _spread_src(cpu_gen, B).to(DEVICE)
    a = cr.copy_forked_rows_bounded(k0.clone(), v0.clone(), spread, count)
    b = cr.copy_forked_rows_bounded_plain(k0.clone(), v0.clone(), spread,
                                          count)
    torch.cuda.synchronize()
    require(torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"]),
            "K4: fork copy across images differs from the plain version")
    del a, b
    k3 = dict(
        name="write_gen_slot_chunk", route="cuda",
        source="capdec_tpu_torch/csrc/cache_reorder.cu",
        replaces="capdec_tpu/ops/cache_reorder.py:355",
        max_abs_err=0.0, max_abs_err_f32=0.0,
        **rowmajor_write_times(gen, cr.write_gen_slot_chunk,
                               cr.write_gen_slot_chunk_plain, k0, v0),
        ptxas=regs3,
        library_note="torch.stack of each side on dim 1, then index_copy_ "
                     "on dim 2 of k and v (library_tensor_ms: index_copy_ "
                     "from [B, L, D] tensors)",
        shape=f"B={B} L={L} E={E} D={D} bf16, from the per-layer views of "
              f"[B, 3D] qkv buffers rotated over >{L2_FLUSH_BYTES >> 20} MiB"
              f" and the {E} slots; stacked_ms: both sides stacked first; "
              "floor: the empty kernel on its grid; tensor_form_ms: from "
              "[B, L, D] tensors")
    k4 = dict(name="copy_forked_rows_bounded", route="cuda",
              source="capdec_tpu_torch/csrc/cache_reorder.cu",
              replaces="capdec_tpu/ops/cache_reorder.py:210",
              **fork_copy_checks(k0, v0, src, count, "main path"),
              max_abs_err_f32=0.0, f32_ms=k4_f32["ms"], ptxas=regs4,
              library_note="null: no one PyTorch call copies only the "
                           "forked rows' live slots in place")
    return [k3, k4]


def _int8(gen, *shape):
    return torch.randint(-127, 128, shape, generator=gen, device=DEVICE,
                         dtype=torch.int8)


def quantising_write_call(fn, k, v, ks, vs, sets):
    """A call of K5 (or its plain version) `fn` on the caches k/v and
    scales ks/vs: call i quantises bf16 new K/V set i of a rotation into
    slot i mod E, so that no pass fits in the L2."""
    n, E = len(sets), k.shape[2]
    return rotating(lambda i: fn(k, v, ks, vs, *sets[i % n], i % E), n * E)


def check_quantising_write(gen, ptxas):
    """K5: levels and scales bit-identical to the plain version; every
    other slot untouched; its instances built without spills."""
    from capdec_tpu_torch.ops import cache_reorder as cr
    N, R, L, E, D = (MAIN[k] for k in ("N", "R", "L", "E", "D"))
    B = N * R
    regs = instances(ptxas, "write_gen_slot_q", quant_write_instance, 4)
    k0, v0 = _int8(gen, B, L, E, D), _int8(gen, B, L, E, D)
    ks0, vs0 = (torch.rand(B, L, 1, E, generator=gen, device=DEVICE)
                for _ in range(2))
    for dtype in (torch.bfloat16, torch.float32):
        nk, nv = (torch.randn(B, L, D, generator=gen, device=DEVICE).to(dtype)
                  for _ in range(2))
        nk[0, 1] = 0  # a zero row takes scale 1
        for step in (0, 7, 8, MAIN["entry_length"] - 1):
            args = (nk, nv, step)
            a = cr.write_gen_slot_chunk_q(k0.clone(), v0.clone(), ks0.clone(),
                                          vs0.clone(), *args)
            b = cr.write_gen_slot_chunk_q_plain(k0.clone(), v0.clone(),
                                                ks0.clone(), vs0.clone(),
                                                *args)
            torch.cuda.synchronize()
            for name in ("k", "v", "ks", "vs"):
                require(torch.equal(a[name], b[name]),
                        f"K5 {dtype} step {step}: {name} differs from the "
                        "plain version")
            other = torch.arange(E, device=DEVICE) != step
            require(torch.equal(a["k"][:, :, other], k0[:, :, other]) and
                    torch.equal(a["vs"][..., other], vs0[..., other]),
                    f"K5 {dtype} step {step}: touched another slot")
    # timed over rotating bf16 new K/V sets and slots (no pass fits in L2)
    timed = (k0.clone(), v0.clone(), ks0.clone(), vs0.clone(),
             new_kv_sets(gen, (B, L, D)))

    # new K/V in (bf16), levels and scales out; ~6 f32 operations a value
    b_ms, b_by = bound_ms(2 * B * L * D * 2 + 2 * B * L * (D + 4),
                          6.0 * 2 * B * L * D, torch.float32)
    return dict(
        name="write_gen_slot_chunk_q", route="cuda",
        source="capdec_tpu_torch/csrc/cache_reorder.cu",
        replaces="capdec_tpu/ops/cache_reorder.py:413",
        max_abs_err=0.0, max_abs_err_f32=0.0,
        ms=time_ms(quantising_write_call(cr.write_gen_slot_chunk_q,
                                         *timed)),
        plain_ms=time_ms(quantising_write_call(
            cr.write_gen_slot_chunk_q_plain, *timed)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        library_note="null: no one PyTorch call quantises and writes a slot",
        ptxas=regs,
        plan=cr.quant_write_plan(B, L, D),
        shape=f"B={B} L={L} E={E} D={D} bf16 -> int8, inputs rotated over "
              f"{len(timed[4])} sets and the {E} slots")


def check_int8_attention(gen):
    """K6 against its plain version over random int8 levels: bf16 and f32,
    steps 0, 1, 17 and 66 under e_cap 16 and 72, with NaN scales at the
    slots it must not read. Timed at ATTN_STEPS, one layer and rotated."""
    from capdec_tpu_torch.ops import decode_attention as da
    N, R, L, K, E, D, H = (MAIN[k] for k in ("N", "R", "L", "K", "E", "D",
                                             "H"))
    B, hd, layer = N * R, D // H, L // 2

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)

    gk, gv = _int8(gen, B, L, E, D), _int8(gen, B, L, E, D)
    gks0, gvs0 = (torch.rand(B, L, 1, E, generator=gen, device=DEVICE)
                  * 3 / 127 for _ in range(2))
    errs = {}
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        q, kn, vn = rand(B, 3 * D, dtype=dtype).split(D, dim=-1)
        pk, pv = rand(L, N, K, D, dtype=dtype), rand(L, N, K, D, dtype=dtype)
        err = 0.0
        for step in (0, 1, 17, MAIN["entry_length"] - 1):
            gks, gvs = gks0.clone(), gvs0.clone()
            gks[..., step:] = float("nan")  # never read
            gvs[..., step:] = float("nan")
            for e_cap in (16, E):
                args = (q, kn, vn, pk, pv, gk, gv, gks, gvs, step, layer)
                kw = dict(beams_per_image=R, head_dim=hd, e_cap=e_cap)
                out = da.beam_decode_attention_rowmajor_q(*args, **kw)
                ref = da.beam_decode_attention_rowmajor_q_plain(*args, **kw)
                torch.cuda.synchronize()
                require(bool(torch.isfinite(out).all()),
                        f"K6 {dtype} step {step}: non-finite output")
                require(torch.allclose(out, ref, atol=tol, rtol=tol),
                        f"K6 {dtype} step {step} e_cap {e_cap}: "
                        f"max abs err {max_err(out, ref)}")
                err = max(err, max_err(out, ref))
        errs[dtype] = err
        if dtype == torch.bfloat16:
            timed = (q, kn, vn, pk, pv, gks, gvs)
    # time the longest read (step 66 under e_cap 72; the NaN tail lies
    # above it) and the steps ATTN_STEPS, each also rotated past the L2
    q, kn, vn, pk, pv, gks, gvs = timed
    step = MAIN["entry_length"] - 1
    args = (q, kn, vn, pk, pv, gk, gv, gks, gvs, step, layer)
    kw = dict(beams_per_image=R, head_dim=hd, e_cap=E)
    steps = attention_step_times(
        lambda s, l: da.beam_decode_attention_rowmajor_q(
            q, kn, vn, pk, pv, gk, gv, gks, gvs, s, l, **kw),
        q, kn, vn, pk, pv, gk, gv, R, H, scales=(None, None, gks, gvs))
    return dict(
        name="beam_decode_attention_rowmajor_q", route="cuda",
        source="capdec_tpu_torch/csrc/decode_attention_async.cu",
        replaces="capdec_tpu/ops/decode_attention.py:646",
        max_abs_err=errs[torch.bfloat16],
        max_abs_err_f32=errs[torch.float32],
        **{k: steps[step][k] for k in ("ms", "rotated_ms", "bound_ms",
                                       "bound_by", "library_ms",
                                       "library_rotated_ms")},
        plain_ms=time_ms(
            lambda: da.beam_decode_attention_rowmajor_q_plain(*args, **kw)),
        steps=steps,
        library_note="scaled_dot_product_attention on keys and values "
                     "dequantised and concatenated beforehand",
        shape=f"N={N} R={R} K={K} step={step} e_cap={E} D={D} bf16 q, "
              "int8 cache")


def check_whole_row_fork(gen):
    """K7 bit-identical to its plain version; unforked rows untouched."""
    from capdec_tpu_torch.ops import cache_reorder as cr
    N, R, L, E, D = (MAIN[k] for k in ("N", "R", "L", "E", "D"))
    B = N * R
    src = _lane_src(torch.Generator().manual_seed(SEED), N, R).to(DEVICE)
    forked = src != torch.arange(B, device=DEVICE)
    for dtype in (torch.int8, torch.bfloat16):
        k0 = _int8(gen, B, L, E, D).to(dtype)
        v0 = _int8(gen, B, L, E, D).to(dtype)
        a = cr.copy_forked_rows(k0.clone(), v0.clone(), src)
        b = cr.copy_forked_rows_plain(k0.clone(), v0.clone(), src)
        torch.cuda.synchronize()
        require(torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"]),
                f"K7 {dtype}: fork copy differs from the plain version")
        require(torch.equal(a["k"][~forked], k0[~forked]) and
                torch.equal(a["v"][~forked], v0[~forked]),
                f"K7 {dtype}: touched a row that kept its lane")
        if dtype == torch.int8:
            k, v = k0, v0
    forks = int(forked.sum())
    sources = int(src[forked].unique().numel())
    b_ms, b_by = bound_ms(2 * (sources + forks) * L * E * D, 0,
                          torch.bfloat16)
    return dict(
        name="copy_forked_rows", route="cuda",
        source="capdec_tpu_torch/csrc/cache_reorder.cu",
        replaces="capdec_tpu/ops/cache_reorder.py:136",
        max_abs_err=0.0, max_abs_err_f32=0.0,
        ms=time_ms(lambda: cr.copy_forked_rows(k, v, src)),
        plain_ms=time_ms(lambda: cr.copy_forked_rows_plain(k, v, src)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        library_note="null: no one PyTorch call copies only the forked "
                     "rows in place",
        shape=f"B={B} forks={forks} sources={sources} L={L} E={E} D={D} "
              "int8")


def check_chunked_attention(gen):
    """K8 against its plain version: bf16 and f32, steps 1, 8, 17 and 66
    with NaN in the slots it must not read (at and above the step, and the
    next layer's slot 0), R = 5 (beam) and R = 1 (greedy's fused route).
    Timed at ATTN_STEPS, R = 5."""
    from capdec_tpu_torch.ops import decode_attention as da
    N, R, L, K, E, D, H = (MAIN[k] for k in ("N", "R", "L", "K", "E", "D",
                                             "H"))
    hd, layer = D // H, L // 2

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)

    errs = {}
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        err = 0.0
        for r in (R, 1):
            B = N * r
            q, kn, vn = rand(B, 3 * D, dtype=dtype).split(D, dim=-1)
            pk, pv = (rand(L, N, K, D, dtype=dtype) for _ in range(2))
            gk0, gv0 = (rand(B, L, E, D, dtype=dtype) for _ in range(2))
            for step in (1, 8, 17, MAIN["entry_length"] - 1):
                gk, gv = gk0.clone(), gv0.clone()
                gk[:, :, step:] = float("nan")  # never read
                gv[:, :, step:] = float("nan")
                gk[:, layer + 1, 0] = float("nan")  # nor the next layer's
                gv[:, layer + 1, 0] = float("nan")
                args = (q, kn, vn, pk, pv, gk, gv, step, layer)
                kw = dict(beams_per_image=r, head_dim=hd, chunk=8)
                out = da.beam_decode_attention_chunked(*args, **kw)
                ref = da.beam_decode_attention_chunked_plain(*args, **kw)
                torch.cuda.synchronize()
                require(bool(torch.isfinite(out).all()),
                        f"K8 {dtype} R={r} step {step}: non-finite output")
                require(torch.allclose(out, ref, atol=tol, rtol=tol),
                        f"K8 {dtype} R={r} step {step}: max abs err "
                        f"{max_err(out, ref)}")
                err = max(err, max_err(out, ref))
            if dtype == torch.bfloat16 and r == R:
                timed = (q, kn, vn, pk, pv, gk, gv)
        errs[dtype] = err
    # time the longest read of the beam path (step 66; the NaN tail
    # lies above it) and the steps ATTN_STEPS, each also rotated past the L2
    q, kn, vn, pk, pv, gk, gv = timed
    step = MAIN["entry_length"] - 1
    args = (q, kn, vn, pk, pv, gk, gv, step, layer)
    kw = dict(beams_per_image=R, head_dim=hd, chunk=8)
    steps = attention_step_times(
        lambda s, l: da.beam_decode_attention_chunked(
            q, kn, vn, pk, pv, gk, gv, s, l, **kw), *timed, R, H)
    return dict(
        name="beam_decode_attention_chunked", route="cuda",
        source="capdec_tpu_torch/csrc/decode_attention_async.cu",
        replaces="capdec_tpu/ops/decode_attention.py:484",
        max_abs_err=errs[torch.bfloat16],
        max_abs_err_f32=errs[torch.float32],
        **{k: steps[step][k] for k in ("ms", "rotated_ms", "bound_ms",
                                       "bound_by", "library_ms",
                                       "library_rotated_ms")},
        plain_ms=time_ms(
            lambda: da.beam_decode_attention_chunked_plain(*args, **kw)),
        steps=steps,
        library_note="scaled_dot_product_attention on keys concatenated "
                     "beforehand",
        shape=f"N={N} R={R} K={K} step={step} E={E} chunk=8 D={D} bf16")


def check_chunked_int8_attention(gen):
    """K9 against its plain version over random int8 levels with NaN
    scales at the slots it must not read (at and above the step, and the
    next layer's slot 0): bf16 and f32, with and without the int8 prefix,
    R = 5 and R = 1, steps 1, 17 and 66. Timed at ATTN_STEPS for R = 5
    with both prefix kinds and for R = 1 with the int8 prefix (path (e));
    the kernel entry reports R = 5 with the int8 prefix (path (b)), the
    others beside it."""
    from capdec_tpu_torch.ops import decode_attention as da
    N, R, L, K, E, D, H = (MAIN[k] for k in ("N", "R", "L", "K", "E", "D",
                                             "H"))
    hd, layer = D // H, L // 2
    scales = lambda *s: torch.rand(*s, generator=gen, device=DEVICE) * 3 / 127

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)

    errs, timed = {}, {}
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        err = 0.0
        for r in (R, 1):
            B = N * r
            q, kn, vn = rand(B, 3 * D, dtype=dtype).split(D, dim=-1)
            gk, gv = _int8(gen, B, L, E, D), _int8(gen, B, L, E, D)
            gks0, gvs0 = scales(B, L, 1, E), scales(B, L, 1, E)
            for int8_prefix in (False, True):
                if int8_prefix:
                    pk, pv = _int8(gen, L, N, K, D), _int8(gen, L, N, K, D)
                    pre = dict(pks=scales(L, N, 1, K),
                               pvs=scales(L, N, 1, K))
                else:
                    pk, pv = (rand(L, N, K, D, dtype=dtype)
                              for _ in range(2))
                    pre = {}
                for step in (1, 17, MAIN["entry_length"] - 1):
                    gks, gvs = gks0.clone(), gvs0.clone()
                    for sc in (gks, gvs):
                        sc[..., step:] = float("nan")  # never read
                        sc[:, layer + 1, 0, 0] = float("nan")
                    args = (q, kn, vn, pk, pv, gk, gv, gks, gvs, step, layer)
                    kw = dict(beams_per_image=r, head_dim=hd, chunk=8, **pre)
                    out = da.beam_decode_attention_chunked_q(*args, **kw)
                    ref = da.beam_decode_attention_chunked_q_plain(*args,
                                                                   **kw)
                    torch.cuda.synchronize()
                    what = f"K9 {dtype} R={r} int8 prefix {int8_prefix} " \
                           f"step {step}"
                    require(bool(torch.isfinite(out).all()),
                            f"{what}: non-finite output")
                    require(torch.allclose(out, ref, atol=tol, rtol=tol),
                            f"{what}: max abs err {max_err(out, ref)}")
                    err = max(err, max_err(out, ref))
                if dtype == torch.bfloat16 and (r == R or int8_prefix):
                    # timed over every layer: the next layer's slot 0
                    # gets its scale back
                    gks[:, layer + 1, 0, 0] = gks0[:, layer + 1, 0, 0]
                    gvs[:, layer + 1, 0, 0] = gvs0[:, layer + 1, 0, 0]
                    timed[r, int8_prefix] = (args, kw)
        errs[dtype] = err
    step = MAIN["entry_length"] - 1
    res = {}
    for (r, int8_prefix), (args, kw) in timed.items():
        q, kn, vn, pk, pv, gk, gv, gks, gvs = args[:9]
        steps = attention_step_times(
            lambda s, l: da.beam_decode_attention_chunked_q(
                q, kn, vn, pk, pv, gk, gv, gks, gvs, s, l, **kw),
            q, kn, vn, pk, pv, gk, gv, r, H,
            scales=(kw.get("pks"), kw.get("pvs"), gks, gvs))
        res[r, int8_prefix] = dict(
            **{k: steps[step][k] for k in ("ms", "rotated_ms", "bound_ms",
                                           "bound_by", "library_ms",
                                           "library_rotated_ms")},
            plain_ms=time_ms(lambda: da.beam_decode_attention_chunked_q_plain(
                q, kn, vn, pk, pv, gk, gv, gks, gvs, step, layer, **kw)),
            steps=steps)
    return dict(
        name="beam_decode_attention_chunked_q", route="cuda",
        source="capdec_tpu_torch/csrc/decode_attention_async.cu",
        replaces="capdec_tpu/ops/decode_attention.py:569",
        max_abs_err=errs[torch.bfloat16],
        max_abs_err_f32=errs[torch.float32], **res[R, True],
        bf16_prefix=res[R, False], greedy_r1=res[1, True],
        library_note="scaled_dot_product_attention on keys and values "
                     "dequantised and concatenated beforehand",
        shape=f"N={N} R={R} K={K} step={step} E={E} chunk=8 D={D} bf16 q, "
              "int8 cache and int8 prefix (bf16_prefix: a bf16 prefix; "
              "greedy_r1: R=1, int8 prefix)")


def slot_write_instance(mangled: str) -> str:
    """'write_gen_slot_views<4, row>' (16-byte words a lane; the row-major
    layout of K3/K14 or the seq-major one of K13) for the mangled name of
    the slot write's kernel."""
    m = re.search(r"write_gen_slot_viewsILi(\d+)ELb([01])E", mangled)
    layout = "row" if m.group(2) == "1" else "seq"
    return f"write_gen_slot_views<{m.group(1)}, {layout}>"


def fork_copy_instance(mangled: str) -> str:
    """'copy_forked_rows_bounded<8>' (16-byte words a lane) for K4's
    mangled kernel name."""
    m = re.search(r"copy_forked_rows_boundedILi(\d+)E", mangled)
    return f"copy_forked_rows_bounded<{m.group(1)}>"


def instances(ptxas: dict, name: str, label, n: int) -> dict:
    """The `n` instances of kernel `name` in the ptxas report, labelled by
    `label`, each required to build without spills (none when the
    library was loaded, not built)."""
    regs = {label(m): rep for m, rep in ptxas.items() if name + "I" in m}
    require(not ptxas or len(regs) == n, f"ptxas: {name} reported {regs}")
    for t, rep in regs.items():
        require(rep.get("spill_stores") == 0 and rep.get("spill_loads") == 0,
                f"{t} spills: {rep}")
    return regs


def qkv_view_sets(gen, L, N, D, dtype=torch.bfloat16, n=None):
    """The slot writes' inputs as decode_step hands them over: (new_k,
    new_v), the per-layer k and v thirds of a [L, N, 3D] buffer of qkv
    rows, for n buffers (default: as many as one pass of K/V reads past
    L2_FLUSH_BYTES, for a rotation)."""
    n = n or -(-L2_FLUSH_BYTES // (2 * L * N * D * 2))
    sets = []
    for _ in range(n):
        qkv = torch.randn(L, N, 3 * D, generator=gen, device=DEVICE).to(dtype)
        sets.append(([t[:, D:2 * D] for t in qkv],
                     [t[:, 2 * D:] for t in qkv]))
    return sets


def views_write_call(fn, k, v, sets, stack_dim=None):
    """A call of a slot write `fn(k, v, new_k, new_v, step)` (K3, K13,
    K14, or a plain or library route) on the caches k/v (slots on dim 2):
    call i reads qkv set i of a rotation and writes slot i mod E; with
    `stack_dim` the per-layer views are first stacked on that dim (0:
    [L, N, D] for the seq-major cache, 1: [N, L, D] for the row-major),
    the route of decode_step before the write took views."""
    n, E = len(sets), k.shape[2]

    def call(i):
        nk, nv = sets[i % n]
        if stack_dim is not None:
            nk, nv = (torch.stack(s, dim=stack_dim) for s in (nk, nv))
        fn(k, v, nk, nv, i % E)
    return rotating(call, n * E)


def stack_index_copy(E, dim=0):
    """The library route of a slot write from views over E slots:
    torch.stack of each side on `dim` (0 seq-major, 1 row-major), then
    `index_copy_` into slot `step` of k and v."""
    idx = [torch.tensor([s], device=DEVICE) for s in range(E)]

    def call(k, v, nk, nv, step):
        k.index_copy_(2, idx[step], torch.stack(nk, dim=dim).unsqueeze(2))
        v.index_copy_(2, idx[step], torch.stack(nv, dim=dim).unsqueeze(2))
    return call


def empty_grid_call(plan):
    """A launch of the empty kernel on `plan`'s grid: the floor of any
    one launch of that grid on the smoke's timer."""
    from capdec_tpu_torch.ops import _build
    lib, stream = _build.library(), _build.stream(torch.device(DEVICE))
    return lambda: _build.check(lib.capdec_empty_grid(
        plan["blocks"], plan["threads"], stream), "empty_grid")


def check_seqmajor_write(gen, ptxas):
    """K13 bit-identical to its plain version at the greedy path's shapes
    (seq-major [L, N, E, D]) from the per-layer views of qkv buffers, as
    decode_step hands them over, and from [L, N, D] tensors, in bf16 and
    f32 at steps 0, 7, 8 and E-1; every other slot and the sources
    untouched; its four instances built without spills. Timed from views
    rotated past the L2, beside its plain version, the library route
    (stack, then `index_copy_`), the empty kernel on its grid (the floor
    of one launch) and, from stacked tensors, K13 alone."""
    from capdec_tpu_torch.ops import _build, cache_reorder as cr
    N, L, E, D = (MAIN[k] for k in ("N", "L", "E", "D"))
    regs = {t: rep for t, rep in instances(
        ptxas, "write_gen_slot_views", slot_write_instance, 8).items()
        if t.endswith("seq>")}
    for dtype in (torch.bfloat16, torch.float32):
        rand = lambda *s: torch.randn(*s, generator=gen,
                                      device=DEVICE).to(dtype)
        k0, v0 = rand(L, N, E, D), rand(L, N, E, D)
        (views,) = qkv_view_sets(gen, L, N, D, dtype, n=1)
        held = [t.clone() for t in views[0] + views[1]]
        stacked = tuple(torch.stack(side) for side in views)
        for step in (0, 7, 8, MAIN["entry_length"] - 1):
            for form, (nk, nv) in (("views", views), ("tensors", stacked)):
                a = cr.write_gen_slot_chunk_seqmajor(k0.clone(), v0.clone(),
                                                     nk, nv, step)
                b = cr.write_gen_slot_chunk_seqmajor_plain(
                    k0.clone(), v0.clone(), nk, nv, step)
                torch.cuda.synchronize()
                require(torch.equal(a["k"], b["k"]) and
                        torch.equal(a["v"], b["v"]),
                        f"K13 {dtype} {form} step {step}: slot write "
                        "differs from the plain version")
                other = torch.arange(E, device=DEVICE) != step
                require(torch.equal(a["k"][:, :, other], k0[:, :, other]) and
                        torch.equal(a["v"][:, :, other], v0[:, :, other]),
                        f"K13 {dtype} {form} step {step}: touched another "
                        "slot")
        require(all(torch.equal(t, h) for t, h in
                    zip(views[0] + views[1], held)),
                f"K13 {dtype}: a source changed")
        if dtype == torch.bfloat16:
            k, v = k0, v0
    sets = qkv_view_sets(gen, L, N, D)
    plan = cr.slot_write_plan(L, N, D, 2, _build.sm_count(
        torch.device(DEVICE)))
    tensor_form = slot_write_times(gen, cr.write_gen_slot_chunk_seqmajor,
                                   cr.write_gen_slot_chunk_seqmajor_plain,
                                   k, v, (L, N, D))
    b_ms, b_by = bound_ms(2 * 2 * L * N * D * 2, 0, torch.bfloat16)
    return dict(
        name="write_gen_slot_chunk_seqmajor", route="cuda",
        source="capdec_tpu_torch/csrc/cache_reorder.cu",
        replaces="capdec_tpu/ops/cache_reorder.py:380",
        max_abs_err=0.0, max_abs_err_f32=0.0,
        ms=time_ms(views_write_call(cr.write_gen_slot_chunk_seqmajor, k, v,
                                    sets)),
        plain_ms=time_ms(views_write_call(
            cr.write_gen_slot_chunk_seqmajor_plain, k, v, sets)),
        library_ms=time_ms(views_write_call(stack_index_copy(E), k, v,
                                            sets)),
        bound_ms=b_ms, bound_by=b_by,
        floor_ms=time_ms(empty_grid_call(plan)),
        tensor_form_ms=tensor_form["ms"], ptxas=regs, plan=plan,
        shape=f"L={L} B={N} E={E} D={D} bf16 (seq-major), from the "
              f"per-layer views of [B, 3D] qkv buffers rotated over "
              f"{len(sets)} sets and the {E} slots; library: torch.stack "
              "of each side, then index_copy_ on dim 2 of k and v; floor: "
              "the empty kernel on K13's grid; tensor_form_ms: K13 from "
              "[L, B, D] tensors")


def check_gathers(gen):
    """K10, K11 and K12 bit-identical to their plain versions in bf16, f32
    and int8 at the served paths' full shapes (K10: the row-major cache of
    (f); K11/K12: the seq-major cache of (g); K12 at count 66, the slots
    outside it untouched), with a `src` in which several rows read one
    source. Timed in bf16 into output caches made once."""
    from capdec_tpu_torch.ops import cache_reorder as cr
    N, R, L, E, D = (MAIN[k] for k in ("N", "R", "L", "E", "D"))
    B, count = N * R, MAIN["entry_length"] - 1
    cpu_gen = torch.Generator().manual_seed(SEED + 1)
    # each row takes a source beam of its own image, as the selections do
    src = (torch.arange(N)[:, None] * R
           + torch.randint(R, (N, R), generator=cpu_gen)).reshape(-1)
    src = src.to(DEVICE)
    # bound: each source row read once (several rows share one), each
    # output row written once, for k and v; and src
    rows = int(src.unique().numel()) + B
    full = 2 * rows * L * E * D * 2 + B * 8

    def rand(dtype, *shape):
        if dtype == torch.int8:
            return _int8(gen, *shape)
        return torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)

    timed = {}
    for dtype in (torch.bfloat16, torch.float32, torch.int8):
        k, v = rand(dtype, B, L, E, D), rand(dtype, B, L, E, D)
        a = cr.reorder_rows_leading(k, v, src)
        b = cr.reorder_rows_leading_plain(k, v, src)
        torch.cuda.synchronize()
        require(torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"]),
                f"K10 {dtype}: gather differs from the plain version")
        if dtype == torch.bfloat16:
            timed["rows"] = (k, v, a["k"], a["v"])
        del k, v, a, b
        k, v = rand(dtype, L, B, E, D), rand(dtype, L, B, E, D)
        a = cr.reorder_cache_rows(k, v, src)
        b = cr.reorder_cache_rows_plain(k, v, src)
        torch.cuda.synchronize()
        require(torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"]),
                f"K11 {dtype}: gather differs from the plain version")
        del a, b
        fill = rand(dtype, L, B, E, D)
        a = cr.reorder_cache_rows_bounded(k, v, src, count, out_k=fill.clone(),
                                          out_v=fill.clone())
        b = cr.reorder_cache_rows_bounded_plain(k, v, src, count,
                                                out_k=fill.clone(),
                                                out_v=fill.clone())
        torch.cuda.synchronize()
        require(torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"]),
                f"K12 {dtype}: gather differs from the plain version")
        require(torch.equal(a["v"][:, :, count:], fill[:, :, count:]),
                f"K12 {dtype}: wrote a slot at or above count")
        if dtype == torch.bfloat16:
            timed["seq"] = (k, v, a["k"], a["v"])
        del k, v, a, b, fill
    res = []
    k, v, ok, ov = timed["rows"]
    b_ms, b_by = bound_ms(full, 0, torch.bfloat16)

    def library_rows():
        torch.index_select(k, 0, src, out=ok)
        torch.index_select(v, 0, src, out=ov)

    res.append(dict(
        name="reorder_rows_leading", route="cuda",
        source="capdec_tpu_torch/csrc/cache_gather.cu",
        replaces="capdec_tpu/ops/cache_reorder.py:516",
        max_abs_err=0.0, max_abs_err_f32=0.0,
        ms=time_ms(lambda: cr.reorder_rows_leading(k, v, src, ok, ov)),
        plain_ms=time_ms(
            lambda: cr.reorder_rows_leading_plain(k, v, src, ok, ov)),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(library_rows),
        library_note="torch.index_select on axis 0, once for k and once "
                     "for v",
        shape=f"B={B} sources={rows - B} L={L} E={E} D={D} bf16 "
              "(row-major)"))
    del timed["rows"], k, v, ok, ov
    k, v, ok, ov = timed["seq"]

    def library_seq():
        torch.index_select(k, 1, src, out=ok)
        torch.index_select(v, 1, src, out=ov)

    res.append(dict(
        name="reorder_cache_rows", route="cuda",
        source="capdec_tpu_torch/csrc/cache_gather.cu",
        replaces="capdec_tpu/ops/cache_reorder.py:550",
        max_abs_err=0.0, max_abs_err_f32=0.0,
        ms=time_ms(lambda: cr.reorder_cache_rows(k, v, src, ok, ov)),
        plain_ms=time_ms(
            lambda: cr.reorder_cache_rows_plain(k, v, src, ok, ov)),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(library_seq),
        library_note="torch.index_select on axis 1, once for k and once "
                     "for v",
        shape=f"L={L} B={B} sources={rows - B} E={E} D={D} bf16 "
              "(seq-major)"))
    b_ms, b_by = bound_ms(2 * rows * L * count * D * 2 + B * 8, 0,
                          torch.bfloat16)
    res.append(dict(
        name="reorder_cache_rows_bounded", route="cuda",
        source="capdec_tpu_torch/csrc/cache_gather.cu",
        replaces="capdec_tpu/ops/cache_reorder.py:64",
        max_abs_err=0.0, max_abs_err_f32=0.0,
        ms=time_ms(lambda: cr.reorder_cache_rows_bounded(k, v, src, count,
                                                         ok, ov)),
        plain_ms=time_ms(lambda: cr.reorder_cache_rows_bounded_plain(
            k, v, src, count, ok, ov)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        library_note="null: no one PyTorch call gathers only the slots "
                     "below count into a full-shape cache",
        shape=f"L={L} B={B} sources={rows - B} E={E} count={count} D={D} "
              "bf16 (seq-major)"))
    return res


def check_single_slot_write(gen):
    """K14 bit-identical to its plain version (K3's plain write) at K3's
    shapes in bf16 and f32, at steps 0, odd, even and E-1, from views and
    from tensors (rowmajor_write_checks); timed as K3 is."""
    from capdec_tpu_torch.ops import cache_reorder as cr
    N, R, L, E, D = (MAIN[k] for k in ("N", "R", "L", "E", "D"))
    B = N * R
    k, v = rowmajor_write_checks(gen, cr.write_gen_slot,
                                 cr.write_gen_slot_plain, "K14", B, L, E, D,
                                 (0, 7, 8, E - 1))
    return dict(
        name="write_gen_slot", route="cuda",
        source="capdec_tpu_torch/csrc/cache_reorder.cu",
        replaces="capdec_tpu/ops/cache_reorder.py:452",
        max_abs_err=0.0, max_abs_err_f32=0.0,
        **rowmajor_write_times(gen, cr.write_gen_slot,
                               cr.write_gen_slot_plain, k, v),
        shape=f"B={B} L={L} E={E} D={D} bf16 (K3's kernel), from views as "
              "K3's row")


def check_v1_attention(gen):
    """K15 against its plain version at the main path's per-layer shapes
    (N=64 images x R=5, K=40, E=72, D=768, 12 heads x 64), bf16 and f32,
    steps 0, 1, 17, 66 and 71: the output within K2's tolerances, slot
    `step` of the caches equal to k_new/v_new bit for bit, every other
    slot's bits untouched, NaN in the slots above `step` never read. Timed
    in bf16 at ATTN_STEPS, on one cache set and rotated over L sets."""
    from capdec_tpu_torch.ops import decode_attention as da
    N, R, K, E, D, H = (MAIN[k] for k in ("N", "R", "K", "E", "D", "H"))
    B, hd = N * R, D // H
    kw = dict(beams_per_image=R, head_dim=hd)
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    errs = {}
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        rand = lambda *s: torch.randn(*s, generator=gen,
                                      device=DEVICE).to(dtype)
        q, kn, vn = rand(B, 3 * D).split(D, dim=-1)
        pk, pv, gk0, gv0 = rand(N, K, D), rand(N, K, D), rand(B, E, D), \
            rand(B, E, D)
        err = 0.0
        for step in (0, 1, 17, MAIN["entry_length"] - 1, E - 1):
            k0, v0 = gk0.clone(), gv0.clone()
            k0[:, step + 1:] = float("nan")  # never read, never written
            v0[:, step + 1:] = float("nan")
            gk, gv = k0.clone(), v0.clone()
            out = da.beam_decode_attention(q, kn, vn, pk, pv, gk, gv, step,
                                           **kw)[0]
            ref, rk, _ = da.beam_decode_attention_plain(
                q, kn, vn, pk, pv, k0.clone(), v0.clone(), step, **kw)
            torch.cuda.synchronize()
            what = f"K15 {dtype} step {step}"
            require(bool(torch.isfinite(out).all()),
                    f"{what}: non-finite output")
            require(torch.allclose(out, ref, atol=tol, rtol=tol),
                    f"{what}: max abs err {max_err(out, ref)}")
            require(torch.equal(gk[:, step], kn) and
                    torch.equal(gv[:, step], vn),
                    f"{what}: slot {step} does not hold k_new/v_new")
            other = torch.arange(E, device=DEVICE) != step
            for a, b in ((gk, k0), (gv, v0), (rk, k0)):
                require(torch.equal(a[:, other].view(bits[dtype]),
                                    b[:, other].view(bits[dtype])),
                        f"{what}: another slot's bits changed")
            err = max(err, max_err(out, ref))
        errs[dtype] = err
        if dtype == torch.bfloat16:
            timed = (q, kn, vn)
    # timed at ATTN_STEPS over L cache sets [L][B, E, D] (rotated: one set
    # a call, as K2 walks the layers); the library yardstick is SDPA on
    # keys concatenated beforehand plus `index_copy_` of the slot
    q, kn, vn = timed[:3]
    L = MAIN["L"]
    rand = lambda *s: torch.randn(*s, generator=gen, device=DEVICE).to(
        torch.bfloat16)
    pk, pv, gk, gv = rand(L, N, K, D), rand(L, N, K, D), rand(L, B, E, D), \
        rand(L, B, E, D)
    slot = [torch.tensor([s], device=DEVICE) for s in range(E)]

    def write(step, l):
        gk[l].index_copy_(1, slot[step], kn[:, None])
        gv[l].index_copy_(1, slot[step], vn[:, None])

    steps = attention_step_times(
        lambda s, l: da.beam_decode_attention(q, kn, vn, pk[l], pv[l], gk[l],
                                              gv[l], s, **kw),
        q, kn, vn, pk, pv, gk.transpose(0, 1), gv.transpose(0, 1), R, H,
        write=write)
    step = MAIN["entry_length"] - 1
    l = L // 2
    return dict(
        name="beam_decode_attention", route="cuda",
        source="capdec_tpu_torch/csrc/decode_attention_async.cu",
        replaces="capdec_tpu/ops/decode_attention.py:794",
        max_abs_err=errs[torch.bfloat16],
        max_abs_err_f32=errs[torch.float32],
        **{k: steps[step][k] for k in ("ms", "rotated_ms", "bound_ms",
                                       "bound_by", "library_ms",
                                       "library_rotated_ms")},
        plain_ms=time_ms(lambda: da.beam_decode_attention_plain(
            q, kn, vn, pk[l], pv[l], gk[l], gv[l], step, **kw)),
        steps=steps,
        library_note="scaled_dot_product_attention on keys concatenated "
                     "beforehand, plus index_copy_ of slot `step` of k "
                     "and v",
        shape=f"N={N} R={R} K={K} E={E} step={step} D={D} bf16, caches "
              f"[B, E, D] written in place (rotated over {L} cache sets)")


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Units in the last place of a's dtype (bf16 or f32) between a and
    b, elementwise (int64)."""
    bits = {torch.bfloat16: (torch.int16, 0x7FFF),
            torch.float32: (torch.int32, 0x7FFFFFFF)}[a.dtype]

    def ordered(t):  # sign-magnitude bits onto one monotonic integer line
        m = t.view(bits[0]).long()
        return torch.where(m < 0, -(m & bits[1]), m)
    return (ordered(a) - ordered(b)).abs()


def epilogue_instance(mangled: str) -> str:
    """'bias_act<bf16, gelu>', 'residual_layernorm<f32, entry, 6>', ...
    for a mangled kernel name of csrc/epilogue.cu (the layernorm's last
    argument: the vectors a lane holds)."""
    m = re.search(r"(bias_act|residual_layernorm)I(13__nv_bfloat16|f)"
                  r"Lb([01])E(?:Li(\d+)E)?", mangled)
    flag = {"bias_act": ("bias", "gelu"),
            "residual_layernorm": ("residual", "entry")}[m.group(1)]
    t = "bf16" if m.group(2) != "f" else "f32"
    per = f", {m.group(4)}" if m.group(4) else ""
    return f"{m.group(1)}<{t}, {flag[int(m.group(3))]}{per}>"


# The epilogues' rows: B 2560 (batch 512 x beam 5, the offline cells) and
# B 5 (one image); their tolerances against the plain versions: bit-exact
# but for one unit in the last place of the compute dtype (tanh's, and
# the layernorm statistics' last bit, which Welford's update and two
# passes round differently), or EPILOGUE_ATOL where g (x - mean) and beta
# cancel to near zero and a unit is tiny, on at most EPILOGUE_ULP_SHARE
# of the outputs; float32 GELU and layernorm outputs within 1e-6, and
# 1e-6 relative above 1 (a last bit of tanh or rstd, scaled where 1 + tanh
# or x - mean cancels).
EPILOGUE_ROWS = (2560, 5)
EPILOGUE_ULP_SHARE = 1e-3
EPILOGUE_ATOL = 2.0 ** -20


def epilogue_close(got, want, what, exact=False):
    """got within the epilogues' tolerance of want (bf16: one unit in the
    last place or EPILOGUE_ATOL, on a share of at most
    EPILOGUE_ULP_SHARE; f32: 1e-6 and 1e-6 relative), or bit-exact."""
    torch.cuda.synchronize()
    if exact:
        require(torch.equal(got, want), f"{what}: not bit-exact")
        return 0.0
    u = ulps(got, want)
    share = float((u > 0).float().mean())
    if got.dtype == torch.bfloat16:
        far = (u > 1) & ((got.float() - want.float()).abs() > EPILOGUE_ATOL)
        require(not bool(far.any()) and share <= EPILOGUE_ULP_SHARE,
                f"{what}: {int(u.max())} ulps (max abs err "
                f"{max_err(got, want)}), on {share:.2e} of the outputs")
    else:
        require(torch.allclose(got, want, atol=1e-6, rtol=1e-6),
                f"{what}: max abs err {max_err(got, want)}")
    return share


def epilogue_inputs(gen, B, dtype, n=1):
    """n sets of the epilogues' inputs at B rows: the products' outputs y
    (c_attn 2304, c_fc 3072, a c_proj 768) and the residual x [B, 768] in
    dtype; the f32 biases, layernorm weight and bias; a wpe row."""
    D = MAIN["D"]
    rand = lambda *s: torch.randn(*s, generator=gen, device=DEVICE)
    sets = [dict(qkv=rand(B, 3 * D).to(dtype), fc=rand(B, 4 * D).to(dtype),
                 proj=rand(B, D).to(dtype), x=rand(B, D).to(dtype))
            for _ in range(n)]
    return sets, dict(b3=rand(3 * D), b4=rand(4 * D), b1=rand(D),
                      g=1 + 0.1 * rand(D), beta=0.1 * rand(D),
                      p=rand(D).to(dtype), eps=1e-5)


def check_epilogues(gen, ptxas):
    """The decode step's epilogues (csrc/epilogue.cu) against their plain
    versions, the op chains they replace, at B 2560 and B 5 in bf16 and
    f32 (tolerances above); each wrapper launches once a call and refuses
    a row not of whole 16-byte vectors and a dtype it does not take. Timed in bf16: at B 2560 over inputs
    rotated past the L2 (`ms`, as the bytes bound assumes) and on one set
    (`warm_ms`: in the step, a product has just written y), at B 5 on one
    set; beside the plain version and the bytes bound; each wrapper's
    host µs a call (the card kept busy, HOST_CALLS calls)."""
    from capdec_tpu_torch.ops import epilogue as ep
    regs = instances(ptxas, "bias_act", epilogue_instance, 4)
    regs.update(instances(ptxas, "residual_layernorm", epilogue_instance, 8))
    D = MAIN["D"]
    calls = {  # name -> (kernel call, plain call, bytes moved, exact?)
        "bias_cast": (
            lambda i, c: ep.bias_cast(i["qkv"], c["b3"]),
            lambda i, c: ep.bias_cast_plain(i["qkv"], c["b3"]),
            lambda B, t: 2 * B * 3 * D * t, True),
        "bias_gelu_cast": (
            lambda i, c: ep.bias_gelu_cast(i["fc"], c["b4"]),
            lambda i, c: ep.bias_gelu_cast_plain(i["fc"], c["b4"]),
            lambda B, t: 2 * B * 4 * D * t, False),
        "bias_residual_layernorm": (
            lambda i, c: ep.bias_residual_layernorm(
                i["x"], i["proj"], c["b1"], c["g"], c["beta"], c["eps"]),
            lambda i, c: ep.bias_residual_layernorm_plain(
                i["x"], i["proj"], c["b1"], c["g"], c["beta"], c["eps"]),
            lambda B, t: 4 * B * D * t, False),
        "embed_layernorm": (
            lambda i, c: ep.embed_layernorm(
                i["x"], c["p"], c["g"], c["beta"], c["eps"], i["x"].dtype),
            lambda i, c: ep.embed_layernorm_plain(
                i["x"], c["p"], c["g"], c["beta"], c["eps"], i["x"].dtype),
            lambda B, t: 3 * B * D * t, False)}
    rows = {name: dict(name=name, route="cuda",
                       source="capdec_tpu_torch/csrc/epilogue.cu",
                       replaces="none (XLA fused it on the TPU): "
                                "models/gpt2.py _block's op chain",
                       ptxas=regs) for name in calls}
    for dtype in (torch.bfloat16, torch.float32):
        for B in EPILOGUE_ROWS + (333,):
            (ins,), consts = epilogue_inputs(gen, B, dtype)
            for name, (call, plain, _, exact) in calls.items():
                fn = getattr(ep, name)
                n0 = fn.launches
                got, want = call(ins, consts), plain(ins, consts)
                require(fn.launches == n0 + 1, f"{name}: launches")
                what = f"{name} {dtype} B {B}"
                if isinstance(got, tuple):  # (x', h): x' exact, h close
                    epilogue_close(got[0], want[0], what + " x", exact=True)
                    share = epilogue_close(got[1], want[1], what + " h")
                else:
                    share = epilogue_close(got, want, what, exact=exact)
                key = ("ulp_share" if dtype == torch.bfloat16
                       else "ulp_share_f32")
                rows[name][key] = max(rows[name].get(key, 0.0), share)
    (ins,), consts = epilogue_inputs(gen, 5, torch.bfloat16)
    for bad in (ins["x"][:, :636].contiguous(), ins["x"].half()):
        for name in ("bias_cast", "bias_residual_layernorm"):
            try:
                calls[name][0](dict(ins, qkv=bad, x=bad, proj=bad), consts)
            except (ValueError, TypeError):
                continue
            raise AssertionError(f"{name} took {bad.dtype} {bad.shape}")
    for B in EPILOGUE_ROWS:
        # sets enough that the least-reading call (the entry's e) passes
        # more than L2_FLUSH_BYTES a rotation; one at B 5
        n = -(-L2_FLUSH_BYTES // (B * D * 2)) if B > 5 else 1
        sets, consts = epilogue_inputs(gen, B, torch.bfloat16, n)
        for name, (call, plain, nbytes, _) in calls.items():
            b_ms, b_by = bound_ms(nbytes(B, 2), 0, torch.bfloat16)
            row = dict(
                ms=time_ms(rotating(lambda i: call(sets[i], consts),
                                    len(sets))),
                warm_ms=time_ms(lambda: call(sets[0], consts)),
                plain_ms=time_ms(rotating(lambda i: plain(sets[i], consts),
                                          len(sets))),
                bound_ms=b_ms, bound_by=b_by,
                host_us=host_us(lambda: call(sets[0], consts)),
                plain_host_us=host_us(lambda: plain(sets[0], consts)),
                shape=f"B={B} D={D} bf16, rotated over {len(sets)} sets")
            if B == EPILOGUE_ROWS[0]:
                rows[name].update(row)
            else:
                rows[name][f"b{B}"] = row
    return list(rows.values())


# Calls a host-time reading averages over (the plain chains' launches stay
# under the card's queue of pending launches).
HOST_CALLS = 100


def host_us(fn) -> float:
    """Host microseconds of one call of fn, the card kept busy so that no
    call waits for it (the launches queue)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES * 4)
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / HOST_CALLS * 1e6


# ---------------------------------------------------------------------------
# Phase 2b: the MLA-MoE decoder (models/mla_moe.py)
# ---------------------------------------------------------------------------

# Its served shapes: Kimi-VL-A3B's text model at batch 512 images x beam 5
# (the offline cell's), prefix 40, hidden 2048, 16 heads over a latent of
# 512 + a rope part of 64, 64 routed experts of 1408 top-6 (15360
# token-expert rows a layer) and 2 shared, a dense layer of 11264, vocab
# 163840, 27 layers (the served check keeps 1 dense + 1 routed).
MLA = dict(N=512, R=5, K=40, E=72, L=27, H=16, D=2048, V=163840, Dl=512,
           Dr=64, nope=128, experts=64, top=6, I=1408, dense_I=11264,
           entry_length=67, prefix_size=640, mapper_layers=8, stop_token=13)
MLA_STEPS = (0, 33, MLA["entry_length"] - 1)
MLA_SOURCE = "capdec_tpu_torch/csrc/mla_attention.cu"
MOE_SOURCE = "capdec_tpu_torch/csrc/moe.cu"
# The kernels a decode of the MLA-MoE decoder launches, and none other.
MLA_PATH = ("lm_head_topk", "write_gen_slot_chunk", "copy_forked_rows_bounded",
            "mla_decode_attention", "mla_prep", "residual_rmsnorm",
            "moe_route", "moe_dispatch", "expert_products", "swiglu",
            "moe_combine")


def _bf(gen, shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device=DEVICE) * scale).to(
        torch.bfloat16)


def _within(got, want, frac: float, what: str) -> float:
    """got within `frac` of want's largest magnitude; the error."""
    torch.cuda.synchronize()
    scale = float(want.float().abs().max())
    err = max_err(got, want)
    require(err <= frac * scale, f"{what}: max abs err {err} > {frac} of "
                                 f"the scale {scale}")
    return err


def _ulp1(got, want, what: str) -> float:
    """got at most one unit in the last place from want; the error."""
    torch.cuda.synchronize()
    require(int(ulps(got, want).max()) <= 1,
            f"{what}: {int(ulps(got, want).max())} ulps")
    return max_err(got, want)


def _row(name, source, ms, plain_ms, nbytes, flops, **more) -> dict:
    b_ms, b_by = bound_ms(nbytes, flops, torch.bfloat16)
    return dict(name=name, route="cuda", source=source,
                replaces=f"{name}'s plain version (no TPU kernel)", ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, **more)


def mla_slots(prefix, gen, lat_new, step, layer, R):
    """Every row's latent slots [B, S, Dl + Dr]: its image's prefix, its
    generated rows below `step` and the step's own (the keys, and their
    first Dl values the values, of the library route)."""
    return torch.cat([prefix[layer].repeat_interleave(R, 0),
                      gen[:, layer, :step], lat_new[:, None]], 1)


def check_mla_attention(gen) -> dict:
    """K16 against its plain version: batch 512 x beam 5 at steps 0, 33,
    66 and 71 (the last slot), one image at steps 0 and 66, within 2 % of
    the plain output's largest magnitude (the kernel rounds the softmax's
    numerators to bf16 before the value product, the plain version keeps
    them in f32). Timed at MLA_STEPS over two layers' caches and query
    sets (a pass reads more than the L2), beside the plain version, the
    bound and the library route: scaled_dot_product_attention of each
    row's 16 heads as 16 queries over its latent slots gathered before
    (MQA: one key row serves every head), checked against the plain
    version too."""
    from capdec_tpu_torch.ops import mla_attention as ma
    N, R, K, E, H, Dl, Dr = (MLA[k] for k in
                             ("N", "R", "K", "E", "H", "Dl", "Dr"))
    C, scale = Dl + Dr, ma.softmax_scale(MLA["nope"] + Dr)
    kw = dict(beams_per_image=R, scale=scale)

    def inputs(n):
        """Two layers' prefix and generated latent and two query sets."""
        B = n * R
        return _bf(gen, (2, n, K, C)), _bf(gen, (B, 2, E, C)), [
            (_bf(gen, (H, B, Dl)),
             _bf(gen, (B, H, MLA["nope"] + Dr))[..., MLA["nope"]:],
             _bf(gen, (B, C))) for _ in range(2)]
    err = 0.0
    for n, steps in ((1, (0, E - 6)), (N, MLA_STEPS + (E - 1,))):
        prefix, cache, sets = inputs(n)
        for step in steps:
            err = max(err, _within(
                ma.mla_decode_attention(*sets[0], prefix, cache, step, 1,
                                        **kw),
                ma.mla_decode_attention_plain(*sets[0], prefix, cache, step,
                                              1, **kw),
                0.02, f"K16 N={n} step {step}"))
    times = {}
    for step in MLA_STEPS:
        slots = [mla_slots(prefix, cache, s[2], step, i, R)
                 for i, s in enumerate(sets)]
        qs = [torch.cat([s[0].transpose(0, 1), s[1]], -1)[:, None]
              for s in sets]
        keys = [s[:, None] for s in slots]
        vals = [s[:, None, :, :Dl].contiguous() for s in slots]

        def library(i):
            return torch.nn.functional.scaled_dot_product_attention(
                qs[i], keys[i], vals[i], scale=scale)
        _within(library(0)[:, 0].transpose(0, 1),
                ma.mla_decode_attention_plain(*sets[0], prefix, cache, step,
                                              0, **kw),
                0.02, f"K16's library route, step {step}")
        B, S = N * R, K + step + 1
        b_ms, b_by = bound_ms(
            ((N * K + B * step + B) * C + B * H * C + B * H * Dl) * 2,
            2.0 * B * H * S * (C + Dl), torch.bfloat16)
        times[step] = dict(
            ms=time_ms(rotating(lambda i: ma.mla_decode_attention(
                *sets[i], prefix, cache, step, i, **kw), 2)),
            plain_ms=time_ms(rotating(
                lambda i: ma.mla_decode_attention_plain(
                    *sets[i], prefix, cache, step, i, **kw), 2)),
            library_ms=time_ms(rotating(library, 2)),
            bound_ms=b_ms, bound_by=b_by)
        del slots, qs, keys, vals
    last = times[MLA_STEPS[-1]]
    return dict(name="mla_decode_attention", route="cuda", source=MLA_SOURCE,
                replaces="mla_decode_attention's plain version (no TPU "
                         "kernel)", max_abs_err=err, **last,
                steps=times, shape=f"N={N} R={R} K={K} H={H} Dl={Dl} "
                                   f"Dr={Dr} E={E} bf16")


def check_mla_glue(gen) -> list:
    """mla_prep, residual_rmsnorm, the routing (moe_route, moe_dispatch),
    swiglu and moe_combine against their plain versions at the decode
    step's B 2560 rows (15360 expert rows), each timed beside it and its
    bound: mla_prep, residual_rmsnorm and swiglu within one bf16 unit in
    the last place (the same f32 math; rsqrtf and expf may differ in the
    last bit), the residual bit-exact; the same experts chosen, weights
    within 1e-6 relative; the same offsets and row sets, the counter the
    counts; the combine within 1e-5 of the scale (its sum's order)."""
    from capdec_tpu_torch.ops import mla_attention as ma, moe, rmsnorm
    B, D, H, C = MLA["N"] * MLA["R"], MLA["D"], MLA["H"], MLA["Dl"] + MLA["Dr"]
    E, k, I = MLA["experts"], MLA["top"], MLA["I"]
    qk = MLA["nope"] + MLA["Dr"]
    rows = []
    q, kv = _bf(gen, (B, H * qk), 2.0), _bf(gen, (B, C), 2.0)
    w = torch.rand(MLA["Dl"], generator=gen, device=DEVICE) + 0.5
    cos, sin = ma.rope_tables(256, MLA["Dr"], 800000.0, DEVICE)
    q2 = q.clone()
    err = _ulp1(ma.mla_prep(q, kv, w, cos[77], sin[77], 1e-6, qk),
                ma.mla_prep_plain(q2, kv, w, cos[77], sin[77], 1e-6, qk),
                "mla_prep")
    _ulp1(q, q2, "mla_prep's q")
    rows.append(_row(
        "mla_prep", MLA_SOURCE,
        time_ms(lambda: ma.mla_prep(q, kv, w, cos[77], sin[77], 1e-6, qk)),
        time_ms(lambda: ma.mla_prep_plain(q, kv, w, cos[77], sin[77], 1e-6,
                                          qk)),
        (B * H * MLA["Dr"] * 2 + 2 * B * C) * 2, 0.0, max_abs_err=err,
        shape=f"B={B} H={H} qk_head={qk} C={C} bf16"))
    x = torch.randn(B, D, generator=gen, device=DEVICE) * 3
    y, wn = _bf(gen, (B, D)), torch.rand(D, generator=gen, device=DEVICE) + .5
    err = 0.0
    for assign in (False, True):
        x1, x2 = x.clone(), x.clone()
        got = rmsnorm.residual_rmsnorm(x1, y, wn, 1e-5, torch.bfloat16,
                                       assign)
        want = rmsnorm.residual_rmsnorm_plain(x2, y.float(), wn, 1e-5,
                                              torch.bfloat16, assign)
        torch.cuda.synchronize()
        require(torch.equal(x1, x2), "residual_rmsnorm: the residual")
        err = max(err, _ulp1(got, want, "residual_rmsnorm"))
    rows.append(_row(
        "residual_rmsnorm", "capdec_tpu_torch/csrc/rmsnorm.cu",
        time_ms(lambda: rmsnorm.residual_rmsnorm(x1, y, wn, 1e-5,
                                                 torch.bfloat16)),
        time_ms(lambda: rmsnorm.residual_rmsnorm_plain(
            x2, y.float(), wn, 1e-5, torch.bfloat16)),
        B * D * (4 + 4 + 2 + 2), 0.0, max_abs_err=err,
        shape=f"B={B} D={D} f32 residual, bf16 h"))
    logits = torch.randn(B, E, generator=gen, device=DEVICE)
    bias = torch.randn(E, generator=gen, device=DEVICE) * 0.1
    idx, wt = moe.route(logits, bias, k, True, 2.446)
    idx_p, wt_p = moe.route_plain(logits, bias, k, True, 2.446)
    s, o = idx.sort(-1)
    s_p, o_p = idx_p.sort(-1)
    torch.cuda.synchronize()
    require(torch.equal(s, s_p), "moe_route: other experts chosen")
    a, b = wt.gather(-1, o), wt_p.gather(-1, o_p)
    require(bool(((a - b).abs() <= 1e-6 * b.abs()).all()),
            f"moe_route: weights {max_err(a, b)} apart")
    rows.append(_row(
        "moe_route", MOE_SOURCE,
        time_ms(lambda: moe.route(logits, bias, k, True, 2.446)),
        time_ms(lambda: moe.route_plain(logits, bias, k, True, 2.446)),
        B * E * 4 + B * k * 8, 0.0, max_abs_err=max_err(a, b),
        shape=f"T={B} E={E} k={k}"))
    counter = torch.zeros(E, dtype=torch.int32, device=DEVICE)
    offs, pos, token_of = moe.dispatch(idx, E, counter)
    offs_p, _, _ = moe.dispatch_plain(idx, E)
    flat = torch.arange(B * k, device=DEVICE)
    torch.cuda.synchronize()
    require(torch.equal(offs, offs_p), "moe_dispatch: the offsets")
    require(torch.equal(counter, torch.diff(offs, prepend=offs[:1] * 0)),
            "moe_dispatch: the counter")
    require(torch.equal(token_of[pos.long()].long(), flat // k)
            and torch.equal(torch.sort(pos).values.long(), flat),
            "moe_dispatch: a pair's row does not hold its token")
    rows.append(_row(
        "moe_dispatch", MOE_SOURCE, time_ms(lambda: moe.dispatch(idx, E)),
        time_ms(lambda: moe.dispatch_plain(idx, E)), B * k * 4 * 3, 0.0,
        max_abs_err=0.0, shape=f"T={B} k={k} E={E}"))
    gu = _bf(gen, (B * k, 2 * I), 2.0)
    g, u = gu[:, :I], gu[:, I:]
    err = _ulp1(moe.swiglu(g, u), moe.swiglu_plain(g, u), "swiglu")
    rows.append(_row(
        "swiglu", MOE_SOURCE, time_ms(lambda: moe.swiglu(g, u)),
        time_ms(lambda: moe.swiglu_plain(g, u)), B * k * 3 * I * 2, 0.0,
        max_abs_err=err, shape=f"rows={B * k} I={I} bf16"))
    ye = _bf(gen, (B * k, D))
    x1 = torch.randn(B, D, generator=gen, device=DEVICE)
    x2 = x1.clone()
    moe.combine(x1, ye, pos, wt)
    moe.combine_plain(x2, ye, pos, wt)
    err = _within(x1, x2, 1e-5, "moe_combine")
    rows.append(_row(
        "moe_combine", MOE_SOURCE,
        time_ms(lambda: moe.combine(x1, ye, pos, wt)),
        time_ms(lambda: moe.combine_plain(x2, ye, pos, wt)),
        B * k * D * 2 + 2 * B * D * 4, 0.0, max_abs_err=err,
        shape=f"T={B} k={k} D={D}"))
    return rows


def check_expert_products(gen) -> dict:
    """The routed experts' grouped products (ops/moe.py expert_products:
    torch._grouped_mm for gate|up over all 64 experts, swiglu, the grouped
    down product) against the per-expert loop at one layer's 15360 rows
    (an expert left without rows), within 1 % of the scale (both sum in
    f32 and round to bf16, in other tilings). Timed over two sets of
    weights (2.2 GB, far past the L2), beside the loop, the bound (the 64
    experts' weights, the rows in and out) and cuBLAS's dense products of
    the same rows and widths (one expert's weights for all: the rate the
    grouped route would reach as one product)."""
    from capdec_tpu_torch.ops import moe
    E, D, I = MLA["experts"], MLA["D"], MLA["I"]
    M = MLA["N"] * MLA["R"] * MLA["top"]
    counts = torch.multinomial(torch.ones(E, device=DEVICE), M, True,
                               generator=gen).bincount(minlength=E)
    counts[3] += counts[5]
    counts[5] = 0                          # an expert no row chose
    offs = counts.cumsum(0).to(torch.int32)
    x = _bf(gen, (M, D))
    sets = [(_bf(gen, (E, 2 * I, D), 0.03), _bf(gen, (E, D, I), 0.03))
            for _ in range(2)]
    err = _within(moe.expert_products(x, *sets[0], offs),
                  moe.expert_products_plain(x, *sets[0], offs), 0.01,
                  "expert_products")
    wgu, wd = sets[0][0][0], sets[0][1][0]
    act = _bf(gen, (M, I))

    def dense():
        torch.mm(x, wgu.t())
        torch.mm(act, wd.t())
    return _row(
        "expert_products", "torch._grouped_mm (capdec_tpu_torch/ops/moe.py)",
        time_ms(rotating(lambda i: moe.expert_products(x, *sets[i], offs),
                         2)),
        time_ms(rotating(lambda i: moe.expert_products_plain(
            x, *sets[i], offs), 2), iters=5, warmup=1),
        E * 3 * I * D * 2 + 2 * M * D * 2, 2.0 * M * D * 3 * I,
        max_abs_err=err, cublas_ms=time_ms(dense),
        shape=f"rows={M} E={E} D={D} I={I} bf16")


def latent_cache_times(gen) -> dict:
    """K3 (write_gen_slot_chunk) and K4 (copy_forked_rows_bounded) on the
    MLA-MoE decoder's one-tensor latent cache [2560, 27, 72, 576] at step
    33, bit-exact against their plain versions (they move bytes), timed
    beside them and their bounds (K3 over two sets of the step's rows; K4
    forking a third of the rows, each from another row of the batch)."""
    from capdec_tpu_torch.ops import cache_reorder as cr
    B, L, E, C = MLA["N"] * MLA["R"], MLA["L"], MLA["E"], MLA["Dl"] + MLA["Dr"]
    step = MLA_STEPS[1]
    c1 = _bf(gen, (B, L, E, C))
    c2 = c1.clone()
    news = [_bf(gen, (L, B, C)).unbind(0) for _ in range(2)]
    cr.write_gen_slot_chunk(c1, None, news[0], None, step)
    cr.write_gen_slot_chunk_plain(c2, None, news[0], None, step)
    torch.cuda.synchronize()
    require(torch.equal(c1, c2), "K3 on the latent: not bit-exact")
    src = torch.arange(B, device=DEVICE)
    fork = torch.randperm(B, generator=gen, device=DEVICE)[:B // 3]
    keep = torch.ones(B, dtype=torch.bool, device=DEVICE)
    keep[fork] = False
    sources = src[keep]
    src[fork] = sources[torch.randint(len(sources), (len(fork),),
                                      generator=gen, device=DEVICE)]
    cr.copy_forked_rows_bounded(c1, None, src, step + 1)
    cr.copy_forked_rows_bounded_plain(c2, None, src, step + 1)
    torch.cuda.synchronize()
    require(torch.equal(c1, c2), "K4 on the latent: not bit-exact")
    del c2
    k3_ms, k3_by = bound_ms(2 * L * B * C * 2, 0.0, torch.bfloat16)
    k4_ms, k4_by = bound_ms(2 * (B // 3) * L * (step + 1) * C * 2, 0.0,
                            torch.bfloat16)
    shape = f"B={B} L={L} E={E} C={C} step={step} bf16"
    out = {"write_gen_slot_chunk": dict(
        ms=time_ms(rotating(lambda i: cr.write_gen_slot_chunk(
            c1, None, news[i], None, step), 2)),
        plain_ms=time_ms(rotating(lambda i: cr.write_gen_slot_chunk_plain(
            c1, None, news[i], None, step), 2)),
        bound_ms=k3_ms, bound_by=k3_by, shape=shape),
        "copy_forked_rows_bounded": dict(
        ms=time_ms(lambda: cr.copy_forked_rows_bounded(c1, None, src,
                                                       step + 1)),
        plain_ms=time_ms(lambda: cr.copy_forked_rows_bounded_plain(
            c1, None, src, step + 1)),
        bound_ms=k4_ms, bound_by=k4_by, shape=shape)}
    return out


class IdTokenizer:
    """Token ids joined by commas (random weights choose from all 163840
    tokens, which the byte tokenizer cannot spell)."""

    def decode(self, ids) -> str:
        return ",".join(map(str, ids.tolist()))


def mla_moe_model(gen, layers: int = 2):
    """The MLA-MoE caption model at full width with `layers` decoder
    layers (one dense, the rest routed), its bf16 weights drawn from gen
    (matrices N(0, 0.05), the correction bias N(0, 0.05), norms 1) in the
    reference layout and held without a copy, and the 8-layer mapper at
    width 2048 in f32."""
    from capdec_tpu_torch.models import caption_model, mappers, mla_moe
    c = mla_moe.MLAMoEConfig(
        num_hidden_layers=layers, vocab_size=MLA["V"], hidden_size=MLA["D"],
        intermediate_size=MLA["dense_I"], moe_intermediate_size=MLA["I"],
        n_routed_experts=MLA["experts"], num_experts_per_tok=MLA["top"],
        compute_dtype=torch.bfloat16)
    cfg = caption_model.CaptionModelConfig(
        prefix_length=MLA["K"], clip_length=MLA["K"],
        prefix_size=MLA["prefix_size"], num_layers=MLA["mapper_layers"],
        mapping_type="transformer", mla_moe=c)
    model = caption_model.ClipCaptionModel(cfg, DEVICE)
    mappers.init_params(model.clip_project, gen)
    sd = {}
    for name, t in mla_moe.MLAMoEModel(c, device="meta").state_dict().items():
        sd[name] = torch.ones(t.shape, device=DEVICE, dtype=torch.bfloat16) \
            if name.endswith("norm.weight") else _bf(
                gen, t.shape, 1.0 if "embed_tokens" in name else 0.05)
    model.gpt = mla_moe.params_from_torch_state_dict(sd, c)
    return model, cfg


def mla_moe_path(gen) -> dict:
    """The MLA-MoE decoder served through CaptionServer (lane-mode beam 5,
    the row-major latent cache) at full width, 1 dense + 1 routed layer:
    512 requests as one batch of 512, the launch counters zeroed just
    before and read just after (MLA_PATH launched, no other kernel), every
    request captioned, and the expert_rows counter [1, 64] holding every
    decode step's 2560 rows x 6 experts."""
    from capdec_tpu_torch import serve
    model, cfg = mla_moe_model(gen)
    dc = serve.BeamConfig(beam_size=MLA["R"],
                          entry_length=MLA["entry_length"],
                          stop_token=MLA["stop_token"])
    server = serve.CaptionServer(
        model, cfg, IdTokenizer(),
        serve.ServeConfig(batch_size=MLA["N"], beam_config=dc),
        device=DEVICE)
    server.warmup()
    embeds = np.random.RandomState(SEED).randn(
        MLA["N"], MLA["prefix_size"]).astype(np.float32)
    out = serve_path(server, embeds, MLA_PATH)
    require(out["streamed_launches"] == out["launches"]["lm_head_topk"],
            f"K1 at D {MLA['D']}: {out['streamed_launches']} of "
            f"{out['launches']['lm_head_topk']} calls streamed")
    rows = np.asarray(server.stats["expert_rows"])
    steps = server.stats["decode_steps"]
    require(rows.shape == (1, MLA["experts"]) and int(rows.sum()) == steps
            * MLA["N"] * MLA["R"] * MLA["top"],
            f"expert_rows {rows.shape} sums to {rows.sum()} over {steps} "
            "steps")
    out.update(decode_steps=steps, expert_rows_max_over_mean=float(
        rows.max() / rows.mean()))
    return out


def check_mla_moe(gen, ptxas) -> tuple:
    """Phase 2b: the MLA-MoE decoder's kernels against their plain versions
    (K16, its glue, the grouped expert products, K1 at (2560, 163840,
    2048), K3/K4 on the latent), their instances built without spills, and
    the decoder served. Returns (the new kernels' rows, K1's D 2048 times,
    K3/K4's latent times, the served path)."""
    new = {name: rep for name, rep in ptxas.items()
           if any(s in name for s in ("mla_", "moe_", "swiglu",
                                      "residual_rmsnorm"))}
    for name, rep in new.items():
        require(rep.get("spill_stores") == 0 and rep.get("spill_loads") == 0,
                f"{name} spills: {rep}")
    rows = [check_mla_attention(gen), *check_mla_glue(gen),
            check_expert_products(gen)]
    torch.cuda.empty_cache()
    from capdec_tpu_torch.ops import lm_head
    n0 = lm_head.lm_head_topk.streamed_launches
    k1 = lm_head_times(gen, {"d2048": (MLA["N"] * MLA["R"], MLA["R"])},
                       V=MLA["V"], D=MLA["D"])["d2048"]
    k1["streamed_launches"] = lm_head.lm_head_topk.streamed_launches - n0
    require(k1["plan"]["route"] == "streamed" and k1["streamed_launches"] > 0,
            f"K1 at D 2048: plan {k1['plan']}, "
            f"{k1['streamed_launches']} streamed launches")
    torch.cuda.empty_cache()
    latent = latent_cache_times(gen)
    torch.cuda.empty_cache()
    served = mla_moe_path(gen)
    torch.cuda.empty_cache()
    return rows, k1, latent, served


# ---------------------------------------------------------------------------
# Phases 3 and 4: the served paths
# ---------------------------------------------------------------------------


def model_config(compute_dtype=torch.bfloat16, mapping_type="transformer",
                 **kw):
    """The full-width model: GPT-2 124M + the 8-layer mapper (the
    TransformerMapper unless `mapping_type` says otherwise), prefix
    640 -> 40 (`kw`: only_prefix, ce_chunk_rows)."""
    from capdec_tpu_torch.models import caption_model, gpt2
    return caption_model.CaptionModelConfig(
        prefix_length=MAIN["K"], clip_length=MAIN["K"],
        prefix_size=MAIN["prefix_size"], num_layers=MAIN["mapper_layers"],
        mapping_type=mapping_type,
        gpt2=gpt2.GPT2Config(vocab_size=MAIN["V"], n_embd=MAIN["D"],
                             n_layer=MAIN["L"], n_head=MAIN["H"],
                             compute_dtype=compute_dtype), **kw)


def build_server(gen, model=None, beam=True, beam_size=MAIN["R"], cfg=None,
                 tokenizer=None, mesh=None, **knobs):
    """The main path's server: BeamConfig(**knobs), or with beam=False
    greedy/top-p decoding with ToppConfig(**knobs). `model` reuses weights
    made before (of config `cfg`, default the main path's); `mesh` shards
    its batches over dp. Returns (server, model, cfg, the decode
    config)."""
    from capdec_tpu_torch import serve
    from capdec_tpu_torch.models import caption_model
    from capdec_tpu_torch.utils.tokenizer import ByteTokenizer
    cfg = cfg or model_config()
    if model is None:
        model = caption_model.init_params(cfg, gen, device=DEVICE)
    E = MAIN["entry_length"]
    if beam:
        dc = serve.BeamConfig(beam_size=beam_size, entry_length=E, **knobs)
        sc = serve.ServeConfig(batch_size=MAIN["N"], beam_config=dc,
                               mesh=mesh)
    else:
        dc = serve.ToppConfig(entry_length=E, **knobs)
        sc = serve.ServeConfig(batch_size=MAIN["N"], beam=False,
                               topp_config=dc, mesh=mesh)
    server = serve.CaptionServer(model, cfg, tokenizer or ByteTokenizer(),
                                 sc, device=DEVICE)
    return server, model, cfg, dc


def counters():
    from capdec_tpu_torch.ops import (cache_reorder, decode_attention,
                                      epilogue, lm_head, mla_attention, moe,
                                      rmsnorm)
    return {"lm_head_topk": lm_head.lm_head_topk,
            "beam_decode_attention_rowmajor":
                decode_attention.beam_decode_attention_rowmajor,
            "write_gen_slot_chunk": cache_reorder.write_gen_slot_chunk,
            "copy_forked_rows_bounded":
                cache_reorder.copy_forked_rows_bounded,
            "write_gen_slot_chunk_q": cache_reorder.write_gen_slot_chunk_q,
            "beam_decode_attention_rowmajor_q":
                decode_attention.beam_decode_attention_rowmajor_q,
            "copy_forked_rows": cache_reorder.copy_forked_rows,
            "beam_decode_attention_chunked":
                decode_attention.beam_decode_attention_chunked,
            "beam_decode_attention_chunked_q":
                decode_attention.beam_decode_attention_chunked_q,
            "write_gen_slot_chunk_seqmajor":
                cache_reorder.write_gen_slot_chunk_seqmajor,
            "reorder_rows_leading": cache_reorder.reorder_rows_leading,
            "reorder_cache_rows": cache_reorder.reorder_cache_rows,
            "reorder_cache_rows_bounded":
                cache_reorder.reorder_cache_rows_bounded,
            "write_gen_slot": cache_reorder.write_gen_slot,
            "beam_decode_attention": decode_attention.beam_decode_attention,
            **{name: getattr(epilogue, name) for name in EPILOGUES},
            "mla_decode_attention": mla_attention.mla_decode_attention,
            "mla_prep": mla_attention.mla_prep,
            "residual_rmsnorm": rmsnorm.residual_rmsnorm,
            "moe_route": moe.route, "moe_dispatch": moe.dispatch,
            "expert_products": moe.expert_products, "swiglu": moe.swiglu,
            "moe_combine": moe.combine}


# decode_step's fused epilogues, which every decode on the card launches
# (GPT-2 124M at one rank: the entry, and four a block each step)
EPILOGUES = ("bias_cast", "bias_gelu_cast", "bias_residual_layernorm",
             "embed_layernorm")


# The served paths: (phase, beam search?, decode knobs, the kernels the
# path must launch; the others must not launch). Every path decodes
# GPT-2 124M at one rank, so each launches the epilogues too.
CHUNKED = dict(fused_slot_chunks=8)
PATHS = (
    ("main_path", True, {},
     ("lm_head_topk", "beam_decode_attention_rowmajor",
      "write_gen_slot_chunk", "copy_forked_rows_bounded") + EPILOGUES),
    ("int8_path", True, dict(kv_cache_int8=True),
     ("lm_head_topk", "write_gen_slot_chunk_q",
      "beam_decode_attention_rowmajor_q", "copy_forked_rows") + EPILOGUES),
    # (a) slot-bounded beam: staged growth, bounded fork copies
    ("v3_path", True, CHUNKED,
     ("lm_head_topk", "beam_decode_attention_chunked",
      "write_gen_slot_chunk", "copy_forked_rows_bounded") + EPILOGUES),
    # (b) slot-bounded int8 beam; int8_prefix resolves on
    ("v3_int8_path", True, dict(kv_cache_int8=True, **CHUNKED),
     ("lm_head_topk", "beam_decode_attention_chunked_q",
      "write_gen_slot_chunk_q", "copy_forked_rows_bounded") + EPILOGUES),
    # (c) greedy, the default ToppConfig (--no_beam)
    ("greedy_path", False, {}, ("lm_head_topk",) + EPILOGUES),
    # (d) greedy with the seq-major kernel slot write
    ("greedy_k13_path", False, dict(chunk_slot_write=True),
     ("lm_head_topk", "write_gen_slot_chunk_seqmajor") + EPILOGUES),
    # (e) greedy's fused chunked int8 route, int8 prefix
    ("greedy_int8_path", False,
     dict(fused_attention=True, kv_cache_int8=True, **CHUNKED),
     ("lm_head_topk", "beam_decode_attention_chunked_q",
      "write_gen_slot_chunk_q") + EPILOGUES),
    # (f) non-lane beam: one full-size cache gathered after each selection
    ("nonlane_path", True, dict(lane_beams=False),
     ("lm_head_topk", "beam_decode_attention_rowmajor",
      "write_gen_slot_chunk", "reorder_rows_leading") + EPILOGUES),
    # (g) seq-major lane beam, staged growth: plain attention and slot
    # write, the whole cache gathered by the lanes' sources each step
    ("seqmajor_path", True, dict(rowmajor_cache=False),
     ("lm_head_topk", "reorder_cache_rows") + EPILOGUES),
    # (h) the lane path with the slot write K14 in place of K3
    ("slot_write_path", True,
     dict(chunk_slot_write=False, pallas_slot_write=True),
     ("lm_head_topk", "beam_decode_attention_rowmajor", "write_gen_slot",
      "copy_forked_rows_bounded") + EPILOGUES),
    # (i) ancestry attention: the cache never moves
    ("ancestry_path", True, dict(ancestry=True),
     ("lm_head_topk", "write_gen_slot_chunk") + EPILOGUES),
)


def launch_sites() -> dict:
    """Each counted kernel's wrapper as "module:function" (a kernel's name
    may differ from its wrapper's), for LAUNCH_SITECUSTOMIZE."""
    return {name: f"{fn.__module__}:{fn.__name__}"
            for name, fn in counters().items()}


def zero_counters() -> None:
    for fn in counters().values():
        fn.launches = 0
        for extra in ("widened_launches", "streamed_launches"):
            if hasattr(fn, extra):
                setattr(fn, extra, 0)


def widened_launches() -> int:
    """The attention kernels' launches on a widened plan since
    zero_counters()."""
    return sum(getattr(fn, "widened_launches", 0)
               for fn in counters().values())


def launch_set(path, what: str) -> dict:
    """The launch counts since zero_counters(): every kernel of `path`
    launched, no other."""
    return require_launch_set(
        {name: fn.launches for name, fn in counters().items()}, path, what)


def require_launch_set(launches: dict, path, what: str) -> dict:
    """`launches` (every kernel's count) holds every kernel of `path`
    launched and no other."""
    for name, n in launches.items():
        if name in path:
            require(n > 0, f"{what}: kernel {name} was never launched")
        else:
            require(n == 0, f"{what}: kernel {name} is not on this path but "
                            f"launched {n} times")
    return launches


def serve_path(server, embeds, path, keep_captions=False):
    zero_counters()
    t0 = time.perf_counter()
    got = dict(server.serve((i, embeds[i]) for i in range(len(embeds))))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_set(path, "served path")
    require(sorted(got) == list(range(len(embeds))) and
            all(isinstance(t, str) for t in got.values()),
            "served path: every request must get one caption")
    pct = server.latency_percentiles()
    return dict(served=len(got), wall_s=wall,
                captions_per_s=len(got) / wall, latency_p50_s=pct["p50"],
                latency_p95_s=pct["p95"], latency_p99_s=pct["p99"],
                batches=server.stats["batches"], launches=launches,
                widened_launches=widened_launches(),
                streamed_launches=counters()["lm_head_topk"].streamed_launches,
                **({"captions": got} if keep_captions else {}))


def launches_per_step(server, embeds) -> dict:
    """Every CUDA kernel one batch of the server launches, under
    torch.profiler, per decode step (a step launches K1 once), and the
    kernels the profile counts by name (capdec's own)."""
    from capdec_tpu_torch.ops import lm_head
    server.caption(embeds[:MAIN["N"]])  # warm
    torch.cuda.synchronize()
    steps0 = lm_head.lm_head_topk.launches
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        server.caption(embeds[:MAIN["N"]])
        torch.cuda.synchronize()
    steps = lm_head.lm_head_topk.launches - steps0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    ours = {}
    for e in kernels:
        m = re.search(r"capdec::(?:\(anonymous namespace\)::)?(\w+(<[^>]*>)?)",
                      e.name)
        if m:
            ours[m.group(1)] = ours.get(m.group(1), 0) + 1
    return dict(decode_steps=steps, kernel_launches=len(kernels),
                launches_per_step=len(kernels) / max(steps, 1),
                capdec_launches_per_step={n: c / max(steps, 1)
                                          for n, c in sorted(ours.items())})


def token_share(ta, la, tb, lb) -> float:
    """Share of token positions (up to the longer of two lengths) at which
    two decodes [N, E] agree."""
    span = torch.maximum(la, lb).long()
    pos = torch.arange(ta.shape[1], device=ta.device)[None]
    mask = pos < span[:, None]
    return float(((ta == tb) & mask).sum() / mask.sum())


def top_beam_share(a, b) -> float:
    """token_share of the top beams of two beam_search results."""
    from capdec_tpu_torch.decode import beam_top_select
    return token_share(*beam_top_select(a[0], a[1], a[3]),
                       *beam_top_select(b[0], b[1], b[3]))


def mapped_prefix(model, cfg, embeds):
    from capdec_tpu_torch.models import caption_model
    x = embeds / np.maximum(np.linalg.norm(embeds, axis=-1, keepdims=True),
                            1e-12)
    return caption_model.map_prefix(
        model, cfg, torch.from_numpy(x.astype(np.float32)).to(DEVICE))


def _decode(beam, gpt, gpt_cfg, prefix, dc):
    """beam_search, or greedy_topp_search as (tokens, lengths)."""
    from capdec_tpu_torch.decode import beam_search, greedy_topp_search
    return (beam_search if beam else greedy_topp_search)(gpt, gpt_cfg,
                                                         prefix, dc)


def _share(beam, a, b) -> float:
    return top_beam_share(a, b) if beam else token_share(*a, *b)


def token_identity(model, cfg, beam, dc, bf16_gpt, embeds, same_as=None):
    """f32 through the kernels and through the plain versions: identical
    tokens, lengths (and beam order; scores within 1e-4). Reports the
    share of (top-beam) tokens the bf16 path shares with f32. With
    `same_as`, another configuration's f32 kernel decode must give the
    same tokens, lengths and beam order too."""
    prefix = mapped_prefix(model, cfg, embeds)
    cfg32 = dataclasses.replace(cfg.gpt2, compute_dtype=torch.float32)
    kern = _decode(beam, model.gpt, cfg32, prefix, dc)
    plain = _decode(beam, model.gpt, cfg32, prefix, dc.plain())
    torch.cuda.synchronize()
    out = dict(images=len(embeds), f32_identical=True)
    for what, i in (("tokens", 0), ("lengths", 1), ("order", 3))[
            :3 if beam else 2]:
        require(torch.equal(kern[i], plain[i]),
                f"f32 token identity: {what} differ between the kernels "
                "and the plain path")
    if same_as is not None:
        other = _decode(beam, model.gpt, cfg32, prefix, same_as)
        for what, i in (("tokens", 0), ("lengths", 1), ("order", 3)):
            require(torch.equal(kern[i], other[i]),
                    f"f32: {what} differ from the other configuration's")
        out["f32_identical_to_main_path"] = True
    if beam:
        out["f32_score_max_abs_err"] = max_err(kern[2], plain[2])
        require(out["f32_score_max_abs_err"] <= 1e-4,
                f"f32 scores differ by {out['f32_score_max_abs_err']}")
    bf16 = _decode(beam, bf16_gpt, cfg.gpt2, prefix, dc)
    out["bf16_f32_token_share"] = _share(beam, kern, bf16)
    return out


def _image_differs(a, b):
    """[N] bool: the images whose beam_search results a and b differ in
    tokens, lengths or beam order."""
    return ((a[0] != b[0]).flatten(1).any(1) | (a[1] != b[1]).any(1) |
            (a[3] != b[3]).any(1))


def token_identity_at_batch(model, cfg, dc, bf16_gpt, embeds, chunk):
    """token_identity over a whole batch (512 images): f32 through the
    kernels and through the plain versions, at the batch's shapes. f32
    products round differently at other shapes (cuBLAS picks its
    algorithm by the rows), so over hundreds of images a near-tie of two
    beams can fall either way: an image on which the kernel path differs
    from the plain path must be one on which the plain path differs from
    itself when it decodes in batches of `chunk` (a rounding tie, counted
    and reported), and there the kernel path's tokens, lengths and beam
    order must equal those of the plain path in batches of `chunk`; every
    other image's must equal the plain path's at the whole batch, and all
    scores must be within 1e-4."""
    prefix = mapped_prefix(model, cfg, embeds)
    cfg32 = dataclasses.replace(cfg.gpt2, compute_dtype=torch.float32)
    kern = _decode(True, model.gpt, cfg32, prefix, dc)
    plain = _decode(True, model.gpt, cfg32, prefix, dc.plain())
    torch.cuda.synchronize()
    differ = _image_differs(kern, plain)
    ties = []
    if bool(differ.any()):
        for i in range(0, len(embeds), chunk):
            if not bool(differ[i:i + chunk].any()):
                continue
            part = _decode(True, model.gpt, cfg32, prefix[i:i + chunk],
                           dc.plain())
            self_differ = _image_differs(part, [x[i:i + chunk]
                                                for x in plain])
            kern_differ = _image_differs(part, [x[i:i + chunk]
                                                for x in kern])
            for j in differ[i:i + chunk].nonzero().flatten().tolist():
                require(bool(self_differ[j]),
                        f"f32 at batch {len(embeds)}: image {i + j} "
                        "differs between the kernels and the plain path, "
                        "and the plain path decodes it alike in batches "
                        f"of {chunk}")
                require(not bool(kern_differ[j]),
                        f"f32 at batch {len(embeds)}: image {i + j} "
                        "differs between the kernels and the plain path "
                        f"both at the whole batch and in batches of {chunk}")
                ties.append(i + j)
    err = max_err(kern[2], plain[2])
    require(err <= 1e-4, f"f32 scores differ by {err}")
    bf16 = _decode(True, bf16_gpt, cfg.gpt2, prefix, dc)
    return dict(images=len(embeds),
                f32_identical_images=len(embeds) - len(ties),
                rounding_tie_images=ties,
                f32_top_beam_share=top_beam_share(kern, plain),
                f32_score_max_abs_err=err,
                bf16_f32_token_share=top_beam_share(kern, bf16))


def int8_agreement(model, cfg, beam, dc, dc8, bf16_gpt, embeds):
    """An int8 path in f32, kernels against plain (top-beam, or greedy,
    token share >= 0.98), and its bf16 run against the bf16 path of `dc`
    (reported)."""
    prefix = mapped_prefix(model, cfg, embeds)
    cfg32 = dataclasses.replace(cfg.gpt2, compute_dtype=torch.float32)
    kern = _decode(beam, model.gpt, cfg32, prefix, dc8)
    plain = _decode(beam, model.gpt, cfg32, prefix, dc8.plain())
    torch.cuda.synchronize()
    if beam:
        require(bool(torch.isfinite(kern[2]).all()),
                "int8 f32: non-finite scores")
    share = _share(beam, kern, plain)
    require(share >= 0.98, f"int8 f32 kernels vs plain: token share "
                           f"{share} < 0.98")
    fields = (0, 1, 3) if beam else (0, 1)
    i8 = _decode(beam, bf16_gpt, cfg.gpt2, prefix, dc8)
    fp = _decode(beam, bf16_gpt, cfg.gpt2, prefix, dc)
    return dict(images=len(embeds), int8_f32_token_share=share,
                int8_f32_identical=all(torch.equal(kern[i], plain[i])
                                       for i in fields),
                int8_bf16_vs_bf16_token_share=_share(beam, i8, fp))


# ---------------------------------------------------------------------------
# Phase 5: training
# ---------------------------------------------------------------------------

# The training slice: the JAX bench's flagship step (bench.py:102-108,
# 301-319) on the reference's COCO preset (capdec_tpu/cli/train.py:80-82):
# batch 30, caption length 40, noise variance 0.016, bf16 products over
# f32 master weights. lr 1e-4 with no warmup, in place of the reference's
# 2e-5 with warmup 5000, under which the lr stays below 1e-7 for 20 steps
# and no loss can fall; the step's time does not depend on the lr.
TRAIN = dict(batch=30, T=40, variance=0.016, lr=1e-4, warm_steps=3,
             steps=20, distinct=30, cpu_batch=2)
WORDS = ("a", "man", "woman", "dog", "riding", "on", "the", "red", "bus",
         "street", "with", "two", "people", "standing", "next", "to",
         "large", "white", "building", "field", "holding", "kite")


def write_corpus(path, rng) -> None:
    """A corpus pickle in the reference schema (capdec_tpu/data/dataset.py
    :3-7): TRAIN["steps"] batches of rows cycling through
    TRAIN["distinct"] captions of 14 random words (more than T bytes) and
    their random CLIP text and image embeddings."""
    import pickle
    n, rows = TRAIN["distinct"], TRAIN["steps"] * TRAIN["batch"]
    texts = [" ".join(rng.choice(WORDS, 14)) + "." for _ in range(n)]
    caps = [{"caption": texts[i % n], "image_id": i % n, "id": i,
             "clip_embedding": i % n} for i in range(rows)]
    image = rng.randn(n, MAIN["prefix_size"]).astype(np.float32)
    text = image + 0.3 * rng.randn(n, MAIN["prefix_size"]).astype(np.float32)
    with open(path, "wb") as f:
        pickle.dump({"clip_embedding": image, "captions": caps,
                     "clip_embedding_text_dave": text}, f)


def train_mode(only_prefix, ds, out_dir, embeds):
    """Mode (j) (only_prefix: GPT-2 frozen, the mapper trains) or (k)
    (both train) at full width through train.loop.train: a warm-up run
    of TRAIN["warm_steps"] steps, then one epoch of TRAIN["steps"] steps
    whose metrics.jsonl (logged every step, each log waiting for the
    step's loss) gives samples/s and ms per step. Asserts finite losses,
    the no-noise loss on the corpus's distinct rows falling, (j)'s GPT-2
    bit-unchanged and the mapper changed (both under (k)), no decode
    kernel launched, and the epoch checkpoint `smoke-000.pt` equal to the
    weights and serving a batch of 64 on the beam path."""
    import pathlib
    from capdec_tpu_torch.models import caption_model
    from capdec_tpu_torch.train import loop, step
    from capdec_tpu_torch.utils import checkpoint, flops
    cfg = model_config(only_prefix=only_prefix)
    model = caption_model.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED), device=DEVICE)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    rows = np.arange(TRAIN["distinct"])
    fixed = {"tokens": ds.tokens[rows], "mask": ds.mask[rows],
             "prefix": ds.batch_prefixes(rows)}
    eval_fn = step.make_eval_step(cfg)
    loss0 = float(eval_fn(model, fixed))
    noise = step.NoiseConfig(variance=TRAIN["variance"])
    out_dir = pathlib.Path(out_dir)

    def run(name, **kw):
        return loop.train(cfg, loop.TrainLoopConfig(
            epochs=1, batch_size=TRAIN["batch"], lr=TRAIN["lr"],
            warmup_steps=0, out_dir=str(out_dir / name), prefix="smoke",
            log_every=1, seed=SEED, save_state=False, **kw), ds, noise,
            params=model, device=DEVICE)

    zero_counters()
    t0 = time.perf_counter()
    run("warm", max_steps=TRAIN["warm_steps"])
    run("timed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counters().items()}
    require(not any(launches.values()),
            f"training launched decode kernels: {launches}")
    with open(out_dir / "timed" / "metrics.jsonl") as f:
        logged = [json.loads(line) for line in f]
    losses = [m["loss"] for m in logged]
    require(len(losses) == TRAIN["steps"] and np.isfinite(losses).all(),
            f"training: {len(losses)} steps, losses {losses}")
    loss1 = float(eval_fn(model, fixed))
    require(np.isfinite(loss1) and loss1 < loss0,
            f"training: the loss on the distinct rows went {loss0} -> {loss1}")
    changed = {n for n, p in model.named_parameters()
               if not torch.equal(p.detach(), before[n])}
    gpt_changed = any(n.startswith("gpt.") for n in changed)
    require(any(n.startswith("clip_project.") for n in changed),
            "training: the mapper did not change")
    require(gpt_changed != only_prefix,
            "training: GPT-2 must stay bit-unchanged under only_prefix and "
            "train without it")
    del before
    path = checkpoint.epoch_checkpoint_path(str(out_dir / "timed"), "smoke", 0)
    served = checkpoint.load_caption_checkpoint(path, cfg, DEVICE)
    for n, p in model.state_dict().items():
        require(torch.equal(served.state_dict()[n], p),
                f"checkpoint: {n} differs from the trained weights")
    server = build_server(None, model=served)[0]
    captions = server.caption(embeds[:MAIN["N"]])
    require(len(captions) == MAIN["N"] and
            all(isinstance(c, str) for c in captions),
            "train -> serve: the checkpoint must caption a batch")
    rate = logged[-1]
    flop = flops.train_step_matmul_flops(cfg, TRAIN["batch"], TRAIN["T"])
    sd = caption_model.params_to_torch_state_dict(model, cfg)
    del model, served, server
    torch.cuda.empty_cache()
    return dict(
        mode="j only_prefix" if only_prefix else "k both train",
        batch=TRAIN["batch"], T=TRAIN["T"], steps=TRAIN["steps"],
        samples_per_s=rate["samples_per_sec"],
        ms_per_step=1e3 / rate["steps_per_sec"],
        mfu=flop * rate["steps_per_sec"] / PEAK_FLOPS[torch.bfloat16],
        step_matmul_tflop=flop / 1e12, first_loss=losses[0],
        last_loss=losses[-1], distinct_rows_loss=[loss0, loss1],
        parameters_changed=len(changed), wall_s=wall,
        served_from_checkpoint=len(captions)), sd


def card_cpu_step(sd, ds):
    """One f32 step's loss and mapper gradient at full width, batch 2, on
    the card and on the CPU from the same (trained) weights, batch and
    noise draws: the loss within 1e-4 relative, the mapper gradient (all
    its tensors as one vector) within 1e-3 relative in L2. Both sides are
    f32; their rounding differs op by op (sum orders, exp/tanh/rsqrt)
    and the backward carries it through 20 layers of trained weights
    (7.4e-5 measured on an H100); a bf16, dtype or kernel fault moves the
    loss by 1e-3 or more and the gradient by order 1. The worst single
    tensor's error relative to its largest magnitude is reported beside
    it."""
    from capdec_tpu_torch.models import caption_model
    from capdec_tpu_torch.ops import noise
    cfg = model_config(torch.float32)
    rows = np.arange(TRAIN["cpu_batch"])
    draws = np.random.RandomState(SEED).randn(
        len(rows), MAIN["prefix_size"]).astype(np.float32)
    got = {}
    for dev in ("cpu", DEVICE):
        model = caption_model.params_from_torch_state_dict(sd, cfg, dev)
        as_t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
        prefix = noise.noise_injection(
            as_t(ds.batch_prefixes(rows)), TRAIN["variance"],
            normal=as_t(draws))
        loss = caption_model.loss_forward(model, cfg,
                                          as_t(ds.tokens[rows]).long(),
                                          prefix, as_t(ds.mask[rows]))
        loss.backward()
        got[dev] = (float(loss.detach()),
                    {n: p.grad.cpu()
                     for n, p in model.clip_project.named_parameters()})
        del model
    (l_cpu, g_cpu), (l_card, g_card) = got["cpu"], got[DEVICE]
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    diff2 = sum(float((g_card[n] - g).double().pow(2).sum())
                for n, g in g_cpu.items())
    norm2 = sum(float(g.double().pow(2).sum()) for g in g_cpu.values())
    grad_rel = (diff2 / norm2) ** 0.5
    worst = max((float((g_card[n] - g).abs().max()
                       / g.abs().max().clamp_min(1e-30)), n)
                for n, g in g_cpu.items())
    require(loss_rel <= 1e-4, f"card vs CPU f32 step: loss {l_card} vs "
                              f"{l_cpu} ({loss_rel} relative)")
    require(grad_rel <= 1e-3, f"card vs CPU f32 step: mapper gradient "
                              f"{grad_rel} relative (L2)")
    return dict(batch=len(rows), loss_cpu=l_cpu, loss_card=l_card,
                loss_rel_err=loss_rel, mapper_grad_rel_l2_err=grad_rel,
                worst_tensor_rel_max_err=worst[0], worst_tensor=worst[1])


# ---------------------------------------------------------------------------
# Beam 33: the attention kernel in three row groups of 16
# ---------------------------------------------------------------------------

WIDE_R = 33  # beams per image: more than the 32 the kernel once took
BEAM_PATH = PATHS[0][3]  # K1-K4 and the epilogues
INT8_PATH = PATHS[1][3]  # K1, K5-K7 and the epilogues
GREEDY_PATH = PATHS[4][3]  # K1 and the epilogues


def wide_attention_times(gen) -> dict:
    """K2 at R 33 (64 images, a grid of three row groups) at the served
    shapes' last step, bf16, against its plain version (NaN in the slots
    it must not read): its time beside the plain version's, SDPA's on
    keys concatenated beforehand, and the bound. One layer's generated
    cache is 233 MB, past the L2, so a repeated call reads device
    memory."""
    from capdec_tpu_torch.ops import decode_attention as da
    N, L, K, E, D, H = (MAIN[k] for k in ("N", "L", "K", "E", "D", "H"))
    R, step, layer = WIDE_R, MAIN["entry_length"] - 1, L // 2
    B, hd = N * R, D // H

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=DEVICE).to(
            torch.bfloat16)

    q, kn, vn = rand(B, 3 * D).split(D, dim=-1)
    pk, pv, gk, gv = rand(L, N, K, D), rand(L, N, K, D), rand(B, L, E, D), \
        rand(B, L, E, D)
    for g in (gk, gv):
        g[:, :, step:] = float("nan")
        g[:, layer + 1, 0] = float("nan")
    args = (q, kn, vn, pk, pv, gk, gv, step, layer)
    kw = dict(beams_per_image=R, head_dim=hd, e_cap=E)
    kernel = lambda: da.beam_decode_attention_rowmajor(*args, **kw)
    plain = lambda: da.beam_decode_attention_rowmajor_plain(*args, **kw)
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    require(bool(torch.isfinite(out).all()), "K2 at R 33: non-finite output")
    require(torch.allclose(out, ref, atol=2e-2, rtol=2e-2),
            f"K2 at R 33: max abs err {max_err(out, ref)}")
    S = K + step + 1
    keys, vals = (torch.cat([p[layer].repeat_interleave(R, 0),
                             g[:, layer, :step], n[:, None]], 1)
                  for p, g, n in ((pk, gk, kn), (pv, gv, vn)))
    nbytes = 3 * B * D * 2 + 2 * N * K * D * 2 + 2 * B * step * D * 2 \
        + B * D * 4
    b_ms, b_by = bound_ms(nbytes, 4.0 * B * D * S, torch.bfloat16)
    plan = da.attention_plan(N, R, K, D, hd, step, 2)
    return dict(R=R, grid=list(plan["grid"]), max_abs_err=max_err(out, ref),
                ms=time_ms(kernel), plain_ms=time_ms(plain), bound_ms=b_ms,
                bound_by=b_by, library_ms=sdpa_ms(q, keys, vals, H),
                shape=f"N={N} R={R} K={K} step={step} e_cap={E} D={D} bf16")


# ---------------------------------------------------------------------------
# The two other mappers, trained, saved and served
# ---------------------------------------------------------------------------

NEW_MAPPERS = ("transformer_decoder", "mapping_network")
MAPPER_STEPS = 3


def mapper_mode(mapping_type, ds, out_dir, embeds) -> dict:
    """A full-width caption model with `mapping_type`'s mapper (8 layers,
    the encoder-decoder's encoder 512 wide): MAPPER_STEPS steps of (j)
    through train.loop.train (finite losses, the no-noise loss on the
    corpus's distinct rows falling, no decode kernel launched), the loop's
    `smoke_latest.pt` read back with an inferred config, 64 captions
    served from it on the beam path (K1-K4), and its mapper's f32 forward
    at batch 2 on the card against the CPU (1e-4 relative L2)."""
    import pathlib
    from capdec_tpu_torch.models import caption_model, mappers
    from capdec_tpu_torch.train import loop, step
    from capdec_tpu_torch.utils import checkpoint
    cfg = model_config(mapping_type=mapping_type, only_prefix=True)
    model = caption_model.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED), device=DEVICE)
    rows = np.arange(TRAIN["distinct"])
    fixed = {"tokens": ds.tokens[rows], "mask": ds.mask[rows],
             "prefix": ds.batch_prefixes(rows)}
    eval_fn = step.make_eval_step(cfg)
    loss0 = float(eval_fn(model, fixed))
    out_dir = pathlib.Path(out_dir)
    zero_counters()
    t0 = time.perf_counter()
    loop.train(cfg, loop.TrainLoopConfig(
        epochs=1, batch_size=TRAIN["batch"], lr=TRAIN["lr"], warmup_steps=0,
        out_dir=str(out_dir), prefix="smoke", log_every=1, seed=SEED,
        save_state=False, max_steps=MAPPER_STEPS,
        latest_every_steps=MAPPER_STEPS), ds,
        step.NoiseConfig(variance=TRAIN["variance"]), params=model,
        device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launch_set((), f"{mapping_type} training")
    with open(out_dir / "metrics.jsonl") as f:
        losses = [json.loads(line)["loss"] for line in f]
    require(len(losses) == MAPPER_STEPS and np.isfinite(losses).all(),
            f"{mapping_type} training: losses {losses}")
    loss1 = float(eval_fn(model, fixed))
    require(np.isfinite(loss1) and loss1 < loss0,
            f"{mapping_type} training: the loss on the distinct rows went "
            f"{loss0} -> {loss1}")
    del model
    sd = checkpoint.load_state_dict(
        checkpoint.latest_checkpoint_path(str(out_dir), "smoke"))
    inferred = caption_model.config_from_torch_state_dict(
        sd, compute_dtype=torch.bfloat16)
    layers = 7 if mapping_type == "mapping_network" else cfg.num_layers
    require(dataclasses.replace(cfg, only_prefix=False, num_layers=layers)
            == inferred, f"{mapping_type}: inferred config {inferred}")
    served = caption_model.params_from_torch_state_dict(sd, inferred, DEVICE)
    server = build_server(None, model=served, cfg=inferred)[0]
    run = serve_path(server, embeds[:MAIN["N"]], BEAM_PATH)
    del server, served
    # the mapper alone in f32 on both devices, from the saved weights
    mcfg = inferred.mapper
    x = embeds[:TRAIN["cpu_batch"]]
    x = torch.from_numpy((x / np.linalg.norm(x, axis=-1, keepdims=True))
                         .astype(np.float32))
    msd = {k[len("clip_project."):]: v for k, v in sd.items()
           if k.startswith("clip_project.")}
    outs = {}
    for dev in ("cpu", DEVICE):
        mapper = mappers.build_mapper(mcfg, dev)
        mapper.load_state_dict(msd, strict=True)
        with torch.no_grad():
            outs[dev] = mapper(x.to(dev)).cpu().double()
    rel = float((outs[DEVICE] - outs["cpu"]).norm() / outs["cpu"].norm())
    require(rel <= 1e-4, f"{mapping_type}: f32 forward card vs CPU {rel} "
                         "relative L2")
    torch.cuda.empty_cache()
    return dict(mapping_type=mapping_type, steps=MAPPER_STEPS,
                losses=losses, distinct_rows_loss=[loss0, loss1],
                train_wall_s=wall, inferred_num_layers=inferred.num_layers,
                served=run["served"], serve_captions_per_s=run["captions_per_s"],
                launches=run["launches"], f32_forward_card_cpu_rel_l2=rel)


# ---------------------------------------------------------------------------
# The predict CLI from (j)'s checkpoint
# ---------------------------------------------------------------------------

PREDICT_RUNS = (("beam", [], BEAM_PATH), ("int8", ["--int8_kv"], INT8_PATH),
                ("greedy", ["--no_beam"], GREEDY_PATH))


def predict_inputs(embeds, tmp: str, n: int = MAIN["requests"]) -> dict:
    """The predict CLI's inputs for n records: the dataset_mode-0
    registry under tmp/data, a GT file and the embeddings pickle."""
    import pickle
    rng = np.random.RandomState(SEED + 1)
    records = [{"image_id": i, "clip_embedding": i,
                "caption": " ".join(rng.choice(WORDS, 8)) + "."}
               for i in range(n)]
    root = f"{tmp}/data"
    os.makedirs(f"{root}/coco/annotations")
    with open(f"{root}/coco/annotations/single_caption_per_sample_val.json",
              "w") as f:
        json.dump(records, f)
    gt = f"{tmp}/gt.json"
    with open(gt, "w") as f:
        json.dump({"images": [{"id": r["image_id"]} for r in records],
                   "annotations": [{"image_id": r["image_id"], "id": i,
                                    "caption": r["caption"]}
                                   for i, r in enumerate(records)]}, f)
    pkl = f"{tmp}/predict_embeddings.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"clip_embedding": embeds[:n], "captions": records}, f)
    return dict(root=root, gt=gt, pkl=pkl)


def predict_once(ckpt: str, inputs: dict, out: str, flags, path,
                 what: str, n: int = MAIN["requests"]) -> dict:
    """One predict CLI call on the card over n records (its launch set
    asserted and returned with the captions written and the scores)."""
    from capdec_tpu_torch.cli import predict
    old_root = os.environ.get("CAPDEC_DATA_ROOT")
    os.environ["CAPDEC_DATA_ROOT"] = inputs["root"]
    try:
        zero_counters()
        t0 = time.perf_counter()
        results = predict.main([
            "--checkpoint", ckpt, "--infer_model_config",
            "--embeddings_pickle", inputs["pkl"], "--score_gt", inputs["gt"],
            "--batch_size", str(MAIN["N"]), "--out", out,
            "--dataset_mode", "0", *flags])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_set(path, what)
    finally:
        if old_root is None:
            os.environ.pop("CAPDEC_DATA_ROOT", None)
        else:
            os.environ["CAPDEC_DATA_ROOT"] = old_root
    with open(out) as f:
        written = json.load(f)
    require(written == results and
            [r["image_id"] for r in written] == list(range(n)),
            f"{what}: {len(written)} captions written")
    name_of = os.path.basename(ckpt).split(".")[0]
    with open(f"{os.path.dirname(out)}/{name_of}_scores.json") as f:
        scores = json.load(f)
    return dict(captions=len(written), wall_s=wall,
                captions_per_s=len(written) / wall, launches=launches,
                scores={k: scores[k] for k in ("Bleu_4", "METEOR",
                                               "ROUGE_L", "CIDEr")},
                written=written)


def predict_runs(ckpt: str, embeds, tmp: str) -> dict:
    """`capdec_tpu_torch.cli.predict.main` on the card from `ckpt` with
    --infer_model_config, --embeddings_pickle (MAIN["requests"] records)
    and --score_gt at batch 64: beam, --int8_kv and --no_beam, each with
    its launch set and a caption per record (captions/s over the whole
    CLI call: loading, config inference and scoring included). The beam
    run's first 64 captions must equal, lowercased, what CaptionServer
    gives the same 64 embeddings at batch 64: one engine on one batch."""
    from capdec_tpu_torch.models import caption_model
    from capdec_tpu_torch.utils import checkpoint
    from capdec_tpu_torch.utils.tokenizer import load_tokenizer
    inputs = predict_inputs(embeds, tmp)
    runs = {}
    for name, flags, path in PREDICT_RUNS:
        runs[name] = predict_once(ckpt, inputs, f"{tmp}/predict_{name}.json",
                                  flags, path, f"predict {name}")
        del runs[name]["written"]
    sd = checkpoint.load_state_dict(ckpt)
    cfg = caption_model.config_from_torch_state_dict(
        sd, compute_dtype=torch.bfloat16)
    server = build_server(
        None, model=caption_model.params_from_torch_state_dict(
            sd, cfg, DEVICE), cfg=cfg, tokenizer=load_tokenizer())[0]
    captions = server.caption(embeds[:MAIN["N"]])
    with open(f"{tmp}/predict_beam.json") as f:
        beam = [r["caption"] for r in json.load(f)[:MAIN["N"]]]
    same = sum(a == b.lower() for a, b in zip(beam, captions))
    require(same == MAIN["N"], f"predict beam vs CaptionServer: "
                               f"{same} of {MAIN['N']} captions equal")
    runs["beam"]["equal_to_server"] = same
    del server
    torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------------------------------
# The mesh phase: the dp x tp path at world 1 on NCCL, against the same
# runs without a mesh
# ---------------------------------------------------------------------------

MESH_TRAIN_STEPS = 3
# a tp=2 rank of GPT-2 124M: 6 of the 12 heads, K/V 384 wide
TP2 = dict(D=MAIN["D"] // 2, H=MAIN["H"] // 2)


def check_kv_kernels(gen, N, D, H, label) -> dict:
    """K2, K3 and K4 at other shapes than phase 2's (N images x R 5, K/V
    width D over H heads of 64; `label` names the case) against their
    plain versions, as check_decode_attention and check_cache_kernels do
    at the main path's: K2 in bf16 with NaN in the slots it must not read,
    within 2e-2; K3 (from views and from tensors) and K4 bit for bit.
    Times beside the plain
    versions, SDPA (K2), stack + index_copy_ (K3), the empty kernel on the
    grid (K3, K4) and the bounds."""
    from capdec_tpu_torch.ops import cache_reorder as cr
    from capdec_tpu_torch.ops import decode_attention as da
    R, L, K, E = (MAIN[k] for k in ("R", "L", "K", "E"))
    B, hd, layer = N * R, D // H, L // 2
    rand = lambda *s: torch.randn(*s, generator=gen, device=DEVICE).to(
        torch.bfloat16)
    q, kn, vn = rand(B, 3 * D).split(D, dim=-1)
    pk, pv = rand(L, N, K, D), rand(L, N, K, D)
    gk, gv = rand(B, L, E, D), rand(B, L, E, D)
    err = 0.0
    for step in (1, 17, MAIN["entry_length"] - 1):
        sk, sv = gk.clone(), gv.clone()
        sk[:, :, step:] = float("nan")  # stale slots must never be read
        sv[:, :, step:] = float("nan")
        for e_cap in (16, E):
            args = (q, kn, vn, pk, pv, sk, sv, step, layer)
            kw = dict(beams_per_image=R, head_dim=hd, e_cap=e_cap)
            out = da.beam_decode_attention_rowmajor(*args, **kw)
            ref = da.beam_decode_attention_rowmajor_plain(*args, **kw)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(out).all()) and
                    torch.allclose(out, ref, atol=2e-2, rtol=2e-2),
                    f"K2 at {label}, step {step} e_cap "
                    f"{e_cap}: max abs err {max_err(out, ref)}")
            err = max(err, max_err(out, ref))
    step = MAIN["entry_length"] - 1
    kw = dict(beams_per_image=R, head_dim=hd, e_cap=E)
    steps = attention_step_times(
        lambda s, l: da.beam_decode_attention_rowmajor(
            q, kn, vn, pk, pv, sk, sv, s, l, **kw),
        q, kn, vn, pk, pv, sk, sv, R, H)
    k2 = dict(max_abs_err=err, plain_ms=time_ms(
        lambda: da.beam_decode_attention_rowmajor_plain(
            q, kn, vn, pk, pv, sk, sv, step, layer, **kw)),
        **steps[step], shape=f"N={N} R={R} K={K} step={step} e_cap={E} "
                             f"D={D} H={H} bf16 ({label})")

    src = _lane_src(torch.Generator().manual_seed(SEED), N, R).to(DEVICE)
    del sk, sv, q, kn, vn, pk, pv
    rowmajor_write_checks(gen, cr.write_gen_slot_chunk,
                          cr.write_gen_slot_chunk_plain, f"K3 at {label}", B,
                          L, E, D, (30,), dtypes=(torch.bfloat16,))
    k3 = dict(max_abs_err=0.0, **rowmajor_write_times(
        gen, cr.write_gen_slot_chunk, cr.write_gen_slot_chunk_plain, gk, gv),
        shape=f"B={B} L={L} E={E} D={D} bf16 ({label}), from views")
    k4 = fork_copy_checks(gk, gv, src, MAIN["entry_length"] - 1, label)
    return {"beam_decode_attention_rowmajor": k2,
            "write_gen_slot_chunk": k3, "copy_forked_rows_bounded": k4}


def mesh_train_run(mesh, ds, out_dir) -> dict:
    """MESH_TRAIN_STEPS steps of (j) at full width through
    train.loop.train, under `mesh` or without one, from the seed's
    weights: the logged losses, the mapper's weights after, and the last
    logged step rate (steps 2..MESH_TRAIN_STEPS)."""
    from capdec_tpu_torch.models import caption_model
    from capdec_tpu_torch.train import loop, step
    cfg = model_config(only_prefix=True)
    model = caption_model.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED), device=DEVICE)
    loop.train(cfg, loop.TrainLoopConfig(
        epochs=1, batch_size=TRAIN["batch"], lr=TRAIN["lr"], warmup_steps=0,
        out_dir=out_dir, prefix="mesh", log_every=1, seed=SEED,
        save_state=False, max_steps=MESH_TRAIN_STEPS), ds,
        step.NoiseConfig(variance=TRAIN["variance"]), params=model,
        mesh=mesh, device=DEVICE)
    with open(f"{out_dir}/metrics.jsonl") as f:
        logged = [json.loads(line) for line in f]
    mapper = {n: p.detach().clone()
              for n, p in model.clip_project.named_parameters()}
    del model
    return dict(losses=[m["loss"] for m in logged], mapper=mapper,
                ms_per_step=1e3 / logged[-1]["steps_per_sec"])


def mesh_phase(gen, ds, ckpt: str, embeds, tmp: str) -> dict:
    """The parallel path at world 1 on the card: a world-1 NCCL process
    group in this process (destroyed at the end), a (dp 1, tp 1) mesh,
    and each run against the same run without it.
      * (j) for MESH_TRAIN_STEPS steps at full width: the losses and the
        mapper's weights bit-equal (one rank's all-reduce and a division
        by the summed count are exact), in the order plain, mesh, mesh,
        plain for the per-step overhead;
      * the predict CLI with `--mesh 1` on MAIN["requests"] records, beam
        and --int8_kv: the captions equal, and the launch counts of K1-K4
        and of K1, K5-K7 equal;
      * CaptionServer under the mesh on MAIN["requests"] requests: the
        captions and launch counts equal;
      * torch_entry.entry(): the flagship loss finite;
      * K2, K3 and K4 at a tp=2 rank's shapes (check_kv_kernels).
    Returns the numbers and the runs' launch counts."""
    import torch.distributed as dist
    import torch_entry
    from capdec_tpu_torch.parallel import mesh as mesh_lib
    mesh = mesh_lib.make_mesh(dp=1, tp=1, device=DEVICE)
    try:
        require(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
                f"mesh: backend {dist.get_backend()}, world "
                f"{dist.get_world_size()}")
        zero_counters()
        train = [mesh_train_run(m, ds, f"{tmp}/mesh_train_{i}")
                 for i, m in enumerate((None, mesh, mesh, None))]
        require(not any(fn.launches for fn in counters().values()),
                "mesh: training launched decode kernels")
        for plain, meshed in ((train[0], train[1]), (train[3], train[2])):
            require(plain["losses"] == meshed["losses"] and
                    len(plain["losses"]) == MESH_TRAIN_STEPS and
                    np.isfinite(plain["losses"]).all(),
                    f"mesh train: losses {plain['losses']} vs "
                    f"{meshed['losses']}")
            for n, p in plain["mapper"].items():
                require(torch.equal(p, meshed["mapper"][n]),
                        f"mesh train: mapper {n} differs")
        plain_ms = [train[i]["ms_per_step"] for i in (0, 3)]
        mesh_ms = [train[i]["ms_per_step"] for i in (1, 2)]
        del train

        inputs = predict_inputs(embeds, f"{tmp}/mesh_predict")
        runs = {}
        for name, flags, path in PREDICT_RUNS[:2]:
            got = {}
            for tag, extra in (("plain", []), ("mesh", ["--mesh", "1"])):
                got[tag] = predict_once(
                    ckpt, inputs, f"{tmp}/mesh_predict/{name}_{tag}.json",
                    [*flags, *extra], path, f"mesh predict {name} {tag}")
            require(got["plain"].pop("written") == got["mesh"].pop("written"),
                    f"mesh predict {name}: captions differ")
            require(got["plain"]["launches"] == got["mesh"]["launches"],
                    f"mesh predict {name}: launches {got['plain']['launches']}"
                    f" vs {got['mesh']['launches']}")
            runs[name] = got

        from capdec_tpu_torch.models import caption_model
        from capdec_tpu_torch.utils import checkpoint
        sd = checkpoint.load_state_dict(ckpt)
        cfg = caption_model.config_from_torch_state_dict(
            sd, compute_dtype=torch.bfloat16)
        model = caption_model.params_from_torch_state_dict(sd, cfg, DEVICE)
        served = {}
        for tag, m in (("plain", None), ("mesh", mesh)):
            server = build_server(None, model=model, cfg=cfg, mesh=m)[0]
            server.warmup()
            served[tag] = serve_path(server, embeds, BEAM_PATH,
                                     keep_captions=True)
            server.close()
            del server
        require(served["plain"].pop("captions") ==
                served["mesh"].pop("captions"),
                "mesh serve: captions differ")
        require(served["plain"]["launches"] == served["mesh"]["launches"],
                "mesh serve: launch counts differ")
        del model

        fn, args = torch_entry.entry()
        entry_loss = float(fn(*args))
        require(np.isfinite(entry_loss), f"entry: loss {entry_loss}")
        del fn, args
        torch.cuda.empty_cache()
        tp2 = check_kv_kernels(gen, MAIN["N"], TP2["D"], TP2["H"],
                               "a tp=2 rank")
    finally:
        dist.destroy_process_group()
    return dict(
        backend="nccl", world=1, train_steps=MESH_TRAIN_STEPS,
        train_bit_equal=True, train_ms_per_step_plain=plain_ms,
        train_ms_per_step_mesh=mesh_ms,
        train_overhead_ms_per_step=float(np.mean(mesh_ms)
                                         - np.mean(plain_ms)),
        predict=runs, serve=served,
        serve_captions_per_s={t: r["captions_per_s"]
                              for t, r in served.items()},
        entry_loss=entry_loss, tp2=tp2)


# ---------------------------------------------------------------------------
# The lifecycle phase: the predict and train CLIs as processes of their
# own under torchrun, each owning its NCCL group
# ---------------------------------------------------------------------------

LIFECYCLE = dict(records=16, train_steps=2, timeout_s=300)
# PyTorch's warning at exit when a group was never destroyed, and what a
# process aborted in a collective thread prints
UNCLOSED = ("destroy_process_group", "terminate called")


@contextlib.contextmanager
def torchrun_clis(runs: dict, log_dir: str):
    """Start each of runs {tag: (module, argv, env)} at once as `python -m
    torch.distributed.run --standalone --nproc_per_node 1 -m module argv`
    in a session of its own (stdout and stderr to log_dir/tag.*); yield a
    function that waits for one and returns (stdout, stderr, wall s, rc).
    Every process group still running at the end is killed."""
    os.makedirs(log_dir)
    procs = {}
    try:
        for tag, (module, argv, env) in runs.items():
            out = open(f"{log_dir}/{tag}.stdout", "w")
            err = open(f"{log_dir}/{tag}.stderr", "w")
            proc = subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc_per_node", "1", "-m", module,
                 *argv], cwd=ROOT, env=env, stdout=out, stderr=err,
                start_new_session=True)
            procs[tag] = (proc, out, err, time.perf_counter())

        def wait(tag):
            proc, out, err, t0 = procs[tag]
            try:
                proc.wait(timeout=LIFECYCLE["timeout_s"])
            except subprocess.TimeoutExpired:
                pass
            wall = time.perf_counter() - t0
            out.close()
            err.close()
            with open(out.name) as f, open(err.name) as g:
                return f.read(), g.read(), wall, proc.returncode

        yield wait
    finally:
        for proc, out, err, _ in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            out.close()
            err.close()


def lifecycle_phase(ckpt: str, corpus: str, embeds, tmp: str) -> dict:
    """The predict and train CLIs each as a process of its own under
    torchrun on the card (NCCL, a world of 1, the group theirs), at once:
      * predict --mesh 1 from (j)'s `smoke-000.pt` on LIFECYCLE["records"]
      records at batch 64, beam 5 (K1-K4 and the epilogues only, counted in the
      process through LAUNCH_SITECUSTOMIZE), whose captions must equal an
        in-process run's without a mesh on the same records;
      * train --mesh 1,1 --max_steps 2 at full width (GPT-2 124M, the
        8-layer mapper, --only_prefix, --bf16, batch 30) from the smoke's
        corpus: LIFECYCLE["train_steps"] finite losses in the state's
        sidecar, no decode kernel launched (counted the same way).
    Each must exit 0 with neither of UNCLOSED in its stderr. Returns the
    wall seconds of each and of the phase."""
    t0 = time.perf_counter()
    n = LIFECYCLE["records"]
    inputs = predict_inputs(embeds, f"{tmp}/lifecycle_inputs", n=n)
    site = f"{tmp}/lifecycle_site"
    os.makedirs(site)
    kernels = launch_sites()
    with open(f"{site}/sitecustomize.py", "w") as f:
        f.write(LAUNCH_SITECUSTOMIZE.format(kernels=kernels))
    log_dir, out = f"{tmp}/lifecycle", f"{tmp}/lifecycle_out"
    predict_json = f"{out}/predict_mesh.json"
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=os.pathsep.join(
        [site, str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]),
        CAPDEC_DATA_ROOT=inputs["root"])
    launches_of = lambda tag: f"{log_dir}_{tag}.launches"
    runs = {
        "predict": ("capdec_tpu_torch.cli.predict", [
            "--checkpoint", ckpt, "--infer_model_config",
            "--embeddings_pickle", inputs["pkl"], "--score_gt", inputs["gt"],
            "--batch_size", str(MAIN["N"]), "--out", predict_json,
            "--dataset_mode", "0", "--mesh", "1"]),
        "train": ("capdec_tpu_torch.cli.train", [
            "--data", corpus, "--out_dir", f"{out}/train", "--mesh", "1,1",
            "--max_steps", str(LIFECYCLE["train_steps"]), "--only_prefix",
            "--bf16", "--bs", str(TRAIN["batch"]), "--noise_variance",
            str(TRAIN["variance"]), "--lr", str(TRAIN["lr"]), "--epochs",
            "1", "--prefix", "lifecycle"])}
    runs = {tag: (module, argv, dict(env, CAPDEC_SMOKE_LAUNCHES=launches_of(
        tag))) for tag, (module, argv) in runs.items()}
    result = {}
    with torchrun_clis(runs, log_dir) as wait:
        # the same records in this process, no mesh, while they run
        plain = predict_once(ckpt, inputs, f"{out}/predict_plain.json", [],
                             BEAM_PATH, "lifecycle predict plain", n=n)
        for tag in runs:
            stdout, stderr, wall, rc = wait(tag)
            require(rc == 0, f"lifecycle {tag} under torchrun exited {rc}:"
                             f"\n{stdout[-2000:]}\n{stderr[-3000:]}")
            for said in UNCLOSED:
                require(said not in stderr, f"lifecycle {tag}: '{said}' in "
                                            f"stderr:\n{stderr[-3000:]}")
            result[tag] = dict(rc=rc, wall_s=wall)
    with open(predict_json) as f:
        written = json.load(f)
    require(written == plain["written"] and len(written) == n,
            f"lifecycle predict --mesh 1: {len(written)} captions, "
            f"not the in-process run's")
    for tag in runs:
        launches = {name: 0 for name in kernels}
        with open(launches_of(tag)) as f:
            procs = [json.loads(line) for line in f]
        for proc in procs:
            for name, c in proc.items():
                launches[name] += c
        result[tag].update(launches=launches, processes=len(procs))
    require_launch_set(result["predict"]["launches"], BEAM_PATH,
                       "lifecycle predict --mesh 1")
    require(not any(result["train"]["launches"].values()),
            f"lifecycle train: decode kernels launched "
            f"{result['train']['launches']}")
    losses = np.load(f"{out}/train/epoch_losses_latest.npz")["losses"]
    require(len(losses) == LIFECYCLE["train_steps"] and
            np.isfinite(losses).all(), f"lifecycle train: losses {losses}")
    result["predict"].update(captions=len(written), equal_to_plain=True)
    result["train"].update(losses=losses.tolist())
    result["phase_s"] = time.perf_counter() - t0
    return result


# ---------------------------------------------------------------------------
# The cache-api phase: GPT-2's single-cache API (init_kv_cache,
# forward_with_cache) at full width
# ---------------------------------------------------------------------------

CACHE_API = dict(N=5, steps=26, S_max=MAIN["entry_length"])


def cached_greedy(model, cfg, prefix, steps: int, S: int):
    """Greedy decode through forward_with_cache: the prefix prefilled into
    a cache of S slots, then `steps` one-token steps. Returns (tokens [N,
    steps + 1], each step's f32 logits [N, steps + 1, V], prefill ms, ms a
    decode step)."""
    from capdec_tpu_torch.models import gpt2
    N, K, _ = prefix.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = gpt2.init_kv_cache(cfg, N, S, device=DEVICE)
    logits, cache = gpt2.forward_with_cache(model, cfg, prefix, cache, 0)
    step_logits = [logits[:, -1]]
    toks = [step_logits[-1].argmax(-1)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(steps):
        logits, cache = gpt2.forward_with_cache(
            model, cfg, gpt2.embed_tokens(model, toks[-1])[:, None], cache,
            K + i)
        step_logits.append(logits[:, 0])
        toks.append(step_logits[-1].argmax(-1))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (torch.stack(toks, 1), torch.stack(step_logits, 1),
            1e3 * (t1 - t0), 1e3 * (t2 - t1) / steps)


@torch.no_grad()
def cache_api_phase() -> dict:
    """GPT-2 124M from the seed, CACHE_API["N"] rows of a MAIN["K"]-slot
    prefix (random embeddings at wte's scale) prefilled into an
    S_max = CACHE_API["S_max"] cache, then CACHE_API["steps"] greedy
    decode steps through forward_with_cache:
      * f32: each step's logits within 1e-4 relative (max |diff| over max
        |logit|) of the full forward's on the prefix and the same tokens;
      * bf16 (the decode cast of the weights, as the engines take them):
        each step's logits within 2e-2 relative of the bf16 full
        forward's, and the tokens equal to the greedy engine's
        (decode/topp.py, default ToppConfig routes: plain attention math
        and K1, no stop token) on the same prefix, but where a row meets
        a rounding tie: final_logits rounds a bf16 product to bf16, as
        the engine's prefill does, while K1 picks from f32 sums, so a row
        may part from the engine's only at a step where the two tokens'
        logits in the cached path lie within one bf16 ulp of the larger
        (equal up to that step; `ties` lists them).
    Returns the errors, the ties and the times."""
    from capdec_tpu_torch.decode import topp
    from capdec_tpu_torch.decode.beam import cast_params_for_decode
    from capdec_tpu_torch.models import gpt2
    t0 = time.perf_counter()
    N, steps, S = (CACHE_API[k] for k in ("N", "steps", "S_max"))
    shape = dict(vocab_size=MAIN["V"], n_embd=MAIN["D"], n_layer=MAIN["L"],
                 n_head=MAIN["H"])
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    f32 = gpt2.GPT2Config(**shape)
    model = gpt2.init_params(gpt2.GPT2LMHeadModel(f32, device=DEVICE), f32,
                             gen)
    prefix = 0.02 * torch.randn(N, MAIN["K"], MAIN["D"], generator=gen,
                                device=DEVICE)
    toks, logits, prefill_ms, step_ms = cached_greedy(model, f32, prefix,
                                                      steps, S)
    full = gpt2.forward(model, f32, torch.cat(
        [prefix, gpt2.embed_tokens(model, toks[:, :-1])], dim=1))
    full = full[:, MAIN["K"] - 1:]
    rel = ((logits - full).abs().amax(dim=(0, 2)) /
           full.abs().amax(dim=(0, 2))).tolist()
    require(len(rel) == steps + 1 and max(rel) <= 1e-4,
            f"cache api f32: relative errors by step {rel}")
    out = dict(f32=dict(max_rel_err=max(rel), prefill_ms=prefill_ms,
                        ms_per_step=step_ms))

    bf16 = gpt2.GPT2Config(**shape, compute_dtype=torch.bfloat16)
    cast = cast_params_for_decode(model, bf16)
    toks, logits, prefill_ms, step_ms = cached_greedy(cast, bf16, prefix,
                                                      steps, S)
    full = gpt2.forward(cast, bf16, torch.cat(
        [prefix, gpt2.embed_tokens(cast, toks[:, :-1])], dim=1))
    full = full[:, MAIN["K"] - 1:]
    rel = ((logits - full).abs().amax(dim=(0, 2)) /
           full.abs().amax(dim=(0, 2))).tolist()
    require(max(rel) <= 2e-2, f"cache api bf16: relative errors by step "
                              f"against the full forward {rel}")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    engine, lengths = topp.greedy_topp_search(
        cast, bf16, prefix, topp.ToppConfig(entry_length=steps + 1,
                                            stop_token=-1,
                                            extra_stop_token=-1))
    torch.cuda.synchronize()
    engine_ms = 1e3 * (time.perf_counter() - t1)
    require(engine.shape == toks.shape and
            bool((lengths == steps + 1).all()),
            f"cache api bf16: engine tokens {tuple(engine.shape)}")
    ties = []
    for row in range(N):
        parted = (engine[row] != toks[row]).nonzero()
        if len(parted):
            step = int(parted[0])
            mine, theirs = (float(logits[row, step, t[row, step]])
                            for t in (toks, engine))
            ulp = 2.0 ** (math.floor(math.log2(max(abs(mine), 1e-30))) - 7)
            require(mine - theirs <= ulp,
                    f"cache api bf16: row {row} parts from the greedy "
                    f"engine at step {step}, logits {mine} against "
                    f"{theirs}: not a rounding tie")
            ties.append(dict(row=row, step=step, logits=[mine, theirs]))
    out["bf16"] = dict(max_rel_err=max(rel), rows_equal_to_engine=N - len(
        ties), ties=ties, distinct_tokens=int(toks.unique().numel()),
        prefill_ms=prefill_ms, ms_per_step=step_ms, engine_ms=engine_ms)
    del model, cast
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# The clip phase: the README Quickstart (parse, embed, train, predict and
# score) at full width on random CLIP weights
# ---------------------------------------------------------------------------

CLIP_RUN = dict(test_images=128, val_images=128, train_images=120,
                captions_per_image=5, long_captions=6, train_bs=60,
                tower_images=64, tower_captions=256, cross_batch=4)
CLIP_FILES = {"RN50x4": "rn50x4.pt", "ViT-B/32": "vit_b32.pt"}
GENDER_WORDS = ("boy", "girl", "his", "her", "men", "women", "father",
                "mother")
IMAGE_SIZES = ((640, 480), (480, 640), (500, 375), (333, 500), (288, 288),
               (1024, 768), (200, 150), (427, 640))


def bpe_merges(words):
    """CLIP-format merges that build each word from its characters (a
    synthetic stand-in for bpe_simple_vocab_16e6.txt.gz)."""
    merges = {}
    for w in words:
        pieces = list(w[:-1]) + [w[-1] + "</w>"]
        cur = pieces[0]
        for piece in pieces[1:]:
            merges[(cur, piece)] = None
            cur += piece
    return list(merges)


def clip_inputs(tmp: str, rng) -> dict:
    """The synthetic BPE file, a Karpathy JSON (CLIP_RUN["test_images"]
    test images as COCO_val2014_{id:012d}.jpg files of mixed sizes and
    aspects, a val split, and a train + restval split of about 600
    captions of random words, some with gender terms, a few longer than 77
    tokens) and the fp16 OpenAI-layout checkpoints of both CLIPs from the
    port's random init at seed 0."""
    import gzip
    from PIL import Image
    from capdec_tpu_torch.models import clip
    vocab = WORDS + GENDER_WORDS
    bpe = f"{tmp}/bpe_simple_vocab_16e6.txt.gz"
    with gzip.open(bpe, "wt", encoding="utf-8") as f:
        f.write("version\n" + "\n".join(f"{a} {b}" for a, b in
                                        bpe_merges(vocab)) + "\n")

    def caption(n_words):
        words = list(rng.choice(vocab, n_words))
        if rng.rand() < 0.3:
            words[rng.randint(n_words)] = rng.choice(GENDER_WORDS)
        return " ".join(words) + "."

    images_dir = f"{tmp}/data/coco/val2014"
    os.makedirs(images_dir)
    entries, sentid = [], 0
    splits = (("test", CLIP_RUN["test_images"], 1),
              ("val", CLIP_RUN["val_images"], 1),
              ("train", CLIP_RUN["train_images"] - 20,
               CLIP_RUN["captions_per_image"]),
              ("restval", 20, CLIP_RUN["captions_per_image"]))
    long_left = CLIP_RUN["long_captions"]
    for base, (split, n, per) in zip((1, 1001, 2001, 3001), splits):
        for i in range(n):
            name = f"COCO_val2014_{base + i:012d}.jpg"
            if split == "test":
                w, h = IMAGE_SIZES[i % len(IMAGE_SIZES)]
                small = rng.randint(0, 256, (h // 16, w // 16, 3), np.uint8)
                Image.fromarray(small).resize((w, h), Image.BILINEAR).save(
                    f"{images_dir}/{name}", quality=90)
            sents = []
            for _ in range(per):
                n_words = rng.randint(6, 13)
                if split in ("train", "restval") and long_left:
                    n_words, long_left = 90, long_left - 1
                sents.append({"raw": caption(n_words), "sentid": sentid})
                sentid += 1
            entries.append({"filename": name, "split": split,
                            "sentences": sents})
    karpathy = f"{tmp}/dataset_coco.json"
    with open(karpathy, "w") as f:
        json.dump({"images": entries}, f)
    ckpts = {}
    for name, fname in CLIP_FILES.items():
        model = clip.build_model(
            clip.MODEL_CONFIGS[name],
            torch.Generator(device=DEVICE).manual_seed(SEED), device=DEVICE)
        ckpts[name] = f"{tmp}/{fname}"
        clip.save_openai_checkpoint(model, ckpts[name])
        del model
    torch.cuda.empty_cache()
    return dict(bpe=bpe, karpathy=karpathy, root=f"{tmp}/data",
                images=images_dir, ckpts=ckpts)


@contextlib.contextmanager
def env_vars(**kw):
    """os.environ updated with kw inside the block, restored after."""
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def timed_cli(main, argv):
    """One in-process CLI call: (its return value, its wall seconds, the
    card synchronised at the end)."""
    t0 = time.perf_counter()
    out = main(argv)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def tower_checks(name, ckpt, images_dir, records, bpe) -> dict:
    """One CLIP's towers from its fp16 checkpoint in f32: each tower's
    rate on the card (CLIP_RUN["tower_images"] preprocessed test images,
    CLIP_RUN["tower_captions"] captions; CUDA events), each tower's output
    on a batch of CLIP_RUN["cross_batch"] on the card against the CPU
    (1e-4 relative L2), and the largest activation after each stage of
    the ResNet, which must stay finite."""
    from capdec_tpu_torch.data.image_ops import load_and_preprocess
    from capdec_tpu_torch.models import clip
    from capdec_tpu_torch.utils.clip_tokenizer import (
        CLIPTokenizer, tokenize_with_truncation)
    card, cfg = clip.load_openai_checkpoint(ckpt, name, device=DEVICE)
    cpu, _ = clip.load_openai_checkpoint(ckpt, name, device="cpu")
    n_px = cfg.vision.image_resolution
    tok = CLIPTokenizer(bpe)
    images = torch.from_numpy(np.stack([
        load_and_preprocess(f"{images_dir}/{r['filename']}", n_px)
        for r in records[:CLIP_RUN["tower_images"]]])).to(DEVICE)
    rows = [tokenize_with_truncation(tok, r["caption"])[0][0] for r in records]
    reps = -(-CLIP_RUN["tower_captions"] // len(rows))
    tokens = torch.from_numpy(np.stack((rows * reps)[
        :CLIP_RUN["tower_captions"]])).to(DEVICE)
    image_ms = time_ms(lambda: card.encode_image(images), iters=5, warmup=2)
    text_ms = time_ms(lambda: card.encode_text(tokens), iters=5, warmup=2)
    b = CLIP_RUN["cross_batch"]
    rel = {}
    for tower, x in (("image", images[:b]), ("text", tokens[:b])):
        encode = f"encode_{tower}"
        want = getattr(cpu, encode)(x.cpu()).double()
        got = getattr(card, encode)(x).cpu().double()
        require(bool(torch.isfinite(got).all()), f"{name} {tower}: not finite")
        rel[tower] = float((got - want).norm() / want.norm())
        require(rel[tower] <= 1e-4, f"{name} {tower} tower: card vs CPU "
                                    f"{rel[tower]} relative L2")
    stages = {}
    if cfg.is_resnet:
        v = card.visual
        with torch.no_grad():
            x = v.stem(images[:b].permute(0, 3, 1, 2))
            stages["stem"] = float(x.abs().max())
            for i in range(1, 5):
                x = getattr(v, f"layer{i}")(x)
                stages[f"layer{i}"] = float(x.abs().max())
            stages["attnpool"] = float(v.attnpool(x).abs().max())
        require(all(np.isfinite(list(stages.values()))),
                f"{name}: activations not finite {stages}")
    del card, cpu
    torch.cuda.empty_cache()
    return dict(image_tower_images_per_s=CLIP_RUN["tower_images"] / image_ms
                * 1e3, image_tower_ms=image_ms,
                text_tower_captions_per_s=CLIP_RUN["tower_captions"] / text_ms
                * 1e3, text_tower_ms=text_ms,
                card_cpu_rel_l2=rel, max_abs_activation=stages)


def clip_phase(tmp: str):
    """The Quickstart chain on the card from caption text and image files
    to scored captions, at full width: parse_corpus karpathy;
    embeddings_generator text mode with RN50x4 and gender balancing; the
    train CLI (one epoch of --only_prefix, 10 steps); predict
    --clip_checkpoint --infer_model_config --score_gt at batch 64, beam 5, on
    the 128 test images (K1-K4, the epilogues and no other kernel, 128
    captions); the same from a pickle embeddings_generator wrote in image mode
    (the same
    captions). Then ViT-B/32: embeddings_generator image mode, a 512-wide
    checkpoint trained the same way, and predict --text_autoencoder on
    ViT-B/32's text tower. Every tower card against CPU in f32. Returns
    the phase's results and its artifacts for the recipes phase: the
    inputs (clip_inputs), the RN50x4 caption checkpoint and the test
    records."""
    import pickle
    from capdec_tpu_torch.cli import embeddings_generator, parse_corpus
    from capdec_tpu_torch.cli import predict, train
    ins = clip_inputs(tmp, np.random.RandomState(SEED + 2))
    root, ann = ins["root"], f"{ins['root']}/coco/annotations"
    steps, runs = {}, {}
    with env_vars(CAPDEC_DATA_ROOT=root, CAPDEC_CLIP_BPE_PATH=ins["bpe"]):
        _, wall = timed_cli(parse_corpus.main, [
            "karpathy", "--karpathy_json", ins["karpathy"], "--out_dir", ann])
        with open(f"{ann}/train.json") as f:
            n_train = len(json.load(f))
        with open(f"{ann}/test.json") as f:
            test = json.load(f)
        steps["parse"] = dict(wall_s=wall, captions=n_train + 2 * len(test))
        # dataset_mode 0's records: one caption per test image, its row in
        # an image-mode pickle and its file name
        for i, r in enumerate(test):
            r.update(clip_embedding=i,
                     filename=f"COCO_val2014_{r['image_id']:012d}.jpg")
        with open(f"{ann}/single_caption_per_sample_val.json", "w") as f:
            json.dump(test, f)
        n = len(test)
        require(n == CLIP_RUN["test_images"], f"clip: {n} test records")

        def embed(model_name, out, extra):
            _, wall = timed_cli(embeddings_generator.main, [
                "--clip_checkpoint", ins["ckpts"][model_name],
                "--clip_model_type", model_name, "--out", out,
                "--batch_size", "256", *extra])
            with open(out, "rb") as f:
                return pickle.load(f), wall

        def train_on(pkl, out_dir, extra):
            _, wall = timed_cli(train.main, [
                "--data", pkl, "--out_dir", out_dir, "--epochs", "1",
                "--only_prefix", "--bs", str(CLIP_RUN["train_bs"]),
                "--noise_variance", str(TRAIN["variance"]), "--lr",
                str(TRAIN["lr"]), "--bf16", "--prefix", "clip", *extra])
            return f"{out_dir}/clip-000.pt", wall

        def predict_run(name, ckpt, flags, gt):
            out = f"{tmp}/clip_predict_{name}.json"
            zero_counters()
            results, wall = timed_cli(predict.main, [
                "--checkpoint", ckpt, "--score_gt", f"{ann}/{gt}",
                "--batch_size", str(MAIN["N"]), "--out", out, *flags])
            launches = launch_set(BEAM_PATH, f"clip predict {name}")
            require(len(results) == n and all(
                isinstance(r["caption"], str) for r in results),
                f"clip predict {name}: {len(results)} captions")
            runs[name] = dict(captions=len(results), wall_s=wall,
                              captions_per_s=len(results) / wall,
                              launches=launches)
            return results

        text_pkl = f"{tmp}/clip_text_rn50x4.pkl"
        data, wall = embed("RN50x4", text_pkl, [
            "--annotations", f"{ann}/train.json",
            "--fix_gender_imbalance_mode", "1"])
        emb = data["clip_embedding_text_dave"]
        require(emb.shape == (n_train, 640) and np.isfinite(emb).all(),
                f"clip: text embeddings {emb.shape}")
        steps["embed_text"] = dict(wall_s=wall, captions_per_s=n_train / wall)
        rn_ckpt, wall = train_on(text_pkl, f"{tmp}/clip_train_rn", [])
        steps["train"] = dict(wall_s=wall, samples_per_s=n_train / wall,
                              steps=n_train // CLIP_RUN["train_bs"])
        image_route = predict_run("image", rn_ckpt, [
            "--infer_model_config", "--clip_checkpoint",
            ins["ckpts"]["RN50x4"], "--dataset_mode", "0"],
            "test_metrics_format.json")
        img_pkl = f"{tmp}/clip_images_rn50x4.pkl"
        data, wall = embed("RN50x4", img_pkl, [
            "--add_text_embedding", "0", "--images_path",
            ins["images"] + "/", "--annotations",
            f"{ann}/single_caption_per_sample_val.json"])
        require(data["clip_embedding"].shape == (n, 640),
                "clip: image-mode pickle shape")
        steps["embed_images_rn50x4"] = dict(wall_s=wall,
                                            images_per_s=n / wall)
        pickle_route = predict_run("pickle", rn_ckpt, [
            "--infer_model_config", "--embeddings_pickle", img_pkl,
            "--dataset_mode", "0"], "test_metrics_format.json")
        same = sum(a == b for a, b in zip(image_route, pickle_route))
        require(same == n, f"clip: image route vs image-mode pickle: {same} "
                           f"of {n} captions equal")
        runs["image"]["equal_to_pickle_route"] = same
        # ViT-B/32: image mode, then a 512-wide checkpoint for its text tower
        data, wall = embed("ViT-B/32", f"{tmp}/clip_images_vit.pkl", [
            "--add_text_embedding", "0", "--images_path",
            ins["images"] + "/", "--annotations",
            f"{ann}/single_caption_per_sample_val.json"])
        require(data["clip_embedding"].shape == (n, 512) and
                np.isfinite(data["clip_embedding"]).all(),
                "clip: ViT-B/32 image-mode pickle")
        steps["embed_images_vit_b32"] = dict(wall_s=wall,
                                             images_per_s=n / wall)
        vit_pkl = f"{tmp}/clip_text_vit.pkl"
        _, wall = embed("ViT-B/32", vit_pkl, [
            "--annotations", f"{ann}/train.json"])
        steps["embed_text_vit_b32"] = dict(wall_s=wall,
                                           captions_per_s=n_train / wall)
        vit_ckpt, wall = train_on(vit_pkl, f"{tmp}/clip_train_vit",
                                  ["--is_not_rn"])
        steps["train_vit_b32"] = dict(wall_s=wall,
                                      samples_per_s=n_train / wall)
        predict_run("text_autoencoder", vit_ckpt, [
            "--text_autoencoder", "--not_rn", "--clip_checkpoint",
            ins["ckpts"]["ViT-B/32"]], "val_metrics_format.json")
        towers = {name: tower_checks(name, ins["ckpts"][name], ins["images"],
                                     test, ins["bpe"])
                  for name in CLIP_FILES}
    torch.cuda.empty_cache()
    return (dict(steps=steps, predict=runs, towers=towers),
            dict(ins=ins, rn_ckpt=rn_ckpt, test=test))



# ---------------------------------------------------------------------------
# The recipes phase: the entry points above the library (the single-image
# demo, the zoo-parity chain, serving at batch 512, the int8 quality probe)
# ---------------------------------------------------------------------------

ROOT = pathlib.Path(__file__).resolve().parent
# serving at batch 512 (scripts/torch_serve_throughput.py's defaults); the
# f32 kernel-vs-plain checks there decode 23 steps (entry_length 24, cut
# from 67 for the plain path's time): the f32 cache [2560, 12, 24, 768]
# still spans 2.26e9 bytes, past 2^31
RECIPES = dict(serve_n=2048, serve_batch=512, identity_entry_length=24)
# K1-K7 and the epilogues: the exact and int8 beams
PROBE_PATH = BEAM_PATH + INT8_PATH[1:]

# sitecustomize.py for the zoo chain's python processes (its directory
# first on PYTHONPATH): at exit each appends its kernel launch counts to
# $CAPDEC_SMOKE_LAUNCHES; it first runs any sitecustomize it shadows.
# `kernels` maps each kernel's name to its wrapper's "module:function"
# (launch_sites()), or to the module alone where the two names agree
LAUNCH_SITECUSTOMIZE = """import atexit, json, os, sys
import importlib.machinery, importlib.util

KERNELS = {kernels!r}


def dump():
    counts = {{}}
    for name, where in KERNELS.items():
        module, _, attr = where.partition(":")
        mod = sys.modules.get(module)
        counts[name] = getattr(mod, attr or name).launches if mod else 0
    with open(os.environ["CAPDEC_SMOKE_LAUNCHES"], "a") as f:
        f.write(json.dumps(counts) + "\\n")


here = os.path.dirname(os.path.abspath(__file__))
shadowed = importlib.machinery.PathFinder.find_spec(
    "sitecustomize", [p for p in sys.path if os.path.abspath(p) != here])
if shadowed is not None:
    shadowed.loader.exec_module(importlib.util.module_from_spec(shadowed))
atexit.register(dump)
"""


def repo_module(rel: str):
    """A script or example of the checkout (ROOT/rel) as a module."""
    spec = importlib.util.spec_from_file_location(pathlib.Path(rel).stem,
                                                  ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def demo_run(gen, arts: dict, tmp: str) -> dict:
    """(a) examples/torch_inference_demo.py on the first test JPEG at full
    width (RN50x4, the clip phase's caption checkpoint: GPT-2 124M, the 8-layer
    mapper, bf16): the beam launches K1-K4 and the epilogues only, greedy K1
    and the epilogues; the demo's beam and greedy decodes of that image in f32
    through the kernels equal those through the plain versions (token_identity,
    N 1);
    K1 at B 5, R 5 and B 1, R 1 and K2-K4 at N 1 against their plain
    versions (the `demo` key of their rows); beam 0 equals the predict
    CLI's caption of that image alone at --batch_size 1 (K1-K4)."""
    from capdec_tpu_torch.cli import predict
    from capdec_tpu_torch.decode import BeamConfig, ToppConfig
    demo = repo_module("examples/torch_inference_demo.py")
    ins, record = arts["ins"], arts["test"][0]
    ckpt = ins["ckpts"]["RN50x4"]
    image = f"{ins['images']}/COCO_val2014_{record['image_id']:012d}.jpg"
    args = demo.build_parser().parse_args([
        "--image", image, "--checkpoint", arts["rn_ckpt"],
        "--clip_checkpoint", ckpt])
    t0 = time.perf_counter()
    m = demo.load(args)
    prefix = demo.prefix_embeds(m, image)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    zero_counters()
    t0 = time.perf_counter()
    beams = demo.beam_captions(m, prefix, args.beam_size)
    beam_s = time.perf_counter() - t0
    beam_launches = launch_set(BEAM_PATH, "demo beam")
    zero_counters()
    t0 = time.perf_counter()
    greedy = demo.greedy_caption(m, prefix)
    greedy_s = time.perf_counter() - t0
    greedy_launches = launch_set(GREEDY_PATH, "demo greedy")
    require(len(beams) == args.beam_size and
            all(isinstance(b, str) for b in (*beams, greedy)),
            f"demo: {len(beams)} beams")
    embed = demo.image_embedding(m, image)
    identity = {what: token_identity(m["model"], m["model_cfg"], beam, dc,
                                     m["gpt"], embed)
                for what, beam, dc in (
                    ("beam", True, BeamConfig(beam_size=args.beam_size)),
                    ("greedy", False, ToppConfig()))}
    del m, prefix
    torch.cuda.empty_cache()
    kernels = check_kv_kernels(gen, 1, MAIN["D"], MAIN["H"], "demo, N 1")
    kernels["lm_head_topk"] = lm_head_times(
        gen, {"beam": (args.beam_size, args.beam_size), "greedy_r1": (1, 1)})
    root = f"{tmp}/demo_root"
    os.makedirs(f"{root}/coco/annotations")
    os.symlink(ins["images"], f"{root}/coco/val2014")
    with open(f"{root}/coco/annotations/single_caption_per_sample_val.json",
              "w") as f:
        json.dump([record], f)
    zero_counters()
    with env_vars(CAPDEC_DATA_ROOT=root):
        results, wall = timed_cli(predict.main, [
            "--checkpoint", arts["rn_ckpt"], "--clip_checkpoint", ckpt,
            "--batch_size", "1", "--out", f"{tmp}/demo_predict.json"])
    predict_launches = launch_set(BEAM_PATH, "demo's predict at batch 1")
    require(len(results) == 1 and results[0]["caption"] == beams[0].lower(),
            f"demo: beam 0 {beams[0]!r} vs predict's "
            f"{results[0]['caption']!r}")
    torch.cuda.empty_cache()
    return dict(image=os.path.basename(image), load_s=load_s, beams=beams,
                greedy=greedy, beam_s=beam_s, greedy_s=greedy_s,
                predict_wall_s=wall, equal_to_predict=True,
                token_identity=identity, kernels=kernels,
                launches={"beam": beam_launches, "greedy": greedy_launches,
                          "predict": predict_launches})


def zoo_chain(arts: dict, tmp: str) -> dict:
    """(b) scripts/torch_zoo_parity.sh, unmodified, on the full-width
    stand-ins: the clip phase's RN50x4 caption checkpoint as the zoo
    checkpoint, its Karpathy JSON and 128 test JPEGs, its RN50x4 .pt and
    a GPT-2-sized byte vocab (scripts/torch_make_zoo_dryrun_fixtures.py),
    gates off (MIN_CIDER=-1 MIN_B4=-1). It must print PARITY OK and write
    128 predictions and float CIDEr and Bleu_4;
    its python processes (each counting through LAUNCH_SITECUSTOMIZE)
    launch K1-K4 and the epilogues only."""
    ins = arts["ins"]
    site = f"{tmp}/zoo_site"
    os.makedirs(site)
    kernels = launch_sites()
    with open(f"{site}/sitecustomize.py", "w") as f:
        f.write(LAUNCH_SITECUSTOMIZE.format(kernels=kernels))
    repo_module("scripts/torch_make_zoo_dryrun_fixtures.py").byte_vocab(
        f"{tmp}/zoo_gpt2_vocab", MAIN["V"])
    out, counts = f"{tmp}/zoo_out", f"{tmp}/zoo_launches.jsonl"
    env = {k: v for k, v in os.environ.items()
           if k not in ("DEVICE", "EXTRA_PREDICT_FLAGS")}
    env.update(PYTHONPATH=os.pathsep.join(
                   [site, *filter(None, [os.environ.get("PYTHONPATH")])]),
               ZOO_CKPT=arts["rn_ckpt"], KARPATHY_JSON=ins["karpathy"],
               COCO_IMAGES=os.path.dirname(ins["images"]),
               CLIP_CKPT=ins["ckpts"]["RN50x4"],
               GPT2_DIR=f"{tmp}/zoo_gpt2_vocab",
               CAPDEC_DATA_ROOT=f"{tmp}/zoo_data", OUT=out,
               MIN_CIDER="-1", MIN_B4="-1", CAPDEC_SMOKE_LAUNCHES=counts)
    t0 = time.perf_counter()
    res = subprocess.run(["bash", str(ROOT / "scripts" / "torch_zoo_parity.sh")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    wall = time.perf_counter() - t0
    require(res.returncode == 0, f"zoo chain exited {res.returncode}:\n"
                                 f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    lines = res.stdout.strip().splitlines()
    require("PARITY OK" in lines, f"zoo chain: {lines[-3:]}")
    with open(f"{out}/zoo_predictions.json") as f:
        preds = json.load(f)
    n = CLIP_RUN["test_images"]
    require(len(preds) == n and
            all(isinstance(p["caption"], str) for p in preds),
            f"zoo chain: {len(preds)} predictions")
    stem = os.path.basename(arts["rn_ckpt"]).split(".")[0]
    with open(f"{out}/{stem}_scores.json") as f:
        scores = json.load(f)
    require(all(isinstance(scores[k], float) for k in ("CIDEr", "Bleu_4")),
            f"zoo chain scores: {scores}")
    launches = {name: 0 for name in kernels}
    with open(counts) as f:
        procs = [json.loads(line) for line in f]
    for proc in procs:
        for name, c in proc.items():
            launches[name] += c
    require_launch_set(launches, BEAM_PATH, "zoo chain")
    return dict(wall_s=wall, processes=len(procs), predictions=len(preds),
                captions_per_s=len(preds) / wall, scores=scores,
                gate_line=next(x for x in lines if x.startswith("zoo parity")),
                launches=launches)


def device_ms_of(fn) -> float:
    """The summed device time of every CUDA kernel fn() launches (one
    profiled call)."""
    cuda = torch.autograd.DeviceType.CUDA
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.events()
               if e.device_type == cuda) / 1e3


def serve512() -> dict:
    """(c) scripts/torch_serve_throughput.py at --n 2048 --batch 512 on the
    flagship's random weights: beam (K1-K4), --int8 (K1, K5-K7) and
    --no_beam (K1). captions/s, p50/p99 latency, the launches by kernel,
    and the busy share: one batch's device time (profiled apart) times
    the batches over the run's wall time."""
    mod = repo_module("scripts/torch_serve_throughput.py")
    runs = {}
    for mode, flags, path in (("beam", [], BEAM_PATH),
                              ("int8", ["--int8"], INT8_PATH),
                              ("no_beam", ["--no_beam"], GREEDY_PATH)):
        args = mod.build_parser().parse_args([
            "--n", str(RECIPES["serve_n"]), "--batch",
            str(RECIPES["serve_batch"]), *flags])
        server, cfg = mod.build_server(args)
        zero_counters()
        out = mod.serve_requests(server, cfg, args)
        launches = launch_set(path, f"serving at batch 512 ({mode})")
        require(out["served"] == args.n and
                out["batches"] == -(-args.n // args.batch),
                f"serving at batch 512 ({mode}): {out}")
        embeds = np.random.RandomState(SEED + 5).randn(
            args.batch, cfg.prefix_size).astype(np.float32)
        dev = device_ms_of(lambda: server.caption(embeds))
        runs[mode] = dict(out, captions_per_s=out["serve_captions_per_sec"],
                          device_ms_per_batch=dev,
                          wall_ms_per_batch=out["wall_s"] / out["batches"]
                          * 1e3,
                          busy_share=dev * out["batches"] /
                          (out["wall_s"] * 1e3), launches=launches)
        del server
        torch.cuda.empty_cache()
    return runs


def serve512_checks(gen) -> dict:
    """At batch 512 (2560 beam rows) in f32: the kernel path's tokens
    equal the plain path's but for rounding ties of the plain path itself
    (token_identity_at_batch) and the int8 path's top-beam
    token share with its plain version is at least 0.98 (int8_agreement),
    on the serving script's weights and first batch of requests,
    entry_length cut to RECIPES["identity_entry_length"]; then K1 at B
    2560, R 5 and B 512, R 1, and K2-K4 at N 512 x R 5 against their
    plain versions, bounds and library calls (the `n512` key)."""
    from capdec_tpu_torch.decode import BeamConfig
    from capdec_tpu_torch.decode.beam import cast_params_for_decode
    from capdec_tpu_torch.models import caption_model
    mod = repo_module("scripts/torch_serve_throughput.py")
    N = RECIPES["serve_batch"]
    cfg = mod.model_config()
    model = caption_model.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(0), device=DEVICE)
    embeds = np.random.RandomState(0).randn(N, cfg.prefix_size).astype(
        np.float32)
    dc = BeamConfig(beam_size=MAIN["R"],
                    entry_length=RECIPES["identity_entry_length"],
                    stop_token=-1)
    dc8 = dataclasses.replace(dc, kv_cache_int8=True, fused_attention=True)
    bf16_gpt = cast_params_for_decode(model.gpt, cfg.gpt2)
    out = dict(token_identity=token_identity_at_batch(
                   model, cfg, dc, bf16_gpt, embeds, MAIN["N"]),
               int8_agreement=int8_agreement(model, cfg, True, dc, dc8,
                                             bf16_gpt, embeds),
               entry_length=dc.entry_length)
    del model, bf16_gpt
    torch.cuda.empty_cache()
    out["n512"] = check_kv_kernels(gen, N, MAIN["D"], MAIN["H"],
                                   "batch 512")
    torch.cuda.empty_cache()
    out["n512"]["lm_head_topk"] = lm_head_times(
        gen, {"beam": (N * MAIN["R"], MAIN["R"]), "greedy_r1": (N, 1)})
    torch.cuda.empty_cache()
    return out


def int8_probe(gen) -> dict:
    """(d) scripts/torch_int8_quality_probe.py at its defaults on the card
    (4 epochs of 512 samples, 64 decoded): the exact beam launches K1-K4,
    the int8 beam K1, K5-K7; each decode stops at '.' before its cap at
    least once. Flips and deltas are reported, with no threshold. Then,
    on the trained model and the eval embeddings, at the probe's shapes
    (V 256, D 128 over 2 heads, a 4-slot prefix, 2 layers): the exact
    beam in f32 through the kernels equals the plain path
    (token_identity), the int8 beam's top-beam token share with its
    plain version is at least 0.98 (int8_agreement), and K1 at B 320,
    R 5 against its plain version (the `probe` key of its row)."""
    from capdec_tpu_torch.decode import BeamConfig
    from capdec_tpu_torch.decode.beam import cast_params_for_decode
    probe = repo_module("scripts/torch_int8_quality_probe.py")
    zero_counters()
    t0 = time.perf_counter()
    out = probe.run(device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_set(PROBE_PATH, "int8 probe")
    require(all(out["stopped"][v] > 0 for v in probe.VARIANTS),
            f"int8 probe: no decode stopped at '.': {out['stopped']}")
    scores = {k: {v: out["scores"][v][k] for v in probe.VARIANTS}
              for k in probe.METRICS}
    model, cfg, embeds = out["model"], out["cfg"], out["embeds"]
    dc, dc8 = (BeamConfig(**probe.BASE, **probe.VARIANTS[v])
               for v in ("exact", "int8"))
    gpt = cast_params_for_decode(model.gpt, cfg.gpt2)
    checks = dict(
        token_identity=token_identity(model, cfg, True, dc, gpt, embeds),
        int8_agreement=int8_agreement(model, cfg, True, dc, dc8, gpt,
                                      embeds))
    kernels = {"lm_head_topk": lm_head_times(
        gen, {"beam": (len(embeds) * dc.beam_size, dc.beam_size)},
        V=cfg.gpt2.vocab_size, D=cfg.gpt2.n_embd)}
    return dict(wall_s=wall, captions_per_s=2 * out["eval_n"] / wall,
                train_loss=out["train_loss"], eval_n=out["eval_n"],
                flips=out["flips"], stopped=out["stopped"], scores=scores,
                deltas=out["deltas"], launches=launches, **checks,
                kernels=kernels)


def recipes_phase(gen, arts: dict, tmp: str) -> dict:
    """The recipes phase, (a)-(d), after the clip phase on its
    artifacts."""
    out = {}
    for part, run in (("demo", lambda: demo_run(gen, arts, tmp)),
                      ("zoo", lambda: zoo_chain(arts, tmp)),
                      ("serve512", serve512),
                      ("serve512_checks", lambda: serve512_checks(gen)),
                      ("int8_probe", lambda: int8_probe(gen))):
        t0 = time.perf_counter()
        out[part] = run()
        log(json.dumps({"phase": f"recipes_{part}",
                        "phase_s": time.perf_counter() - t0, **out[part]}))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from capdec_tpu_torch.decode.beam import cast_params_for_decode, \
        resolve_config
    from capdec_tpu_torch.ops import _build
    from capdec_tpu_torch.utils.torch_setup import setup_torch

    setup_torch()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    so = _build.library_path()
    _build.library()
    log(json.dumps({"phase": "build", "library": so.name,
                    "built_now": _build.build_seconds > 0,
                    "build_s": _build.build_seconds,
                    "load_s": time.perf_counter() - t0}))
    log_path = so.with_suffix(".log")
    ptxas = {}
    if log_path.exists():
        for line in log_path.read_text().splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                log("  ptxas:", line.strip())
        ptxas = ptxas_report(log_path.read_text())
    # the K2/K6/K8/K9/K15 kernel's registers and spills, by value type,
    # slot policy and head_dim: 2 value types x 4 policies x 3 head_dims
    async_attn = {async_attn_instance(name): rep
                  for name, rep in ptxas.items() if "async_attn" in name}
    require(not log_path.exists() or len(async_attn) == 24,
            f"ptxas: async_attn reported {sorted(async_attn)} in "
            f"{log_path.name}")
    for t, rep in async_attn.items():
        require(rep.get("spill_stores") == 0 and rep.get("spill_loads") == 0,
                f"async_attn<{t}> spills: {rep}")

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    kernels = [check_lm_head(gen, ptxas), check_decode_attention(gen),
               *check_cache_kernels(gen, ptxas),
               check_quantising_write(gen, ptxas),
               check_int8_attention(gen), check_whole_row_fork(gen),
               check_chunked_attention(gen),
               check_chunked_int8_attention(gen),
               check_seqmajor_write(gen, ptxas),
               *check_gathers(gen), check_single_slot_write(gen),
               check_v1_attention(gen), *check_epilogues(gen, ptxas)]
    for k in kernels:
        if k["source"].endswith("decode_attention_async.cu"):
            # K6's instances (its in-register policy) apart from the others'
            k6 = k["name"] == "beam_decode_attention_rowmajor_q"
            k["ptxas"] = {t: rep for t, rep in async_attn.items()
                          if t.endswith(" inreg") == k6}
        log(json.dumps({"phase": "kernel_check", **k}))
    k2 = next(k for k in kernels
              if k["name"] == "beam_decode_attention_rowmajor")
    k2["k10"] = check_short_prefix_attention(gen)
    log(json.dumps({"phase": "short_prefix", **k2["k10"]}))
    mla_rows, k1_d2048, latent, mla_served = check_mla_moe(gen, ptxas)
    for k in kernels:
        if k["name"] == "lm_head_topk":
            k["d2048"] = k1_d2048
        if k["name"] in latent:
            k["latent"] = latent[k["name"]]
    for k in mla_rows:
        log(json.dumps({"phase": "kernel_check", **k}))
    kernels += mla_rows
    log(json.dumps({"phase": "mla_moe_path", **mla_served,
                    "k1_d2048": k1_d2048, "latent": latent}))

    # the weights have a generator of their own, so the checks above do
    # not change them (scripts/torch_serve_profile.py builds the same)
    embeds = np.random.RandomState(SEED).randn(
        MAIN["requests"], MAIN["prefix_size"]).astype(np.float32)
    model, configs, served = None, {}, {"mla_moe_path": mla_served}
    for phase, beam, knobs, path in PATHS:
        server, model, cfg, dc = build_server(
            torch.Generator(device=DEVICE).manual_seed(SEED) if model is None
            else None, model=model, beam=beam, **knobs)
        if phase == "v3_int8_path":
            require(resolve_config(dc).int8_prefix,
                    "v3 int8 path: int8_prefix must resolve on")
        server.warmup()
        served[phase] = serve_path(server, embeds, path)
        require(served[phase]["widened_launches"] == 0,
                f"{phase}: the attention at K {MAIN['K']} ran a widened "
                f"plan")
        require(served[phase]["streamed_launches"] == 0,
                f"{phase}: K1 at D {MAIN['D']} took the streamed kernel")
        if phase == "greedy_k13_path":  # K13's path: one launch a step
            n = served[phase]["launches"]
            require(n["write_gen_slot_chunk_seqmajor"] == n["lm_head_topk"],
                    f"path (d): K13 must launch once a step, got {n}")
            served[phase].update(launches_per_step(server, embeds))
        configs[phase] = dc
        log(json.dumps({"phase": phase, **served[phase]}))
        del server
    # beam 33 on the bf16 beam path: K2 in three row groups of 16
    server, _, _, dc = build_server(None, model=model, beam_size=WIDE_R)
    require(resolve_config(dc).fused_attention,
            "beam 33 must take the fused attention route")
    server.warmup()
    served["beam33_path"] = serve_path(server, embeds[:MAIN["N"]], BEAM_PATH)
    configs["beam33_path"] = dc
    del server
    k2 = next(k for k in kernels
              if k["name"] == "beam_decode_attention_rowmajor")
    k2["r33"] = wide_attention_times(gen)
    log(json.dumps({"phase": "beam33", **served["beam33_path"],
                    "k2_r33": k2["r33"]}))

    bf16_gpt = cast_params_for_decode(model.gpt, cfg.gpt2)
    few, many = (embeds[:MAIN[k]] for k in ("identity_images", "int8_images"))
    checks = (  # (phase, the check)
        ("token_identity", lambda: token_identity(
            model, cfg, True, configs["main_path"], bf16_gpt, few)),
        ("int8_agreement", lambda: int8_agreement(
            model, cfg, True, configs["main_path"], configs["int8_path"],
            bf16_gpt, many)),
        ("v3_token_identity", lambda: token_identity(
            model, cfg, True, configs["v3_path"], bf16_gpt, few)),
        ("v3_int8_agreement", lambda: int8_agreement(
            model, cfg, True, configs["v3_path"], configs["v3_int8_path"],
            bf16_gpt, many)),
        ("greedy_token_identity", lambda: token_identity(
            model, cfg, False, configs["greedy_path"], bf16_gpt, few)),
        ("greedy_k13_token_identity", lambda: token_identity(
            model, cfg, False, configs["greedy_k13_path"], bf16_gpt, few)),
        ("greedy_int8_agreement", lambda: int8_agreement(
            model, cfg, False, configs["greedy_path"],
            configs["greedy_int8_path"], bf16_gpt, many)),
        ("nonlane_token_identity", lambda: token_identity(
            model, cfg, True, configs["nonlane_path"], bf16_gpt, few,
            same_as=configs["main_path"])),
        *((f"{p}_token_identity", lambda p=p: token_identity(
            model, cfg, True, configs[f"{p}_path"], bf16_gpt, few))
          for p in ("seqmajor", "slot_write", "ancestry", "beam33")))
    for phase, call in checks:
        log(json.dumps({"phase": phase, **call()}))
    del model, bf16_gpt
    torch.cuda.empty_cache()

    from capdec_tpu_torch.data import dataset as data_lib
    from capdec_tpu_torch.utils.tokenizer import ByteTokenizer
    trained = {}
    with tempfile.TemporaryDirectory() as tmp:
        corpus = f"{tmp}/corpus.pkl"
        write_corpus(corpus, np.random.RandomState(SEED))
        ds = data_lib.load_caption_dataset(
            corpus, MAIN["K"], ByteTokenizer(), normalize_prefix=True,
            max_seq_len_override=TRAIN["T"])
        for phase, only_prefix in (("train_j", True), ("train_k", False)):
            trained[phase], sd = train_mode(only_prefix, ds,
                                            f"{tmp}/{phase}", embeds)
            log(json.dumps({"phase": phase, **trained[phase]}))
        log(json.dumps({"phase": "train_card_vs_cpu",
                        **card_cpu_step(sd, ds)}))
        del sd
        torch.cuda.empty_cache()
        mapped = {}
        for mapping_type in NEW_MAPPERS:
            mapped[mapping_type] = mapper_mode(
                mapping_type, ds, f"{tmp}/{mapping_type}", embeds)
            served[f"{mapping_type}_path"] = dict(
                launches=mapped[mapping_type]["launches"],
                captions_per_s=mapped[mapping_type]["serve_captions_per_s"])
            log(json.dumps({"phase": "mappers", **mapped[mapping_type]}))
        predicted = predict_runs(f"{tmp}/train_j/timed/smoke-000.pt", embeds,
                                 tmp)
        for name, run in predicted.items():
            served[f"predict_{name}"] = run
            log(json.dumps({"phase": "predict", "run": name, **run}))
        meshed = mesh_phase(gen, ds, f"{tmp}/train_j/timed/smoke-000.pt",
                            embeds, tmp)
        for name, runs in meshed["predict"].items():
            for tag, run in runs.items():
                served[f"mesh_predict_{name}_{tag}"] = run
        for tag, run in meshed["serve"].items():
            served[f"mesh_serve_{tag}"] = run
        for k in kernels:
            if k["name"] in meshed["tp2"]:
                k["tp2"] = meshed["tp2"][k["name"]]
        log(json.dumps({"phase": "mesh", "card": torch.cuda.get_device_name(0),
                        "nvidia_smi": smi, **meshed}))
        torch.cuda.empty_cache()
        log(json.dumps({"phase": "lifecycle",
                        "card": torch.cuda.get_device_name(0),
                        "nvidia_smi": smi, **lifecycle_phase(
                            f"{tmp}/train_j/timed/smoke-000.pt", corpus,
                            embeds, tmp)}))
        log(json.dumps({"phase": "cache_api",
                        "card": torch.cuda.get_device_name(0),
                        "nvidia_smi": smi, **cache_api_phase()}))
        clipped, artifacts = clip_phase(tmp)
        for name, run in clipped["predict"].items():
            served[f"clip_predict_{name}"] = run
        log(json.dumps({"phase": "clip", "card": torch.cuda.get_device_name(0),
                        "nvidia_smi": smi, **clipped}))
        recipes = recipes_phase(gen, artifacts, tmp)
        demo = recipes["demo"]
        for tag, wall in (("beam", demo["beam_s"]),
                          ("greedy", demo["greedy_s"]),
                          ("predict", demo["predict_wall_s"])):
            served[f"recipes_demo_{tag}"] = dict(
                launches=demo["launches"][tag], captions_per_s=1 / wall)
        served["recipes_zoo"] = recipes["zoo"]
        for mode, run in recipes["serve512"].items():
            served[f"serve512_{mode}"] = run
        served["int8_probe"] = recipes["int8_probe"]
        for key, times in (("demo", demo["kernels"]),
                           ("n512", recipes["serve512_checks"]["n512"]),
                           ("probe", recipes["int8_probe"]["kernels"])):
            for k in kernels:
                if k["name"] in times:
                    k[key] = times[k["name"]]
        log(json.dumps({"phase": "recipes",
                        "card": torch.cuda.get_device_name(0),
                        "nvidia_smi": smi}))
    for k in kernels:
        k["launches_by_path"] = {
            phase: run["launches"][k["name"]]
            for phase, run in served.items()
            if run["launches"].get(k["name"], 0)}
        k["launches"] = sum(k["launches_by_path"].values())

    name = torch.cuda.get_device_name(0)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "cublas_ms", "max_abs_err_f32", "launches_by_path", "bf16_prefix",
            "greedy_r1", "rotated_ms", "library_rotated_ms", "floor_ms",
            "tensor_form_ms", "steps", "r33", "k10", "tp2", "demo", "n512",
            "probe", "warm_ms", "host_us", "plain_host_us", "b5", "ulp_share",
            "ulp_share_f32", "ptxas", "d2048", "latent", "shape")
    log(json.dumps({"card": name, "nvidia_smi": smi,
                    **{f"{phase}_captions_per_s": run["captions_per_s"]
                       for phase, run in served.items()},
                    **{f"{phase}_{k}": run[k] for phase, run in trained.items()
                       for k in ("samples_per_s", "ms_per_step", "mfu")},
                    "smoke_s": time.perf_counter() - t0}))
    for line in smi:
        log(line)
    log(json.dumps({"kernels": [{k: kern[k] for k in keys if k in kern}
                                for kern in kernels]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

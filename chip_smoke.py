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
     assumes (K5's and K13's four instances each must build without
     spills); K13 is checked and timed from the per-layer views of qkv
     buffers, as decode_step hands them over (and checked from [L, B, D]
     tensors), beside the empty kernel on its grid, the floor of one
     launch, and the library route (torch.stack, then index_copy_); K2, K6, K8,
     K9 and K15 (one kernel, decode_attention_async.cu, whose 24
     instances must build without spills) and their SDPA yardstick at
     steps 1, 33 and 66, on one layer and rotated over the layers or
     cache sets (SDPA over key sets); K9 at R = 5 with both prefix kinds
     and at R = 1 with the int8 prefix.
  3. The served paths: a CaptionServer on full-width weights made from a
     seed (GPT-2 124M + the 8-layer TransformerMapper, prefix 640 -> 40,
     bf16, batch 64, entry_length 67) serves 128 requests on each path;
     the kernels' launch counters are zeroed just before each and read
     just after, and each path must have launched its kernels and no
     other: beam 5 (K1-K4); int8 KV (K1, K5-K7); (a) slot-bounded beam,
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
     files (K1-K4 and no other kernel, 128 captions), whose captions must
     equal predict's from the pickle embeddings_generator writes in image
     mode on the same images. ViT-B/32: image mode, and predict
     --text_autoencoder on its text tower (a 512-wide checkpoint trained
     the same way). Each tower's f32 output on a batch of 4, card against
     CPU, within 1e-4 relative L2; RN50x4's activations after each stage
     finite; images/s and captions/s of each CLI call and of each tower
     beside the card's name and power limit.
  6. A JSON line of the kernels, then {"ok": true, "device": ...} last.
Without a CUDA device it exits 1 and prints no result.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import re
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
                         scales=None, write=None) -> dict:
    """An attention kernel's bf16 times at each of ATTN_STEPS beside
    SDPA's and the bound. `call(step, layer)` runs the kernel. `ms`
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
    for step in ATTN_STEPS:
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
    """'lm_head_wgmma<128>', 'lm_head_merge', 'lm_head_pass1<bf16>', ...
    for a mangled kernel name of csrc/lm_head.cu."""
    m = re.search(r"\d(lm_head_[a-z0-9]+)(ILi(\d+)E|I13__nv_bfloat16E|IfE)?",
                  mangled)
    arg = {None: "", "I13__nv_bfloat16E": "<bf16>", "IfE": "<f32>"}.get(
        m.group(2), f"<{m.group(3)}>")
    return m.group(1) + arg


def check_lm_head(gen, ptxas):
    """K1 at both served shapes: the beam paths' B = 320 rows, R = 5 and
    greedy's B = 64, R = 1 (under "greedy_r1"), each with its own bound;
    beside the kernel, the cuBLAS product alone (`torch.matmul` of h and
    w^T in bf16, the logits written) as a yardstick of the product's rate
    (no one PyTorch call computes K1: `library_ms` is null)."""
    from capdec_tpu_torch.ops import _build, lm_head
    V, D = MAIN["V"], MAIN["D"]
    # Operands on a coarse grid (h in quarters, w in eighths, |.| <= 1):
    # every partial sum is exact in f32, so any summation order gives the
    # same logits and the top-R indices (with their many exact ties) must
    # match the plain version's exactly.
    w = torch.randint(-4, 5, (V, D), generator=gen, device=DEVICE) / 8
    shapes = {"beam": (MAIN["N"] * MAIN["R"], MAIN["R"]),
              "greedy_r1": (MAIN["N"], 1)}
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
            bound_ms=b_ms, bound_by=b_by,
            cublas_ms=time_ms(lambda: torch.matmul(hd, wd.t())),
            plan=lm_head.lm_head_plan(B, V, D, R, 2,
                                      _build.sm_count(hd.device)),
            shape=f"B={B} V={V} D={D} R={R} bf16")
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
                library_ms=None, greedy_r1=out["greedy_r1"], ptxas=k1)


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


def check_cache_kernels(gen):
    from capdec_tpu_torch.ops import cache_reorder as cr
    N, R, L, E, D = (MAIN[k] for k in ("N", "R", "L", "E", "D"))
    B = N * R
    cpu_gen = torch.Generator().manual_seed(SEED)
    src = _lane_src(cpu_gen, N, R).to(DEVICE)
    forked = src != torch.arange(B, device=DEVICE)
    step, count = 30 % E, MAIN["entry_length"] - 1
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        rand = lambda *s: torch.randn(*s, generator=gen,
                                      device=DEVICE).to(dtype)
        k0, v0 = rand(B, L, E, D), rand(B, L, E, D)
        nk, nv = rand(B, L, D), rand(B, L, D)
        # K3: bit-exact slot write
        a = cr.write_gen_slot_chunk(k0.clone(), v0.clone(), nk, nv, step)
        b = cr.write_gen_slot_chunk_plain(k0.clone(), v0.clone(), nk, nv,
                                          step)
        torch.cuda.synchronize()
        require(torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"]),
                f"K3 {dtype}: slot write differs from the plain version")
        # K4: bit-exact fork copy; unforked rows and slots >= count untouched
        a = cr.copy_forked_rows_bounded(k0.clone(), v0.clone(), src, count)
        b = cr.copy_forked_rows_bounded_plain(k0.clone(), v0.clone(), src,
                                              count)
        torch.cuda.synchronize()
        require(torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"]),
                f"K4 {dtype}: fork copy differs from the plain version")
        require(torch.equal(a["k"][~forked], k0[~forked]) and
                torch.equal(a["k"][:, :, count:], k0[:, :, count:]),
                f"K4 {dtype}: touched rows or slots outside its contract")
        out[dtype] = (k0, v0, nk, nv)
    k0, v0, _, _ = out[torch.bfloat16]
    # timed over rotating new K/V sets and slots (no pass fits in L2)
    k3 = dict(
        name="write_gen_slot_chunk", route="cuda",
        source="capdec_tpu_torch/csrc/cache_reorder.cu",
        replaces="capdec_tpu/ops/cache_reorder.py:355",
        max_abs_err=0.0, max_abs_err_f32=0.0,
        **slot_write_times(gen, cr.write_gen_slot_chunk,
                           cr.write_gen_slot_chunk_plain, k0, v0, (B, L, D)),
        shape=f"B={B} L={L} E={E} D={D} bf16, inputs rotated over "
              f">{L2_FLUSH_BYTES >> 20} MiB and the {E} slots")
    # each source row is read once, each forked row written once
    forks = int(forked.sum())
    sources = int(src[forked].unique().numel())
    b4, by4 = bound_ms(2 * (sources + forks) * L * count * D * 2, 0,
                       torch.bfloat16)
    k4 = dict(
        name="copy_forked_rows_bounded", route="cuda",
        source="capdec_tpu_torch/csrc/cache_reorder.cu",
        replaces="capdec_tpu/ops/cache_reorder.py:210",
        max_abs_err=0.0, max_abs_err_f32=0.0,
        ms=time_ms(lambda: cr.copy_forked_rows_bounded(k0, v0, src, count)),
        plain_ms=time_ms(
            lambda: cr.copy_forked_rows_bounded_plain(k0, v0, src, count)),
        bound_ms=b4, bound_by=by4, library_ms=None,
        shape=f"B={B} forks={forks} sources={sources} L={L} count={count} "
              f"D={D} bf16")
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
    regs = {quant_write_instance(name): rep for name, rep in ptxas.items()
            if "write_gen_slot_q" in name}
    require(not ptxas or len(regs) == 4, f"ptxas: K5 reported {regs}")
    for t, rep in regs.items():
        require(rep.get("spill_stores") == 0 and rep.get("spill_loads") == 0,
                f"{t} spills: {rep}")
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


def seq_write_instance(mangled: str) -> str:
    """'write_gen_slot_seqmajor<4>' (16-byte words a lane) for K13's
    mangled kernel name."""
    m = re.search(r"write_gen_slot_seqmajorILi(\d+)E", mangled)
    return f"write_gen_slot_seqmajor<{m.group(1)}>"


def qkv_view_sets(gen, L, N, D, dtype=torch.bfloat16, n=None):
    """K13's inputs as decode_step hands them over: (new_k, new_v), the
    per-layer k and v thirds of a [L, N, 3D] buffer of qkv rows, for n
    buffers (default: as many as one pass of K/V reads past
    L2_FLUSH_BYTES, for a rotation)."""
    n = n or -(-L2_FLUSH_BYTES // (2 * L * N * D * 2))
    sets = []
    for _ in range(n):
        qkv = torch.randn(L, N, 3 * D, generator=gen, device=DEVICE).to(dtype)
        sets.append(([t[:, D:2 * D] for t in qkv],
                     [t[:, 2 * D:] for t in qkv]))
    return sets


def seqmajor_write_call(fn, k, v, sets, stack=False):
    """A call of a seq-major slot write `fn(k, v, new_k, new_v, step)`:
    call i reads qkv set i of a rotation and writes slot i mod E; with
    `stack` the per-layer views are first stacked into [L, N, D] (the
    route of decode_step before K13 took views)."""
    n, E = len(sets), k.shape[2]

    def call(i):
        nk, nv = sets[i % n]
        if stack:
            nk, nv = torch.stack(nk), torch.stack(nv)
        fn(k, v, nk, nv, i % E)
    return rotating(call, n * E)


def stack_index_copy(E):
    """The library route of K13 from views over E slots: torch.stack of
    each side, then `index_copy_` into slot `step` of k and v."""
    idx = [torch.tensor([s], device=DEVICE) for s in range(E)]

    def call(k, v, nk, nv, step):
        k.index_copy_(2, idx[step], torch.stack(nk).unsqueeze(2))
        v.index_copy_(2, idx[step], torch.stack(nv).unsqueeze(2))
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
    regs = {seq_write_instance(name): rep for name, rep in ptxas.items()
            if "write_gen_slot_seqmajor" in name}
    require(not ptxas or len(regs) == 4, f"ptxas: K13 reported {regs}")
    for t, rep in regs.items():
        require(rep.get("spill_stores") == 0 and rep.get("spill_loads") == 0,
                f"{t} spills: {rep}")
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
    plan = cr.seqmajor_write_plan(L, N, D, 2, _build.sm_count(
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
        ms=time_ms(seqmajor_write_call(cr.write_gen_slot_chunk_seqmajor, k,
                                       v, sets)),
        plain_ms=time_ms(seqmajor_write_call(
            cr.write_gen_slot_chunk_seqmajor_plain, k, v, sets)),
        library_ms=time_ms(seqmajor_write_call(stack_index_copy(E), k, v,
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
    shapes in bf16 and f32, at steps 0, odd, even and E-1; every other
    slot untouched."""
    from capdec_tpu_torch.ops import cache_reorder as cr
    N, R, L, E, D = (MAIN[k] for k in ("N", "R", "L", "E", "D"))
    B = N * R
    for dtype in (torch.bfloat16, torch.float32):
        rand = lambda *s: torch.randn(*s, generator=gen,
                                      device=DEVICE).to(dtype)
        k0, v0 = rand(B, L, E, D), rand(B, L, E, D)
        nk, nv = rand(B, L, D), rand(B, L, D)
        for step in (0, 7, 8, E - 1):
            a = cr.write_gen_slot(k0.clone(), v0.clone(), nk, nv, step)
            b = cr.write_gen_slot_plain(k0.clone(), v0.clone(), nk, nv, step)
            torch.cuda.synchronize()
            require(torch.equal(a["k"], b["k"]) and
                    torch.equal(a["v"], b["v"]),
                    f"K14 {dtype} step {step}: slot write differs from the "
                    "plain version")
            other = torch.arange(E, device=DEVICE) != step
            require(torch.equal(a["k"][:, :, other], k0[:, :, other]),
                    f"K14 {dtype} step {step}: touched another slot")
        if dtype == torch.bfloat16:
            k, v = k0, v0
    n = n_kv_sets((B, L, D))
    return dict(
        name="write_gen_slot", route="cuda",
        source="capdec_tpu_torch/csrc/cache_reorder.cu",
        replaces="capdec_tpu/ops/cache_reorder.py:452",
        max_abs_err=0.0, max_abs_err_f32=0.0,
        **slot_write_times(gen, cr.write_gen_slot, cr.write_gen_slot_plain,
                           k, v, (B, L, D)),
        shape=f"B={B} L={L} E={E} D={D} bf16 (K3's kernel), inputs rotated "
              f"over {n} sets and the {E} slots")


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
                 tokenizer=None, **knobs):
    """The main path's server: BeamConfig(**knobs), or with beam=False
    greedy/top-p decoding with ToppConfig(**knobs). `model` reuses weights
    made before (of config `cfg`, default the main path's). Returns
    (server, model, cfg, the decode config)."""
    from capdec_tpu_torch import serve
    from capdec_tpu_torch.models import caption_model
    from capdec_tpu_torch.utils.tokenizer import ByteTokenizer
    cfg = cfg or model_config()
    if model is None:
        model = caption_model.init_params(cfg, gen, device=DEVICE)
    E = MAIN["entry_length"]
    if beam:
        dc = serve.BeamConfig(beam_size=beam_size, entry_length=E, **knobs)
        sc = serve.ServeConfig(batch_size=MAIN["N"], beam_config=dc)
    else:
        dc = serve.ToppConfig(entry_length=E, **knobs)
        sc = serve.ServeConfig(batch_size=MAIN["N"], beam=False,
                               topp_config=dc)
    server = serve.CaptionServer(model, cfg, tokenizer or ByteTokenizer(),
                                 sc, device=DEVICE)
    return server, model, cfg, dc


def counters():
    from capdec_tpu_torch.ops import cache_reorder, decode_attention, lm_head
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
            "beam_decode_attention": decode_attention.beam_decode_attention}


# The served paths: (phase, beam search?, decode knobs, the kernels the
# path must launch; the others must not launch).
CHUNKED = dict(fused_slot_chunks=8)
PATHS = (
    ("main_path", True, {},
     ("lm_head_topk", "beam_decode_attention_rowmajor",
      "write_gen_slot_chunk", "copy_forked_rows_bounded")),
    ("int8_path", True, dict(kv_cache_int8=True),
     ("lm_head_topk", "write_gen_slot_chunk_q",
      "beam_decode_attention_rowmajor_q", "copy_forked_rows")),
    # (a) slot-bounded beam: staged growth, bounded fork copies
    ("v3_path", True, CHUNKED,
     ("lm_head_topk", "beam_decode_attention_chunked",
      "write_gen_slot_chunk", "copy_forked_rows_bounded")),
    # (b) slot-bounded int8 beam; int8_prefix resolves on
    ("v3_int8_path", True, dict(kv_cache_int8=True, **CHUNKED),
     ("lm_head_topk", "beam_decode_attention_chunked_q",
      "write_gen_slot_chunk_q", "copy_forked_rows_bounded")),
    # (c) greedy, the default ToppConfig (--no_beam)
    ("greedy_path", False, {}, ("lm_head_topk",)),
    # (d) greedy with the seq-major kernel slot write
    ("greedy_k13_path", False, dict(chunk_slot_write=True),
     ("lm_head_topk", "write_gen_slot_chunk_seqmajor")),
    # (e) greedy's fused chunked int8 route, int8 prefix
    ("greedy_int8_path", False,
     dict(fused_attention=True, kv_cache_int8=True, **CHUNKED),
     ("lm_head_topk", "beam_decode_attention_chunked_q",
      "write_gen_slot_chunk_q")),
    # (f) non-lane beam: one full-size cache gathered after each selection
    ("nonlane_path", True, dict(lane_beams=False),
     ("lm_head_topk", "beam_decode_attention_rowmajor",
      "write_gen_slot_chunk", "reorder_rows_leading")),
    # (g) seq-major lane beam, staged growth: plain attention and slot
    # write, the whole cache gathered by the lanes' sources each step
    ("seqmajor_path", True, dict(rowmajor_cache=False),
     ("lm_head_topk", "reorder_cache_rows")),
    # (h) the lane path with the slot write K14 in place of K3
    ("slot_write_path", True,
     dict(chunk_slot_write=False, pallas_slot_write=True),
     ("lm_head_topk", "beam_decode_attention_rowmajor", "write_gen_slot",
      "copy_forked_rows_bounded")),
    # (i) ancestry attention: the cache never moves
    ("ancestry_path", True, dict(ancestry=True),
     ("lm_head_topk", "write_gen_slot_chunk")),
)


def zero_counters() -> None:
    for fn in counters().values():
        fn.launches = 0


def launch_set(path, what: str) -> dict:
    """The launch counts since zero_counters(): every kernel of `path`
    launched, no other."""
    launches = {name: fn.launches for name, fn in counters().items()}
    for name, n in launches.items():
        if name in path:
            require(n > 0, f"{what}: kernel {name} was never launched")
        else:
            require(n == 0, f"{what}: kernel {name} is not on this path but "
                            f"launched {n} times")
    return launches


def serve_path(server, embeds, path):
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
                batches=server.stats["batches"], launches=launches)


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
BEAM_PATH = PATHS[0][3]  # K1-K4
INT8_PATH = PATHS[1][3]  # K1, K5-K7


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
                ("greedy", ["--no_beam"], ("lm_head_topk",)))


def predict_runs(ckpt: str, embeds, tmp: str) -> dict:
    """`capdec_tpu_torch.cli.predict.main` on the card from `ckpt` with
    --infer_model_config, --embeddings_pickle (MAIN["requests"] records)
    and --score_gt at batch 64: beam, --int8_kv and --no_beam, each with
    its launch set and a caption per record (captions/s over the whole
    CLI call: loading, config inference and scoring included). The beam
    run's first 64 captions must equal, lowercased, what CaptionServer
    gives the same 64 embeddings at batch 64: one engine on one batch."""
    import os
    import pickle
    from capdec_tpu_torch.cli import predict
    from capdec_tpu_torch.models import caption_model
    from capdec_tpu_torch.utils import checkpoint
    from capdec_tpu_torch.utils.tokenizer import load_tokenizer
    n = MAIN["requests"]
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
    runs = {}
    old_root = os.environ.get("CAPDEC_DATA_ROOT")
    os.environ["CAPDEC_DATA_ROOT"] = root
    try:
        for name, flags, path in PREDICT_RUNS:
            out = f"{tmp}/predict_{name}.json"
            zero_counters()
            t0 = time.perf_counter()
            results = predict.main([
                "--checkpoint", ckpt, "--infer_model_config",
                "--embeddings_pickle", pkl, "--score_gt", gt,
                "--batch_size", str(MAIN["N"]), "--out", out,
                "--dataset_mode", "0", *flags])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_set(path, f"predict {name}")
            with open(out) as f:
                written = json.load(f)
            require(written == results and
                    [r["image_id"] for r in written] == list(range(n)),
                    f"predict {name}: {len(written)} captions written")
            name_of = os.path.basename(ckpt).split(".")[0]
            with open(f"{tmp}/{name_of}_scores.json") as f:
                scores = json.load(f)
            runs[name] = dict(captions=len(written), wall_s=wall,
                              captions_per_s=len(written) / wall,
                              launches=launches,
                              scores={k: scores[k] for k in (
                                  "Bleu_4", "METEOR", "ROUGE_L", "CIDEr")})
    finally:
        if old_root is None:
            os.environ.pop("CAPDEC_DATA_ROOT", None)
        else:
            os.environ["CAPDEC_DATA_ROOT"] = old_root
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
    import os
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


def clip_phase(tmp: str) -> dict:
    """The Quickstart chain on the card from caption text and image files
    to scored captions, at full width: parse_corpus karpathy;
    embeddings_generator text mode with RN50x4 and gender balancing; the
    train CLI (one epoch of --only_prefix, 10 steps); predict
    --clip_checkpoint --infer_model_config --score_gt at batch 64, beam 5,
    on the 128 test images (K1-K4 and no other kernel, 128 captions); the
    same from a pickle embeddings_generator wrote in image mode (the same
    captions). Then ViT-B/32: embeddings_generator image mode, a 512-wide
    checkpoint trained the same way, and predict --text_autoencoder on
    ViT-B/32's text tower. Every tower card against CPU in f32."""
    import os
    import pickle
    from capdec_tpu_torch.cli import embeddings_generator, parse_corpus
    from capdec_tpu_torch.cli import predict, train
    ins = clip_inputs(tmp, np.random.RandomState(SEED + 2))
    root, ann = ins["root"], f"{ins['root']}/coco/annotations"
    old = {k: os.environ.get(k) for k in ("CAPDEC_DATA_ROOT",
                                          "CAPDEC_CLIP_BPE_PATH")}
    os.environ.update(CAPDEC_DATA_ROOT=root, CAPDEC_CLIP_BPE_PATH=ins["bpe"])
    steps, runs = {}, {}
    try:
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
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    torch.cuda.empty_cache()
    return dict(steps=steps, predict=runs, towers=towers)


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
               *check_cache_kernels(gen), check_quantising_write(gen, ptxas),
               check_int8_attention(gen), check_whole_row_fork(gen),
               check_chunked_attention(gen),
               check_chunked_int8_attention(gen),
               check_seqmajor_write(gen, ptxas),
               *check_gathers(gen), check_single_slot_write(gen),
               check_v1_attention(gen)]
    for k in kernels:
        if k["source"].endswith("decode_attention_async.cu"):
            # K6's instances (its in-register policy) apart from the others'
            k6 = k["name"] == "beam_decode_attention_rowmajor_q"
            k["ptxas"] = {t: rep for t, rep in async_attn.items()
                          if t.endswith(" inreg") == k6}
        log(json.dumps({"phase": "kernel_check", **k}))

    # the weights have a generator of their own, so the checks above do
    # not change them (scripts/torch_serve_profile.py builds the same)
    embeds = np.random.RandomState(SEED).randn(
        MAIN["requests"], MAIN["prefix_size"]).astype(np.float32)
    model, configs, served = None, {}, {}
    for phase, beam, knobs, path in PATHS:
        server, model, cfg, dc = build_server(
            torch.Generator(device=DEVICE).manual_seed(SEED) if model is None
            else None, model=model, beam=beam, **knobs)
        if phase == "v3_int8_path":
            require(resolve_config(dc).int8_prefix,
                    "v3 int8 path: int8_prefix must resolve on")
        server.warmup()
        served[phase] = serve_path(server, embeds, path)
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
        clipped = clip_phase(tmp)
        for name, run in clipped["predict"].items():
            served[f"clip_predict_{name}"] = run
        log(json.dumps({"phase": "clip", "card": torch.cuda.get_device_name(0),
                        "nvidia_smi": smi, **clipped}))
    for k in kernels:
        k["launches_by_path"] = {
            phase: run["launches"][k["name"]]
            for phase, run in served.items() if run["launches"][k["name"]]}
        k["launches"] = sum(k["launches_by_path"].values())

    name = torch.cuda.get_device_name(0)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "cublas_ms", "max_abs_err_f32", "launches_by_path", "bf16_prefix",
            "greedy_r1", "rotated_ms", "library_rotated_ms", "floor_ms",
            "tensor_form_ms", "steps", "r33", "ptxas", "shape")
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

#!/usr/bin/env python3
"""On-card smoke run of the capdec_tpu_torch port (one NVIDIA GPU, sm_90a).

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. The card's name and power limit (nvidia-smi) and the build of the
     hand-written kernels from capdec_tpu_torch/csrc.
  2. Each kernel against its plain PyTorch version on the card, at the
     main path's shapes, in bf16 and f32 (K5-K7 also over int8 caches);
     the kernel's time beside the plain version's, one PyTorch library
     call's where one computes the same function, and the bound (the
     least time the card could take).
  3. The main path: a CaptionServer on full-width weights made from a
     seed (GPT-2 124M + the 8-layer TransformerMapper, prefix 640 -> 40,
     bf16, beam 5, entry_length 67) serves 128 requests. The kernels'
     launch counters are zeroed just before and read just after; every
     kernel of the path (K1-K4) must have launched, and no other.
  3b. The int8-KV path: the same weights served with
     BeamConfig(kv_cache_int8=True) (staged cache growth), 128 requests;
     K1, K5, K6 and K7 must have launched, and K2-K4 not.
  4. Token identity: 8 images decoded in f32 through the kernels and
     through the plain versions, both on the card, give identical tokens.
     The share of tokens the bf16 path shares with f32 is reported.
  4b. A batch of 64 images through the int8 path in f32, kernels against
     plain: the top-beam token share must be >= 0.98 (a level that rounds
     the other way may move a near-tie; exact identity is reported). A
     whole batch, since one early divergence in 8 images moves the share
     by up to 12%. The share the int8 path shares with the bf16 path is
     reported.
  5. A JSON line of the kernels, then {"ok": true, "device": ...} last.
Without a CUDA device it exits 1 and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
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


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_lm_head(gen):
    from capdec_tpu_torch.ops import lm_head
    B, V, D, R = MAIN["N"] * MAIN["R"], MAIN["V"], MAIN["D"], MAIN["R"]
    # Operands on a coarse grid (h in quarters, w in eighths, |.| <= 1):
    # every partial sum is exact in f32, so any summation order gives the
    # same logits and the top-R indices (with their many exact ties) must
    # match the plain version's exactly.
    h = torch.randint(-4, 5, (B, D), generator=gen, device=DEVICE) / 4
    w = torch.randint(-4, 5, (V, D), generator=gen, device=DEVICE) / 8
    res = {}
    for dtype, tol in ((torch.bfloat16, 2e-3), (torch.float32, 1e-4)):
        hd, wd = h.to(dtype), w.to(dtype)
        kv, ki, kl = lm_head.lm_head_topk(hd, wd, R)
        pv, pi, pl = lm_head.lm_head_topk_plain(hd, wd, R)
        torch.cuda.synchronize()
        require(torch.equal(ki, pi), f"K1 {dtype}: top-R indices differ")
        err = max(max_err(kv, pv), max_err(kl, pl))
        require(err <= tol, f"K1 {dtype}: max abs err {err} > {tol}")
        res[dtype] = (err, hd, wd)
    # all ties: the lowest indices win, in order
    ties = lm_head.lm_head_topk(torch.zeros(B, D, device=DEVICE,
                                            dtype=torch.bfloat16),
                                torch.ones(V, D, device=DEVICE,
                                           dtype=torch.bfloat16), R)[1]
    require(torch.equal(ties.cpu(), torch.arange(R).expand(B, R)),
            "K1: all-ties case must return indices 0..R-1")
    err, hd, wd = res[torch.bfloat16]
    b_ms, b_by = bound_ms((V * D + B * D) * 2 + B * R * 12 + B * 4,
                          2.0 * B * D * V, torch.bfloat16)
    return dict(
        name="lm_head_topk", route="cuda",
        source="capdec_tpu_torch/csrc/lm_head.cu",
        replaces="capdec_tpu/ops/lm_head.py:259",
        max_abs_err=err, max_abs_err_f32=res[torch.float32][0],
        ms=time_ms(lambda: lm_head.lm_head_topk(hd, wd, R)),
        plain_ms=time_ms(lambda: lm_head.lm_head_topk_plain(hd, wd, R)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"B={B} V={V} D={D} R={R} bf16")


def check_decode_attention(gen):
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
    # time the longest read: the last step under the last stage bound
    q, kn, vn, pk, pv, gk, gv = timed
    step = MAIN["entry_length"] - 1
    args = (q, kn, vn, pk, pv, gk, gv, step, layer)
    kw = dict(beams_per_image=R, head_dim=hd, e_cap=E)
    # library yardstick: SDPA over the same keys, pre-concatenated per beam
    heads = lambda t, s: t.reshape(B, s, H, hd).transpose(1, 2)
    keys = torch.cat([pk[layer].repeat_interleave(R, 0),
                      gk[:, layer, :step], kn[:, None]], 1)
    vals = torch.cat([pv[layer].repeat_interleave(R, 0),
                      gv[:, layer, :step], vn[:, None]], 1)
    S = K + step + 1
    sq, sk, sv = heads(q.contiguous(), 1), heads(keys, S), heads(vals, S)
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        sq, sk, sv))
    nbytes = (3 * B * D + 2 * N * K * D + 2 * B * step * D) * 2 + B * D * 4
    b_ms, b_by = bound_ms(nbytes, 4.0 * B * D * S, torch.bfloat16)
    return dict(
        name="beam_decode_attention_rowmajor", route="cuda",
        source="capdec_tpu_torch/csrc/decode_attention.cu",
        replaces="capdec_tpu/ops/decode_attention.py:719",
        max_abs_err=errs[torch.bfloat16],
        max_abs_err_f32=errs[torch.float32],
        ms=time_ms(lambda: da.beam_decode_attention_rowmajor(*args, **kw)),
        plain_ms=time_ms(
            lambda: da.beam_decode_attention_rowmajor_plain(*args, **kw)),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib,
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
    k0, v0, nk, nv = out[torch.bfloat16]
    idx = torch.tensor([step], device=DEVICE)
    b3, by3 = bound_ms(4 * B * L * D * 2, 0, torch.bfloat16)
    k3 = dict(
        name="write_gen_slot_chunk", route="cuda",
        source="capdec_tpu_torch/csrc/cache_reorder.cu",
        replaces="capdec_tpu/ops/cache_reorder.py:355",
        max_abs_err=0.0, max_abs_err_f32=0.0,
        ms=time_ms(lambda: cr.write_gen_slot_chunk(k0, v0, nk, nv, step)),
        plain_ms=time_ms(
            lambda: cr.write_gen_slot_chunk_plain(k0, v0, nk, nv, step)),
        bound_ms=b3, bound_by=by3,
        library_ms=time_ms(lambda: (k0.index_copy_(2, idx, nk[:, :, None]),
                                    v0.index_copy_(2, idx, nv[:, :, None]))),
        shape=f"B={B} L={L} E={E} D={D} bf16")
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


def check_quantising_write(gen):
    """K5: levels and scales bit-identical to the plain version; every
    other slot untouched."""
    from capdec_tpu_torch.ops import cache_reorder as cr
    N, R, L, E, D = (MAIN[k] for k in ("N", "R", "L", "E", "D"))
    B = N * R
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
        if dtype == torch.bfloat16:
            timed = (nk, nv)
    nk, nv = timed
    step = MAIN["entry_length"] - 1
    k, v, ks, vs = k0.clone(), v0.clone(), ks0.clone(), vs0.clone()
    # new K/V in (bf16), levels and scales out; ~6 f32 operations a value
    b_ms, b_by = bound_ms(2 * B * L * D * 2 + 2 * B * L * (D + 4),
                          6.0 * 2 * B * L * D, torch.float32)
    return dict(
        name="write_gen_slot_chunk_q", route="cuda",
        source="capdec_tpu_torch/csrc/cache_reorder.cu",
        replaces="capdec_tpu/ops/cache_reorder.py:413",
        max_abs_err=0.0, max_abs_err_f32=0.0,
        ms=time_ms(lambda: cr.write_gen_slot_chunk_q(k, v, ks, vs, nk, nv,
                                                     step)),
        plain_ms=time_ms(lambda: cr.write_gen_slot_chunk_q_plain(
            k, v, ks, vs, nk, nv, step)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        library_note="null: no one PyTorch call quantises and writes a slot",
        shape=f"B={B} L={L} E={E} D={D} step={step} bf16 -> int8")


def check_int8_attention(gen):
    """K6 against its plain version over random int8 levels, with NaN
    scales at the slots it must not read."""
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
        for step in (1, 17, MAIN["entry_length"] - 1):
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
    q, kn, vn, pk, pv, gks, gvs = timed
    step = MAIN["entry_length"] - 1
    args = (q, kn, vn, pk, pv, gk, gv, gks, gvs, step, layer)
    kw = dict(beams_per_image=R, head_dim=hd, e_cap=E)
    # library yardstick: SDPA over keys and values dequantised and
    # concatenated beforehand, as for K2
    heads = lambda t, s: t.reshape(B, s, H, hd).transpose(1, 2)
    deq = lambda g, sc: (g[:, layer, :step].float()
                         * sc[:, layer, 0, :step, None]).to(q.dtype)
    keys = torch.cat([pk[layer].repeat_interleave(R, 0), deq(gk, gks),
                      kn[:, None]], 1)
    vals = torch.cat([pv[layer].repeat_interleave(R, 0), deq(gv, gvs),
                      vn[:, None]], 1)
    S = K + step + 1
    sq, sk, sv = heads(q.contiguous(), 1), heads(keys, S), heads(vals, S)
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        sq, sk, sv))
    nbytes = ((3 * B * D + 2 * N * K * D) * 2 + 2 * B * step * D
              + 2 * B * step * 4 + B * D * 4)
    b_ms, b_by = bound_ms(nbytes, 4.0 * B * D * S, torch.bfloat16)
    return dict(
        name="beam_decode_attention_rowmajor_q", route="cuda",
        source="capdec_tpu_torch/csrc/decode_attention.cu",
        replaces="capdec_tpu/ops/decode_attention.py:646",
        max_abs_err=errs[torch.bfloat16],
        max_abs_err_f32=errs[torch.float32],
        ms=time_ms(lambda: da.beam_decode_attention_rowmajor_q(*args, **kw)),
        plain_ms=time_ms(
            lambda: da.beam_decode_attention_rowmajor_q_plain(*args, **kw)),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib,
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


# ---------------------------------------------------------------------------
# Phases 3 and 4: the main path
# ---------------------------------------------------------------------------


def build_server(gen, kv_cache_int8=False, model=None):
    """The main path's server; `model` reuses weights made before."""
    from capdec_tpu_torch import serve
    from capdec_tpu_torch.models import caption_model, gpt2
    from capdec_tpu_torch.utils.tokenizer import ByteTokenizer
    cfg = caption_model.CaptionModelConfig(
        prefix_length=MAIN["K"], clip_length=MAIN["K"],
        prefix_size=MAIN["prefix_size"], num_layers=MAIN["mapper_layers"],
        mapping_type="transformer",
        gpt2=gpt2.GPT2Config(vocab_size=MAIN["V"], n_embd=MAIN["D"],
                             n_layer=MAIN["L"], n_head=MAIN["H"],
                             compute_dtype=torch.bfloat16))
    if model is None:
        model = caption_model.init_params(cfg, gen, device=DEVICE)
    bc = serve.BeamConfig(beam_size=MAIN["R"],
                          entry_length=MAIN["entry_length"],
                          kv_cache_int8=kv_cache_int8)
    server = serve.CaptionServer(model, cfg, ByteTokenizer(),
                                 serve.ServeConfig(batch_size=MAIN["N"],
                                                   beam_config=bc),
                                 device=DEVICE)
    return server, model, cfg, bc


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
            "copy_forked_rows": cache_reorder.copy_forked_rows}


# The kernels each served path must launch; the others must not launch.
BF16_PATH = ("lm_head_topk", "beam_decode_attention_rowmajor",
             "write_gen_slot_chunk", "copy_forked_rows_bounded")
INT8_PATH = ("lm_head_topk", "write_gen_slot_chunk_q",
             "beam_decode_attention_rowmajor_q", "copy_forked_rows")


def serve_main_path(server, embeds, path):
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    got = dict(server.serve((i, embeds[i]) for i in range(len(embeds))))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters().items()}
    require(sorted(got) == list(range(len(embeds))) and
            all(isinstance(t, str) for t in got.values()),
            "main path: every request must get one caption")
    for name, n in launches.items():
        if name in path:
            require(n > 0, f"main path: kernel {name} was never launched")
        else:
            require(n == 0, f"main path: kernel {name} is not on this "
                            f"path but launched {n} times")
    pct = server.latency_percentiles()
    return dict(served=len(got), wall_s=wall,
                captions_per_s=len(got) / wall, latency_p50_s=pct["p50"],
                latency_p95_s=pct["p95"], latency_p99_s=pct["p99"],
                batches=server.stats["batches"], launches=launches)


def top_beam_share(a, b) -> float:
    """Share of top-beam token positions (up to the longer of the two
    lengths) at which two beam_search results agree."""
    from capdec_tpu_torch.decode import beam_top_select
    ta, la = beam_top_select(a[0], a[1], a[3])
    tb, lb = beam_top_select(b[0], b[1], b[3])
    span = torch.maximum(la, lb).long()
    pos = torch.arange(ta.shape[1], device=ta.device)[None]
    mask = pos < span[:, None]
    return float(((ta == tb) & mask).sum() / mask.sum())


def mapped_prefix(model, cfg, embeds):
    from capdec_tpu_torch.models import caption_model
    x = embeds / np.maximum(np.linalg.norm(embeds, axis=-1, keepdims=True),
                            1e-12)
    return caption_model.map_prefix(
        model, cfg, torch.from_numpy(x.astype(np.float32)).to(DEVICE))


def token_identity(model, cfg, bc, bf16_gpt, embeds):
    from capdec_tpu_torch.decode import beam_search
    prefix = mapped_prefix(model, cfg, embeds)
    cfg32 = dataclasses.replace(cfg.gpt2, compute_dtype=torch.float32)
    kern = beam_search(model.gpt, cfg32, prefix, bc)
    plain = beam_search(model.gpt, cfg32, prefix, bc.plain())
    torch.cuda.synchronize()
    for what, a, b in zip(("tokens", "lengths", "order"),
                          (kern[0], kern[1], kern[3]),
                          (plain[0], plain[1], plain[3])):
        require(torch.equal(a, b), f"f32 token identity: {what} differ "
                                   "between the kernels and the plain path")
    score_err = max_err(kern[2], plain[2])
    require(score_err <= 1e-4, f"f32 scores differ by {score_err}")
    bf16 = beam_search(bf16_gpt, cfg.gpt2, prefix, bc)
    return dict(images=len(embeds), f32_identical=True,
                f32_score_max_abs_err=score_err,
                bf16_f32_top_beam_token_share=top_beam_share(kern, bf16))


def int8_agreement(model, cfg, bc, bc8, bf16_gpt, embeds):
    """The int8 path in f32, kernels against plain (share >= 0.98), and
    the int8 path's top beams against the bf16 path's (reported)."""
    from capdec_tpu_torch.decode import beam_search
    prefix = mapped_prefix(model, cfg, embeds)
    cfg32 = dataclasses.replace(cfg.gpt2, compute_dtype=torch.float32)
    kern = beam_search(model.gpt, cfg32, prefix, bc8)
    plain = beam_search(model.gpt, cfg32, prefix, bc8.plain())
    torch.cuda.synchronize()
    require(bool(torch.isfinite(kern[2]).all()),
            "int8 f32: non-finite scores")
    share = top_beam_share(kern, plain)
    require(share >= 0.98, f"int8 f32 kernels vs plain: top-beam token "
                           f"share {share} < 0.98")
    identical = all(torch.equal(a, b) for a, b in
                    zip((kern[0], kern[1], kern[3]),
                        (plain[0], plain[1], plain[3])))
    i8 = beam_search(bf16_gpt, cfg.gpt2, prefix, bc8)
    fp = beam_search(bf16_gpt, cfg.gpt2, prefix, bc)
    return dict(images=len(embeds), int8_f32_top_beam_token_share=share,
                int8_f32_identical=identical,
                int8_f32_score_max_abs_err=max_err(kern[2], plain[2]),
                int8_bf16_vs_bf16_top_beam_token_share=top_beam_share(i8,
                                                                      fp))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
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
    if log_path.exists():
        for line in log_path.read_text().splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                log("  ptxas:", line.strip())

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    kernels = [check_lm_head(gen), check_decode_attention(gen),
               *check_cache_kernels(gen), check_quantising_write(gen),
               check_int8_attention(gen), check_whole_row_fork(gen)]
    for k in kernels:
        log(json.dumps({"phase": "kernel_check", **k}))

    # the weights have a generator of their own, so the checks above do
    # not change them (scripts/torch_serve_profile.py builds the same)
    server, model, cfg, bc = build_server(
        torch.Generator(device=DEVICE).manual_seed(SEED))
    server.warmup()
    embeds = np.random.RandomState(SEED).randn(
        MAIN["requests"], MAIN["prefix_size"]).astype(np.float32)
    main_path = serve_main_path(server, embeds, BF16_PATH)
    log(json.dumps({"phase": "main_path", **main_path}))
    server8, _, _, bc8 = build_server(None, kv_cache_int8=True, model=model)
    server8.warmup()
    int8_path = serve_main_path(server8, embeds, INT8_PATH)
    log(json.dumps({"phase": "int8_path", **int8_path}))
    for k in kernels:
        path = main_path if k["name"] in BF16_PATH else int8_path
        k["launches"] = path["launches"][k["name"]]

    from capdec_tpu_torch.decode.beam import cast_params_for_decode
    bf16_gpt = cast_params_for_decode(model.gpt, cfg.gpt2)
    ident = token_identity(model, cfg, bc, bf16_gpt,
                           embeds[:MAIN["identity_images"]])
    log(json.dumps({"phase": "token_identity", **ident}))
    agree = int8_agreement(model, cfg, bc, bc8, bf16_gpt,
                           embeds[:MAIN["int8_images"]])
    log(json.dumps({"phase": "int8_agreement", **agree}))

    name = torch.cuda.get_device_name(0)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err_f32", "shape")
    log(json.dumps({"card": name, "nvidia_smi": smi,
                    "captions_per_s": main_path["captions_per_s"],
                    "int8_captions_per_s": int8_path["captions_per_s"],
                    "smoke_s": time.perf_counter() - t0}))
    for line in smi:
        log(line)
    log(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                for kern in kernels]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

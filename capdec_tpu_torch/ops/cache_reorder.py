"""K3, K4, K5 and K7: in-place updates of the row-major generated KV cache
(port of capdec_tpu/ops/cache_reorder.py::write_gen_slot_chunk,
::copy_forked_rows_bounded, ::write_gen_slot_chunk_q and
::copy_forked_rows); K13, the slot write of the seq-major cache
[L, B, E, D] (::write_gen_slot_chunk_seqmajor); and the int8
quantisation they share (`absmax_int8_quant`).

All update `k`/`v` [B, L, E, D] (K13: [L, B, E, D]; and the int8 cache's
scales) IN PLACE (the JAX versions alias their buffers) and return them
in a dict. On CUDA tensors the wrappers launch csrc/cache_reorder.cu (its
note says what bounds each on the H100 and how the design answers); on
CPU tensors they run the plain PyTorch versions beside them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from . import _build

# cache dtypes of the byte-moving kernels (K3, K4, K7)
MOVABLE_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def _check_cache(k, v, name):
    if k.shape != v.shape or k.dtype != v.dtype or k.device != v.device \
            or k.dim() != 4:
        raise ValueError(f"{name}: k and v must be [B, L, E, D] alike")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: caches must be contiguous")
    row_bytes = k.shape[3] * k.element_size()
    if row_bytes % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel moves 16-byte words "
                         "(D * itemsize % 16 == 0, aligned caches)")
    if k.dtype not in MOVABLE_DTYPES:
        raise TypeError(f"{name}: caches of {MOVABLE_DTYPES}, got {k.dtype}")
    return row_bytes


def _check_src(src, k):
    if src.shape != (k.shape[0],) or src.dtype != torch.int64 or \
            src.device != k.device or not src.is_contiguous():
        raise ValueError("src must be a contiguous int64 [B] on the "
                         "cache's device")


# 1/127 rounded to float32. The JAX reference quantises inside jitted
# code, where XLA turns `amax / 127.0` (a division by a constant) into a
# multiply by this reciprocal; the port does the same, bit for bit.
INV_127 = float(np.float32(1.0) / np.float32(127.0))


def absmax_int8_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax int8 quantisation over the last axis: (levels int8,
    scales f32 with a keepdims last axis); value = level * scale. The
    scale is amax * INV_127 (1 where amax == 0), the level
    clip(round_half_even(x / scale), -127, 127) with an IEEE division."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    s = torch.where(amax > 0, amax * INV_127, 1.0)
    q = torch.clamp(torch.round(x32 / s), -127, 127).to(torch.int8)
    return q, s


def write_gen_slot_chunk_plain(k: torch.Tensor, v: torch.Tensor,
                               new_k: torch.Tensor, new_v: torch.Tensor,
                               step: int) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version: cache[:, :, step] = new (in place)."""
    k[:, :, step] = new_k
    v[:, :, step] = new_v
    return {"k": k, "v": v}


def write_gen_slot_chunk(k: torch.Tensor, v: torch.Tensor,
                         new_k: torch.Tensor, new_v: torch.Tensor,
                         step: int) -> Dict[str, torch.Tensor]:
    """Write the step's K/V new_k/new_v [B, L, D] into slot `step` of the
    row-major caches k/v [B, L, E, D], in place."""
    if _build.on_cpu(k):
        return write_gen_slot_chunk_plain(k, v, new_k, new_v, step)
    row_bytes = _check_cache(k, v, "write_gen_slot_chunk")
    B, L, E, D = k.shape
    for n in (new_k, new_v):
        if n.shape != (B, L, D) or n.dtype != k.dtype or \
                n.device != k.device or not n.is_contiguous() or \
                n.data_ptr() % 16:
            raise ValueError("new_k/new_v must be contiguous [B, L, D] of "
                             "the cache's dtype")
    if not 0 <= step < E:
        raise ValueError(f"step {step} out of range for E={E}")
    lib = _build.library()
    _build.check(lib.capdec_write_gen_slot(
        k.data_ptr(), v.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
        B, L, E, step, row_bytes, _build.stream(k.device)),
        "write_gen_slot_chunk")
    write_gen_slot_chunk.launches += 1
    return {"k": k, "v": v}


write_gen_slot_chunk.launches = 0


# K13's plain version: the slot axis is 2 in both layouts.
write_gen_slot_chunk_seqmajor_plain = write_gen_slot_chunk_plain


def write_gen_slot_chunk_seqmajor(k: torch.Tensor, v: torch.Tensor,
                                  new_k: torch.Tensor, new_v: torch.Tensor,
                                  step: int) -> Dict[str, torch.Tensor]:
    """`write_gen_slot_chunk` for the seq-major caches k/v [L, B, E, D] of
    greedy/top-p decode: new_k/new_v [L, B, D] go to slot `step`, in
    place."""
    if _build.on_cpu(k):
        return write_gen_slot_chunk_seqmajor_plain(k, v, new_k, new_v, step)
    row_bytes = _check_cache(k, v, "write_gen_slot_chunk_seqmajor")
    L, B, E, D = k.shape
    for n in (new_k, new_v):
        if n.shape != (L, B, D) or n.dtype != k.dtype or \
                n.device != k.device or not n.is_contiguous() or \
                n.data_ptr() % 16:
            raise ValueError("new_k/new_v must be contiguous [L, B, D] of "
                             "the cache's dtype")
    if not 0 <= step < E:
        raise ValueError(f"step {step} out of range for E={E}")
    lib = _build.library()
    _build.check(lib.capdec_write_gen_slot_seqmajor(
        k.data_ptr(), v.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
        L, B, E, step, row_bytes, _build.stream(k.device)),
        "write_gen_slot_chunk_seqmajor")
    write_gen_slot_chunk_seqmajor.launches += 1
    return {"k": k, "v": v}


write_gen_slot_chunk_seqmajor.launches = 0


def write_gen_slot_chunk_q_plain(k: torch.Tensor, v: torch.Tensor,
                                 ks: torch.Tensor, vs: torch.Tensor,
                                 new_k: torch.Tensor, new_v: torch.Tensor,
                                 step: int) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version: quantise new_k/new_v over D and write the
    levels into slot `step` and the scales into ks/vs[:, :, 0, step]."""
    for cache, scales, new in ((k, ks, new_k), (v, vs, new_v)):
        level, s = absmax_int8_quant(new)
        cache[:, :, step] = level
        scales[:, :, 0, step] = s[..., 0]
    return {"k": k, "v": v, "ks": ks, "vs": vs}


def write_gen_slot_chunk_q(k: torch.Tensor, v: torch.Tensor,
                           ks: torch.Tensor, vs: torch.Tensor,
                           new_k: torch.Tensor, new_v: torch.Tensor,
                           step: int) -> Dict[str, torch.Tensor]:
    """`write_gen_slot_chunk` for the int8 generated cache: absmax-int8
    quantises the step's new_k/new_v [B, L, D] (float32 or bfloat16) per
    (row, layer) and writes the levels into slot `step` of k/v int8
    [B, L, E, D] and the f32 scales into ks/vs [B, L, 1, E], in place.
    Bit-identical to the plain version."""
    if _build.on_cpu(k):
        return write_gen_slot_chunk_q_plain(k, v, ks, vs, new_k, new_v,
                                            step)
    _check_cache(k, v, "write_gen_slot_chunk_q")
    B, L, E, D = k.shape
    if k.dtype != torch.int8:
        raise TypeError("write_gen_slot_chunk_q writes int8 caches")
    for s in (ks, vs):
        if s.shape != (B, L, 1, E) or s.dtype != torch.float32 or \
                s.device != k.device or not s.is_contiguous():
            raise ValueError("ks/vs must be contiguous f32 [B, L, 1, E]")
    for n in (new_k, new_v):
        if n.shape != (B, L, D) or n.dtype != new_k.dtype or \
                n.device != k.device or not n.is_contiguous() or \
                n.data_ptr() % 16:
            raise ValueError("new_k/new_v must be contiguous, aligned "
                             "[B, L, D] of one dtype")
    if D % 16 or D > 2048:
        raise ValueError(f"the kernel takes D % 16 == 0 and D <= 2048, "
                         f"got {D}")
    if not 0 <= step < E:
        raise ValueError(f"step {step} out of range for E={E}")
    lib = _build.library()
    _build.check(lib.capdec_write_gen_slot_q(
        k.data_ptr(), v.data_ptr(), ks.data_ptr(), vs.data_ptr(),
        new_k.data_ptr(), new_v.data_ptr(), B, L, E, D, step,
        _build.dtype_code(new_k), _build.stream(k.device)),
        "write_gen_slot_chunk_q")
    write_gen_slot_chunk_q.launches += 1
    return {"k": k, "v": v, "ks": ks, "vs": vs}


write_gen_slot_chunk_q.launches = 0


def copy_forked_rows_bounded_plain(k: torch.Tensor, v: torch.Tensor,
                                   src: torch.Tensor, count: int
                                   ) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version: rows b with src[b] != b take row src[b]'s
    slots < count (in place; the gather copies before it writes)."""
    rows = torch.nonzero(src != torch.arange(src.shape[0],
                                             device=src.device)).flatten()
    if rows.numel() and count > 0:
        k[rows, :, :count] = k[src[rows], :, :count]
        v[rows, :, :count] = v[src[rows], :, :count]
    return {"k": k, "v": v}


def copy_forked_rows_bounded(k: torch.Tensor, v: torch.Tensor,
                             src: torch.Tensor, count: int
                             ) -> Dict[str, torch.Tensor]:
    """In-place fork copy for lane-assigned beam search: row b of k/v
    [B, L, E, D] takes row src[b]'s slots < count, only where
    src[b] != b. Requires the lane invariant (a row that is written is
    never a source). Slots >= count of a forked row keep stale bits; decode
    attention never reads them."""
    if _build.on_cpu(k):
        return copy_forked_rows_bounded_plain(k, v, src, count)
    row_bytes = _check_cache(k, v, "copy_forked_rows_bounded")
    B, L, E, D = k.shape
    _check_src(src, k)
    if not 0 <= count <= E:
        raise ValueError(f"count {count} out of range for E={E}")
    lib = _build.library()
    _build.check(lib.capdec_copy_forked_rows_bounded(
        k.data_ptr(), v.data_ptr(), src.data_ptr(), B, L, E, count,
        row_bytes, _build.stream(k.device)), "copy_forked_rows_bounded")
    copy_forked_rows_bounded.launches += 1
    return {"k": k, "v": v}


copy_forked_rows_bounded.launches = 0


def copy_forked_rows_plain(k: torch.Tensor, v: torch.Tensor,
                           src: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version: rows b with src[b] != b take row src[b]
    whole (in place)."""
    return copy_forked_rows_bounded_plain(k, v, src, k.shape[2])


def copy_forked_rows(k: torch.Tensor, v: torch.Tensor, src: torch.Tensor
                     ) -> Dict[str, torch.Tensor]:
    """In-place whole-row fork copy (staged cache growth): row b of k/v
    [B, ...] becomes row src[b], only where src[b] != b; rows that keep
    their lane move no byte. Requires the lane invariant. Any dtype of
    `MOVABLE_DTYPES`."""
    if _build.on_cpu(k):
        return copy_forked_rows_plain(k, v, src)
    row_bytes = _check_cache(k, v, "copy_forked_rows")
    _check_src(src, k)
    B, L, E, _ = k.shape
    lib = _build.library()
    _build.check(lib.capdec_copy_forked_rows(
        k.data_ptr(), v.data_ptr(), src.data_ptr(), B, L * E * row_bytes,
        _build.stream(k.device)), "copy_forked_rows")
    copy_forked_rows.launches += 1
    return {"k": k, "v": v}


copy_forked_rows.launches = 0

"""K3 and K4: in-place updates of the row-major generated KV cache
(port of capdec_tpu/ops/cache_reorder.py::write_gen_slot_chunk and
::copy_forked_rows_bounded).

Both update `k`/`v` [B, L, E, D] IN PLACE (the JAX versions alias their
buffers) and return them as {"k", "v"}. On CUDA tensors the wrappers
launch csrc/cache_reorder.cu (its note says what bounds each on the H100
and how the design answers); on CPU tensors they run the plain PyTorch
versions beside them.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import _build


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
    _build.dtype_code(k)
    return row_bytes


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
    if src.shape != (B,) or src.dtype != torch.int64 or \
            src.device != k.device or not src.is_contiguous():
        raise ValueError("src must be a contiguous int64 [B] on the "
                         "cache's device")
    if not 0 <= count <= E:
        raise ValueError(f"count {count} out of range for E={E}")
    lib = _build.library()
    _build.check(lib.capdec_copy_forked_rows_bounded(
        k.data_ptr(), v.data_ptr(), src.data_ptr(), B, L, E, count,
        row_bytes, _build.stream(k.device)), "copy_forked_rows_bounded")
    copy_forked_rows_bounded.launches += 1
    return {"k": k, "v": v}


copy_forked_rows_bounded.launches = 0

"""The generated KV cache's byte movers (port of
capdec_tpu/ops/cache_reorder.py):
  * in place, as the JAX versions alias their buffers: K3
    `write_gen_slot_chunk` and K14 `write_gen_slot` (one slot of the
    row-major cache [B, L, E, D]), K4 `copy_forked_rows_bounded`, K5
    `write_gen_slot_chunk_q` (int8, with `absmax_int8_quant`), K7
    `copy_forked_rows`, and K13 `write_gen_slot_chunk_seqmajor` (the
    seq-major cache [L, B, E, D], from per-layer views of the step's
    K/V);
  * out of place, into output caches that must not overlap the input: the
    row gathers K10 `reorder_rows_leading` (row-major), K11
    `reorder_cache_rows` and K12 `reorder_cache_rows_bounded` (seq-major,
    K12 over the slots below `count`). Their `src` values must lie in
    [0, B): the plain versions raise on the CPU (`index_select`), and the
    kernel trips a device-side assert (as `index_select` does on the card;
    a host check would wait for the device at every step).
Each returns the caches in a dict. On CUDA tensors the wrappers launch
csrc/cache_reorder.cu or csrc/cache_gather.cu (their notes say what bounds
each on the H100 and how the design answers); on CPU tensors they run the
plain PyTorch versions beside them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from . import _build

# cache dtypes of the byte-moving kernels (K3, K4, K7, K10-K14)
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


def _check_src(src, k, axis=0):
    if src.shape != (k.shape[axis],) or src.dtype != torch.int64 or \
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


def _check_slot_write(k, v, new_k, new_v, step, name):
    """Validate a byte-moving slot write (K3, K14) on CUDA tensors:
    new_k/new_v are [k.shape[0], k.shape[1], D] of the cache's dtype.
    Returns the bytes of one slot row."""
    row_bytes = _check_cache(k, v, name)
    A, C, E, D = k.shape
    for n in (new_k, new_v):
        if n.shape != (A, C, D) or n.dtype != k.dtype or \
                n.device != k.device or not n.is_contiguous() or \
                n.data_ptr() % 16:
            raise ValueError(f"{name}: new_k/new_v must be contiguous "
                             f"{[A, C, D]} of the cache's dtype")
    if not 0 <= step < E:
        raise ValueError(f"{name}: step {step} out of range for E={E}")
    return row_bytes


def _write_slot_rowmajor(k, v, new_k, new_v, step, name):
    """Launch K3's kernel (the C entry of K3 and K14) on CUDA tensors."""
    row_bytes = _check_slot_write(k, v, new_k, new_v, step, name)
    B, L, E, D = k.shape
    lib = _build.library()
    _build.check(lib.capdec_write_gen_slot(
        k.data_ptr(), v.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
        B, L, E, step, row_bytes, _build.stream(k.device)), name)
    return {"k": k, "v": v}


def write_gen_slot_chunk(k: torch.Tensor, v: torch.Tensor,
                         new_k: torch.Tensor, new_v: torch.Tensor,
                         step: int) -> Dict[str, torch.Tensor]:
    """Write the step's K/V new_k/new_v [B, L, D] into slot `step` of the
    row-major caches k/v [B, L, E, D], in place."""
    if _build.on_cpu(k):
        return write_gen_slot_chunk_plain(k, v, new_k, new_v, step)
    out = _write_slot_rowmajor(k, v, new_k, new_v, step,
                               "write_gen_slot_chunk")
    write_gen_slot_chunk.launches += 1
    return out


write_gen_slot_chunk.launches = 0


def _stacked(new):
    """new_k/new_v of K13 as [L, B, D]: a tensor as it is, a sequence of
    L [B, D] tensors stacked."""
    return new if torch.is_tensor(new) else torch.stack(list(new))


def write_gen_slot_chunk_seqmajor_plain(k: torch.Tensor, v: torch.Tensor,
                                        new_k, new_v, step: int
                                        ) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version: slot `step` of k/v [L, B, E, D] takes
    new_k/new_v, each [L, B, D] or a sequence of L [B, D] (stacked first),
    in place."""
    return write_gen_slot_chunk_plain(k, v, _stacked(new_k), _stacked(new_v),
                                      step)


# The launch plan of K13 (csrc/cache_reorder.cu write_gen_slot_seqmajor):
# one warp a (layer, row, K|V) item, a lane holding `words` of the row's
# 16-byte words (the least of SEQ_WORDS with 32 words >= the row's words;
# a longer row goes in passes), in blocks of SEQ_WARPS warps, or of fewer
# where SEQ_WARPS would leave SMs without a block.
SEQ_WARPS = 4
SEQ_WORDS = (1, 2, 4, 8)


def seqmajor_write_plan(L: int, B: int, D: int, itemsize: int,
                        sms: int) -> dict:
    """K13's launch for L layers of B rows of D values of `itemsize`
    bytes on a card of `sms` SMs: `blocks` of `warps` warps (`threads`
    threads), `words` 16-byte words a lane in `passes` passes over a row,
    one warp for each of the 2 L B items. Raises for a shape the kernel
    does not take."""
    row_bytes = D * itemsize
    if row_bytes <= 0 or row_bytes % 16:
        raise ValueError(f"the kernel moves 16-byte words: D * itemsize % "
                         f"16 == 0, got {D} * {itemsize}")
    if not 1 <= L <= _build.SEQ_MAX_LAYERS or B < 1:
        raise ValueError(f"the kernel takes 1 <= L <= "
                         f"{_build.SEQ_MAX_LAYERS} layers and B >= 1 rows, "
                         f"got L={L}, B={B}")
    row16 = row_bytes // 16
    words = next((w for w in SEQ_WORDS if 32 * w >= row16), SEQ_WORDS[-1])
    items = 2 * L * B
    warps = SEQ_WARPS
    while warps > 1 and -(-items // warps) < sms:
        warps //= 2
    return dict(warps=warps, threads=32 * warps, words=words,
                blocks=-(-items // warps), items=items, row16=row16,
                passes=-(-row16 // (32 * words)))


def _layer_views(new, k, v, name):
    """The base pointers and row strides (16-byte words) of the L [B, D]
    views K13 reads for new_k or new_v: a sequence of L tensors, or a
    tensor [L, B, D] read as its rows. Each view has the cache's dtype and
    device, a contiguous last dimension, a 16-byte aligned base, a row
    stride of at least D values and a multiple of 16 bytes (B > 1), and
    does not overlap k or v."""
    L, B, E, D = k.shape
    views = new.unbind(0) if torch.is_tensor(new) else tuple(new)
    if len(views) != L:
        raise ValueError(f"{name}: new_k/new_v must hold {L} layers, got "
                         f"{len(views)}")
    item, dtype, device = k.element_size(), k.dtype, k.device
    shape = torch.Size((B, D))
    k0, v0 = k.data_ptr(), v.data_ptr()  # contiguous caches (_check_cache)
    k1, v1 = k0 + k.numel() * item, v0 + v.numel() * item
    ptrs, rows = [], []
    for t in views:
        if t.shape != shape or t.dtype is not dtype or t.device != device:
            raise ValueError(f"{name}: each layer of new_k/new_v must be "
                             f"{[B, D]} of the cache's dtype and device")
        rs, cs = t.stride()
        p = t.data_ptr()
        if cs != 1 or p % 16 or B > 1 and (rs < D or rs * item % 16 or
                                           rs * item // 16 >= 2 ** 31):
            raise ValueError(f"{name}: a layer's view needs a contiguous "
                             "last dimension, a 16-byte aligned base and a "
                             "row stride of at least D values, a multiple "
                             "of 16 bytes")
        end = p + ((B - 1) * rs + D) * item
        if p < k1 and k0 < end or p < v1 and v0 < end:
            raise ValueError(f"{name}: new_k/new_v must not overlap the "
                             "caches")
        ptrs.append(p)
        rows.append(rs * item // 16 if B > 1 else 0)
    return ptrs, rows


def write_gen_slot_chunk_seqmajor(k: torch.Tensor, v: torch.Tensor,
                                  new_k, new_v, step: int
                                  ) -> Dict[str, torch.Tensor]:
    """`write_gen_slot_chunk` for the seq-major caches k/v [L, B, E, D] of
    greedy/top-p decode: slot `step` takes new_k/new_v, in place. Each of
    new_k/new_v is a sequence of L [B, D] views (decode_step's per-layer
    thirds of its qkv outputs, read where they lie) or a tensor [L, B, D]
    (the JAX signature), read as its L rows; one launch either way."""
    if _build.on_cpu(k):
        return write_gen_slot_chunk_seqmajor_plain(k, v, new_k, new_v, step)
    name = "write_gen_slot_chunk_seqmajor"
    row_bytes = _check_cache(k, v, name)
    L, B, E, D = k.shape
    if L > _build.SEQ_MAX_LAYERS:
        raise ValueError(f"{name}: at most {_build.SEQ_MAX_LAYERS} layers, "
                         f"got {L}")
    if not 0 <= step < E:
        raise ValueError(f"{name}: step {step} out of range for E={E}")
    src = _build.SeqmajorSources()
    src.k[:L], src.k_row16[:L] = _layer_views(new_k, k, v, name)
    src.v[:L], src.v_row16[:L] = _layer_views(new_v, k, v, name)
    plan = seqmajor_write_plan(L, B, D, k.element_size(),
                               _build.sm_count(k.device))
    lib = _build.library()
    _build.check(lib.capdec_write_gen_slot_seqmajor(
        k.data_ptr(), v.data_ptr(), src, L, B, E, step, row_bytes,
        plan["warps"], plan["words"], plan["blocks"],
        _build.stream(k.device)), name)
    write_gen_slot_chunk_seqmajor.launches += 1
    return {"k": k, "v": v}


write_gen_slot_chunk_seqmajor.launches = 0


# K14's plain version: K3's.
write_gen_slot_plain = write_gen_slot_chunk_plain


def write_gen_slot(k: torch.Tensor, v: torch.Tensor, new_k: torch.Tensor,
                   new_v: torch.Tensor, step: int) -> Dict[str, torch.Tensor]:
    """`write_gen_slot_chunk` by the other route of the JAX engine
    (`BeamConfig.pallas_slot_write`): the same one-slot update of the
    row-major caches k/v [B, L, E, D] by new_k/new_v [B, L, D], in place,
    with a launch count of its own."""
    if _build.on_cpu(k):
        return write_gen_slot_plain(k, v, new_k, new_v, step)
    out = _write_slot_rowmajor(k, v, new_k, new_v, step, "write_gen_slot")
    write_gen_slot.launches += 1
    return out


write_gen_slot.launches = 0


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


# The launch plan of K5 (csrc/cache_reorder.cu write_gen_slot_q): blocks
# of QUANT_THREADS threads, each warp taking the (row, layer, K|V) items
# warp, warp + warps, ...; a lane holds `units` 8-value units (4 up to D
# 1024, else 8) in registers. One warp an item, so that the block
# scheduler overlaps one warp's arithmetic with the others' loads (on the
# H100 a grid of at most 8 blocks an SM looping over items was no faster:
# scripts/torch_int8_ablate.py).
QUANT_THREADS = 128
QUANT_MAX_D = 2048


def quant_write_plan(B: int, L: int, D: int) -> dict:
    """K5's launch for new_k/new_v [B, L, D]: `blocks` of `threads`, one
    warp for each of the 2 B L items. Raises for a D the kernel does not
    take."""
    if D % 16 or not 0 < D <= QUANT_MAX_D:
        raise ValueError(f"the kernel takes D % 16 == 0 and D <= "
                         f"{QUANT_MAX_D}, got {D}")
    items = 2 * B * L
    return dict(blocks=-(-items // (QUANT_THREADS // 32)),
                threads=QUANT_THREADS,
                units=4 if D <= QUANT_MAX_D // 2 else 8, items=items)


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
    if not 0 <= step < E:
        raise ValueError(f"step {step} out of range for E={E}")
    code = _build.dtype_code(new_k)
    plan = quant_write_plan(B, L, D)
    lib = _build.library()
    _build.check(lib.capdec_write_gen_slot_q(
        k.data_ptr(), v.data_ptr(), ks.data_ptr(), vs.data_ptr(),
        new_k.data_ptr(), new_v.data_ptr(), B, L, E, D, step,
        plan["blocks"], plan["threads"], code, _build.stream(k.device)),
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


def _span(t: torch.Tensor) -> Tuple[int, int]:
    """The bytes a (strided) tensor reaches: [first, last + 1)."""
    last = sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    return t.data_ptr(), t.data_ptr() + (last + 1) * t.element_size()


def _gather_out(k, v, out_k, out_v, name):
    """The output caches of an out-of-place gather: fresh ones when none
    are given; given ones must be contiguous caches like k/v and overlap
    neither input nor each other (`src` may name one source for several
    rows, so an in-place gather would overwrite a row before it is read)."""
    if out_k is None and out_v is None:
        return torch.empty_like(k), torch.empty_like(v)
    if out_k is None or out_v is None:
        raise ValueError(f"{name}: give both out_k and out_v, or neither")
    for o in (out_k, out_v):
        if o.shape != k.shape or o.dtype != k.dtype or \
                o.device != k.device or not o.is_contiguous():
            raise ValueError(f"{name}: the output caches must be contiguous "
                             "and match k/v")
    for a, b in ((out_k, k), (out_k, v), (out_v, k), (out_v, v),
                 (out_k, out_v)):
        (a0, a1), (b0, b1) = _span(a), _span(b)
        if a0 < b1 and b0 < a1:
            raise ValueError(f"{name}: the output must not overlap the "
                             "input or the other output")
    return out_k, out_v


def reorder_rows_leading_plain(k: torch.Tensor, v: torch.Tensor,
                               src: torch.Tensor, out_k=None, out_v=None
                               ) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version: out row b = row src[b] (index_select on
    axis 0)."""
    out_k, out_v = _gather_out(k, v, out_k, out_v, "reorder_rows_leading")
    torch.index_select(k, 0, src, out=out_k)
    torch.index_select(v, 0, src, out=out_v)
    return {"k": out_k, "v": out_v}


def reorder_rows_leading(k: torch.Tensor, v: torch.Tensor, src: torch.Tensor,
                         out_k=None, out_v=None) -> Dict[str, torch.Tensor]:
    """Gather the rows of the row-major caches k/v [B, L, E, D] by `src`
    [B] int64 into out_k/out_v (fresh caches when not given): out row b is
    row src[b], whole. Any dtype of `MOVABLE_DTYPES`, bit for bit."""
    if _build.on_cpu(k):
        return reorder_rows_leading_plain(k, v, src, out_k, out_v)
    row_bytes = _check_cache(k, v, "reorder_rows_leading")
    _check_src(src, k)
    out_k, out_v = _gather_out(k, v, out_k, out_v, "reorder_rows_leading")
    B, L, E, _ = k.shape
    span = L * E * row_bytes  # a row is one contiguous span
    lib = _build.library()
    _build.check(lib.capdec_gather_rows(
        k.data_ptr(), v.data_ptr(), out_k.data_ptr(), out_v.data_ptr(),
        src.data_ptr(), B, 1, 0, span, span, _build.stream(k.device)),
        "reorder_rows_leading")
    reorder_rows_leading.launches += 1
    return {"k": out_k, "v": out_v}


reorder_rows_leading.launches = 0


def reorder_cache_rows_bounded_plain(k: torch.Tensor, v: torch.Tensor,
                                     src: torch.Tensor, count: int,
                                     out_k=None, out_v=None
                                     ) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version: out[:, b, :count] = in[:, src[b], :count]
    (index_select on axis 1); the output's other slots are left as they
    were."""
    out_k, out_v = _gather_out(k, v, out_k, out_v,
                               "reorder_cache_rows_bounded")
    out_k[:, :, :count] = torch.index_select(k[:, :, :count], 1, src)
    out_v[:, :, :count] = torch.index_select(v[:, :, :count], 1, src)
    return {"k": out_k, "v": out_v}


def reorder_cache_rows_plain(k: torch.Tensor, v: torch.Tensor,
                             src: torch.Tensor, out_k=None, out_v=None
                             ) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version: out[:, b] = in[:, src[b]] (index_select on
    axis 1)."""
    out_k, out_v = _gather_out(k, v, out_k, out_v, "reorder_cache_rows")
    torch.index_select(k, 1, src, out=out_k)
    torch.index_select(v, 1, src, out=out_v)
    return {"k": out_k, "v": out_v}


def _gather_seqmajor(k, v, src, count, out_k, out_v, name):
    """Launch the gather of seq-major rows over the slots below `count`
    (no launch for count 0: nothing moves). Returns (the output caches,
    whether the kernel launched)."""
    row_bytes = _check_cache(k, v, name)
    _check_src(src, k, axis=1)
    out_k, out_v = _gather_out(k, v, out_k, out_v, name)
    L, B, E, _ = k.shape
    if not 0 <= count <= E:
        raise ValueError(f"{name}: count {count} out of range for E={E}")
    if count:
        lib = _build.library()
        _build.check(lib.capdec_gather_rows(
            k.data_ptr(), v.data_ptr(), out_k.data_ptr(), out_v.data_ptr(),
            src.data_ptr(), B, L, 1, E * row_bytes, count * row_bytes,
            _build.stream(k.device)), name)
    return {"k": out_k, "v": out_v}, count > 0


def reorder_cache_rows(k: torch.Tensor, v: torch.Tensor, src: torch.Tensor,
                       out_k=None, out_v=None) -> Dict[str, torch.Tensor]:
    """Gather the rows of the seq-major caches k/v [L, B, E, D] along axis
    1 by `src` [B] int64 into out_k/out_v (fresh caches when not given):
    out[:, b] is in[:, src[b]]. Any dtype of `MOVABLE_DTYPES`, bit for
    bit."""
    if _build.on_cpu(k):
        return reorder_cache_rows_plain(k, v, src, out_k, out_v)
    out, launched = _gather_seqmajor(k, v, src, k.shape[2], out_k, out_v,
                                     "reorder_cache_rows")
    reorder_cache_rows.launches += launched
    return out


reorder_cache_rows.launches = 0


def reorder_cache_rows_bounded(k: torch.Tensor, v: torch.Tensor,
                               src: torch.Tensor, count: int, out_k=None,
                               out_v=None) -> Dict[str, torch.Tensor]:
    """`reorder_cache_rows` over the slots below `count` only (the written
    ones): the output's slots at or above `count` are left as they were,
    uninitialised in fresh caches; decode attention never reads them."""
    if _build.on_cpu(k):
        return reorder_cache_rows_bounded_plain(k, v, src, count, out_k,
                                                out_v)
    out, launched = _gather_seqmajor(k, v, src, count, out_k, out_v,
                                     "reorder_cache_rows_bounded")
    reorder_cache_rows_bounded.launches += launched
    return out


reorder_cache_rows_bounded.launches = 0

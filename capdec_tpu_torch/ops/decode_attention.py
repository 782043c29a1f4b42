"""K2, K6, K8, K9 and K15: fused beam-decode attention over split KV caches
(port of capdec_tpu/ops/decode_attention.py::beam_decode_attention_rowmajor,
::beam_decode_attention_rowmajor_q, ::beam_decode_attention_chunked,
::beam_decode_attention_chunked_q and ::beam_decode_attention).

One decode step of one transformer layer. For beam row b (image
n = b // R) and each head, a softmax over the image's shared prefix
slots, the row's generated slots below `step` (read only up to `e_cap`)
and the current token, then the weighted sum of V: f32 [B, D]. K6 reads
an int8 generated cache with per-(row, layer, slot) f32 scales. K8 and K9
(the slot-bounded "v3" kernels) read the generated cache below `step`
only (the TPU kernels' `chunk` tiles are checked, not used); K9 reads an
int8 generated cache and, optionally, an int8 prefix cache with per-slot
scales. K15 (the v1 kernel, which no path of the JAX package calls)
attends over one layer's caches [B, E, D] and also writes the step's K/V
into slot `step`, in place.

On a CUDA tensor a wrapper launches csrc/decode_attention_async.cu (one
kernel fed by asynchronous copies, launched with the plan of
`attention_plan`; K6 and K9 are its int8 policies, K15 its slot-write
policy); its note says what bounds the kernel on the H100 and how the
design answers. On a CPU tensor it runs its plain version, the un-fused
attention math of the JAX reference's decode_step (gpt2.py:612-664).

Generated slots at or above `step` may hold stale or NaN bits after a
bounded fork copy: the kernel never reads them, and the plain version
masks their scores and zeroes their value products through `where`
(0 * NaN would be NaN).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from . import _build
from .cache_reorder import _span

NEG_INF = -1e9


def _attention_plain(q, k_new, v_new, pk, pv, gk, gv, step, layer, R, hd,
                     e_cap, gks=None, gvs=None, pks=None, pvs=None,
                     anc_rows=None):
    """The un-fused attention math of the JAX reference's decode_step
    (gpt2.py:612-664): products in the input dtype, reductions and softmax
    in f32. With gks/gvs (an int8 generated cache's scales [B, L, 1, E])
    each generated score takes its slot's K scale and each generated
    probability its slot's V scale (gpt2.py:629-646); pks/pvs (an int8
    prefix cache's scales [L, N, 1, K]) do the same for the prefix slots
    (decode_attention.py:373-392). With `anc_rows` [B, >= E] int64
    (ancestry attention: the cache never moves) row b reads its slot e
    from cache row anc_rows[b, e]: the JAX reference's one-hot sum over
    source rows (gpt2.py:619-628, 652-660) adds exact zeros only, so the
    gather gives its result bit for bit."""
    B, D = q.shape
    L, N, K, _ = pk.shape
    H = D // hd
    E = gk.shape[2] if e_cap is None else e_cap
    if not 0 < E <= gk.shape[2]:
        raise ValueError(f"e_cap {e_cap} out of range for E={gk.shape[2]}")
    pk_l = pk[layer].to(q.dtype)                   # [N, K, D]
    pv_l = pv[layer].to(q.dtype)
    gk_l = gk[:, layer, :E].to(q.dtype)            # [B, E, D]
    gv_l = gv[:, layer, :E].to(q.dtype)
    if anc_rows is not None:
        idx = anc_rows[:, :E, None].expand(B, E, D)
        gk_l, gv_l = gk_l.gather(0, idx), gv_l.gather(0, idx)
    scale = 1.0 / hd ** 0.5

    def heads(prod):  # [..., D] -> [..., H] per-head sums in f32
        return prod.float().reshape(*prod.shape[:-1], H, hd).sum(-1)

    def spread(p):  # [..., H] -> [..., D]
        return p.to(q.dtype).repeat_interleave(hd, dim=-1)

    valid = (torch.arange(E, device=q.device) < step)[None, :, None]
    sp = heads(q.reshape(N, R, 1, D) * pk_l[:, None])          # [N, R, K, H]
    if pks is not None:
        sp = sp * pks[layer, :, 0][:, None, :, None]
    sg = heads(q[:, None, :] * gk_l)                            # [B, E, H]
    if gks is not None:
        sg = sg * gks[:, layer, 0, :E, None]
    sg = torch.where(valid, sg * scale, NEG_INF)
    sc = heads(q * k_new)[:, None, :]                           # [B, 1, H]
    scores = torch.cat([sp.reshape(B, K, H) * scale, sg, sc * scale], dim=1)
    probs = torch.softmax(scores, dim=1)                        # [B, S, H]
    pp, pg = probs[:, :K], probs[:, K:K + E]
    if pvs is not None:
        pp = pp * pvs[layer, :, 0].repeat_interleave(R, 0)[:, :, None]
    if gvs is not None:
        pg = pg * gvs[:, layer, 0, :E, None]
    out = (spread(pp).reshape(N, R, K, D)
           * pv_l[:, None]).sum(2).reshape(B, D)
    out = out + torch.where(valid, spread(pg) * gv_l, 0.0).sum(1)
    out = out + spread(probs[:, K + E]) * v_new
    return out.float()


def beam_decode_attention_rowmajor_plain(
        q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
        pk: torch.Tensor, pv: torch.Tensor, gk: torch.Tensor,
        gv: torch.Tensor, step: int, layer: int, *, beams_per_image: int,
        head_dim: int, e_cap: Optional[int] = None,
        anc_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K2 (same signature and result). It alone
    takes `anc_rows`, the ancestry table of `_attention_plain`: the JAX
    engine runs ancestry attention only through its un-fused math."""
    return _attention_plain(q, k_new, v_new, pk, pv, gk, gv, step, layer,
                            beams_per_image, head_dim, e_cap,
                            anc_rows=anc_rows)


def _check_args(q, k_new, v_new, pk, pv, gk, gv, step, layer, R, hd,
                e_cap, gen_dtype, prefix_dtype=None):
    """Validate a fused-attention call on CUDA tensors; returns the
    generated-slot read count min(step, e_cap)."""
    B, D = q.shape
    L, N, K, Dp = pk.shape
    Bg, Lg, E, Dg = gk.shape
    prefix_dtype = prefix_dtype or q.dtype
    if any(t.dtype != q.dtype or t.device != q.device
           for t in (k_new, v_new)) or \
            any(t.dtype != prefix_dtype or t.device != q.device
                for t in (pk, pv)) or \
            any(t.dtype != gen_dtype or t.device != q.device
                for t in (gk, gv)):
        raise ValueError("decode attention takes one dtype and device "
                         "(int8 levels where the cache is quantised)")
    if (Dp, Dg, Bg, Lg) != (D, D, B, L) or B != N * R or \
            pv.shape != pk.shape or gv.shape != gk.shape:
        raise ValueError("shape mismatch: q [N*R, D], pk/pv [L, N, K, D], "
                         "gk/gv [N*R, L, E, D]")
    if hd not in (32, 64, 128) or D % hd or R < 1:
        raise ValueError("kernel takes head_dim in {32, 64, 128} and at "
                         "least one beam per image")
    qs = q.stride(0)
    if any(t.stride() != (qs, 1) for t in (q, k_new, v_new)):
        raise ValueError("q/k_new/v_new need unit column stride and one "
                         "row stride")
    if not all(t.is_contiguous() for t in (pk, pv, gk, gv)):
        raise ValueError("caches must be contiguous")
    cap = E if e_cap is None else e_cap
    if not 0 < cap <= E or not 0 <= step < E or not 0 <= layer < L:
        raise ValueError(f"step {step} / e_cap {e_cap} / layer {layer} out "
                         f"of range for E={E}, L={L}")
    return min(step, cap)


def _check_gen_scales(q, gk, gks, gvs):
    """An int8 generated cache's scales (K6, K9): contiguous f32
    [B, L, 1, E] on q's device."""
    B, L, E = gk.shape[0], gk.shape[1], gk.shape[2]
    for s in (gks, gvs):
        if s.shape != (B, L, 1, E) or s.dtype != torch.float32 or \
                s.device != q.device or not s.is_contiguous():
            raise ValueError("gks/gvs must be contiguous f32 [B, L, 1, E]")


# The launch plan of csrc/decode_attention_async.cu (K2, K6, K8, K9, K15).
ATTN_THREADS = 128  # a block: three consumer warps and a producer warp
ATTN_STAGES = 2     # stages in a block's ring
ATTN_ROW_GROUP = 16  # rows a block serves (two tensor-core row tiles)
# shared memory a block: 37 KB keeps six blocks on an SM (228 KB, 1 KB of
# it reserved a block), so the served call's 768 blocks are resident in one
# wave on the H100's 132 SMs; then two, then one block an SM
ATTN_SMEM_BUDGETS = (37 * 1024, 112 * 1024, 227 * 1024)
SMEM_MAX = ATTN_SMEM_BUDGETS[-1]  # shared memory a block can have


def _up16(x: int) -> int:
    return (x + 15) & ~15


def _attention_smem(R, K, hd, itemsize, tile, nbuf, threads, n_gen,
                    cache_size=None, prefix_size=None, inreg=False) -> int:
    """Bytes of shared memory a block uses: the `Layout` total of
    csrc/decode_attention_async.cu, which refuses a launch whose plan
    disagrees. `itemsize` is q's; `cache_size` and `prefix_size` the
    generated cache's and the prefix's (q's, or 1 for int8 levels);
    `inreg`: K6's policy, whose int8 stages are read in place (no widened
    stage) and whose value sums of the generated slots take J8 threads a
    (row, 16-level word)."""
    csize, psize = cache_size or itemsize, prefix_size or itemsize
    R = min(R, ATTN_ROW_GROUP)  # the rows of one block
    rowb = hd * itemsize
    consumers = threads // 32 - 1
    ring = _up16(16 * nbuf)  # the full and empty mbarriers
    stage = _up16(max(K * hd * psize, R * tile * hd * csize))
    # an int8 stage widened to q's type
    wide = 0 if inreg else max(K if psize < itemsize else 0,
                               R * tile if csize < itemsize else 0) * rowb
    cur = ring + nbuf * stage + wide
    if itemsize == 2:  # bf16: the consumer warps' value sums, over the ring
        cur = max(cur, ring + consumers * -(-R // 8) * 8 * hd * 4)
        sums = 0
    else:  # f32: J threads' sums per (row, 16-byte word)
        sums = R * max(1, consumers * 32 // (R * (rowb // 16))) * hd * 4
    if inreg:  # K6: the generated slots' value sums [R][J8][hd]
        sums += R * max(1, consumers * 32 // (R * (hd // 16))) * hd * 4
    scw = K + (n_gen + tile) // tile * tile
    scales = (2 * K if psize == 1 else 0) + (2 * R * n_gen if csize == 1
                                             else 0)
    return (cur + 3 * R * rowb + _up16(R * scw * 4) + _up16(scales * 4)
            + sums + _up16(R * 4))


@functools.lru_cache(maxsize=512)
def attention_plan(N: int, R: int, K: int, D: int, hd: int, n_gen: int,
                   itemsize: int, cache_size: Optional[int] = None,
                   prefix_size: Optional[int] = None,
                   inreg: bool = False) -> dict:
    """The launch of the K2/K6/K8/K9/K15 kernel for one call: a block of
    `threads` per (head, image, group of at most ATTN_ROW_GROUP rows) on a
    grid of (D // hd, N, ceil(R / ATTN_ROW_GROUP)), each block serving its
    group's rows. The block streams 2 * (1 + nchunks) stages through a
    ring of `nbuf` (ATTN_STAGES) buffers in `smem` bytes: the prefix K,
    the K of `nchunks` chunks of `tile` generated slots (the current token
    in the last) of the group's rows, then the same for V. A chunk holds
    about twice the prefix's slices (tile = 2 ceil(K / rows);
    on the H100 this beat chunks of one prefix and rings of three to eight
    stages, and tied with three prefixes: scripts/torch_attn_sweep.py), so
    a chunk of int8 levels (`cache_size` 1: K6, K9) starts at twice the
    slots; `inreg`: K6's policy (`_attention_smem`). The tile shrinks until
    the block fits the first budget of ATTN_SMEM_BUDGETS that can hold it.
    Raises if nothing fits a block."""
    G = n_gen + 1
    csize = cache_size or itemsize
    rows = min(R, ATTN_ROW_GROUP)
    start = 2 * -(-K // rows) * (2 if csize == 1 else 1)
    for budget in ATTN_SMEM_BUDGETS:
        for tile in range(max(1, min(G, start)), 0, -1):
            smem = _attention_smem(R, K, hd, itemsize, tile, ATTN_STAGES,
                                   ATTN_THREADS, n_gen, cache_size,
                                   prefix_size, inreg)
            if smem <= budget:
                return dict(grid=(D // hd, N, -(-R // ATTN_ROW_GROUP)),
                            threads=ATTN_THREADS, tile=tile,
                            nbuf=ATTN_STAGES, nchunks=-(-G // tile),
                            smem=smem)
    raise ValueError(f"decode attention: R={R}, K={K}, head_dim={hd} in "
                     f"{itemsize}-byte values does not fit one block's "
                     f"{SMEM_MAX} bytes of shared memory")


def _attend_async(entry: str, q, k_new, v_new, pk, pv, gk, gv, layer, R,
                  hd, n_gen, scales=(), inreg=False) -> torch.Tensor:
    """One launch of csrc/decode_attention_async.cu through C entry
    `entry`: every head slice, q/k_new/v_new's included, travels in
    16-byte copies. `scales`: K9's (pks, pvs, gks, gvs), pks/pvs None for
    a prefix of q's type, or K6's (gks, gvs); the C entry takes the
    prefix's after pk/pv and the cache's after gk/gv. `inreg`: K6's
    policy."""
    if any(t.data_ptr() % 16 for t in (q, k_new, v_new, pk, pv, gk, gv)) \
            or q.stride(0) * q.element_size() % 16:
        raise ValueError("decode attention copies head slices in 16-byte "
                         "words: 16-byte-aligned q/k_new/v_new rows and "
                         "caches")
    B, D = q.shape
    L, N, K, _ = pk.shape
    plan = attention_plan(N, R, K, D, hd, n_gen, q.element_size(),
                          gk.element_size(), pk.element_size(), inreg)
    out = torch.empty(B, D, device=q.device, dtype=torch.float32)
    ptrs = [None if t is None else t.data_ptr() for t in scales]
    prefix = (pk.data_ptr(), pv.data_ptr(), *ptrs[:-2])
    cache = (gk.data_ptr(), gv.data_ptr(), *ptrs[-2:])
    _build.check(getattr(_build.library(), entry)(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), q.stride(0),
        *prefix, *cache, out.data_ptr(), N, R, L, K, gk.shape[2], D, hd,
        layer, n_gen, plan["tile"], plan["nbuf"], plan["threads"],
        plan["smem"], _build.dtype_code(q), _build.stream(q.device)), entry)
    return out


def beam_decode_attention_rowmajor(
        q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
        pk: torch.Tensor, pv: torch.Tensor, gk: torch.Tensor,
        gv: torch.Tensor, step: int, layer: int, *, beams_per_image: int,
        head_dim: int, e_cap: Optional[int] = None) -> torch.Tensor:
    """Fused decode attention over row-major caches.

    q/k_new/v_new: [B, D] rows with unit column stride and one shared row
    stride (views of the fused QKV output are fine); pk/pv: [L, N, K, D];
    gk/gv: [B, L, E, D] (read-only); every row 16-byte aligned; head_dim
    32, 64 or 128; step/layer: ints. Returns f32 [B, D].
    `e_cap`: read at most the first e_cap generated slots."""
    if _build.on_cpu(q):
        return beam_decode_attention_rowmajor_plain(
            q, k_new, v_new, pk, pv, gk, gv, step, layer,
            beams_per_image=beams_per_image, head_dim=head_dim, e_cap=e_cap)
    R, hd = beams_per_image, head_dim
    n_gen = _check_args(q, k_new, v_new, pk, pv, gk, gv, step, layer, R,
                        hd, e_cap, q.dtype)
    out = _attend_async("capdec_beam_decode_attention_rowmajor", q, k_new,
                        v_new, pk, pv, gk, gv, layer, R, hd, n_gen)
    beam_decode_attention_rowmajor.launches += 1
    return out


beam_decode_attention_rowmajor.launches = 0


def beam_decode_attention_rowmajor_q_plain(
        q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
        pk: torch.Tensor, pv: torch.Tensor, gk: torch.Tensor,
        gv: torch.Tensor, gks: torch.Tensor, gvs: torch.Tensor, step: int,
        layer: int, *, beams_per_image: int, head_dim: int,
        e_cap: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of K6 (same signature and result): the int8
    levels dequantise exactly into the input dtype and the scales apply
    as in the JAX reference's int8 decode_step."""
    return _attention_plain(q, k_new, v_new, pk, pv, gk, gv, step, layer,
                            beams_per_image, head_dim, e_cap, gks, gvs)


def beam_decode_attention_rowmajor_q(
        q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
        pk: torch.Tensor, pv: torch.Tensor, gk: torch.Tensor,
        gv: torch.Tensor, gks: torch.Tensor, gvs: torch.Tensor, step: int,
        layer: int, *, beams_per_image: int, head_dim: int,
        e_cap: Optional[int] = None) -> torch.Tensor:
    """`beam_decode_attention_rowmajor` over an int8 generated cache.

    gk/gv: int8 [B, L, E, D] levels; gks/gvs: f32 [B, L, 1, E] absmax
    scales (value = level * scale), written by
    cache_reorder.write_gen_slot_chunk_q. The prefix cache and q/k/v stay
    in float32 or bfloat16. `e_cap` bounds the slot reads; the scales are
    indexed at their full width E either way. Returns f32 [B, D]."""
    if _build.on_cpu(q):
        return beam_decode_attention_rowmajor_q_plain(
            q, k_new, v_new, pk, pv, gk, gv, gks, gvs, step, layer,
            beams_per_image=beams_per_image, head_dim=head_dim, e_cap=e_cap)
    R, hd = beams_per_image, head_dim
    n_gen = _check_args(q, k_new, v_new, pk, pv, gk, gv, step, layer, R,
                        hd, e_cap, torch.int8)
    _check_gen_scales(q, gk, gks, gvs)
    out = _attend_async("capdec_beam_decode_attention_rowmajor_q", q, k_new,
                        v_new, pk, pv, gk, gv, layer, R, hd, n_gen,
                        scales=(gks, gvs), inreg=True)
    beam_decode_attention_rowmajor_q.launches += 1
    return out


beam_decode_attention_rowmajor_q.launches = 0


def _check_chunks(q, gk, R, chunk, pks=None, pvs=None):
    """The TPU kernels' shape rules (decode_attention.py:505-508), and an
    int8 prefix's scales given as a pair."""
    B, E = q.shape[0], gk.shape[2]
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if B % R:
        raise ValueError(f"batch {B} is not a multiple of beams_per_image {R}")
    if E % chunk:
        raise ValueError(f"E ({E}) must be a multiple of chunk ({chunk})")
    if (pks is None) != (pvs is None):
        raise ValueError("an int8 prefix takes both pks and pvs")


def _chunk_reads(step, chunk, E):
    """The generated slots a chunked read covers: the chunks below `step`
    (at least one; slots at or above `step` are masked)."""
    return min(E, max(chunk, -(-step // chunk) * chunk))


def beam_decode_attention_chunked_plain(
        q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
        pk: torch.Tensor, pv: torch.Tensor, gk: torch.Tensor,
        gv: torch.Tensor, step: int, layer: int, *, beams_per_image: int,
        head_dim: int, chunk: int = 8) -> torch.Tensor:
    """Plain PyTorch version of K8 (same signature and result): the
    attention math over the chunks below `step`."""
    _check_chunks(q, gk, beams_per_image, chunk)
    return _attention_plain(q, k_new, v_new, pk, pv, gk, gv, step, layer,
                            beams_per_image, head_dim,
                            _chunk_reads(step, chunk, gk.shape[2]))


def beam_decode_attention_chunked(
        q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
        pk: torch.Tensor, pv: torch.Tensor, gk: torch.Tensor,
        gv: torch.Tensor, step: int, layer: int, *, beams_per_image: int,
        head_dim: int, chunk: int = 8) -> torch.Tensor:
    """Slot-bounded fused decode attention (v3) over row-major caches.

    The contract of `beam_decode_attention_rowmajor` without `e_cap`: the
    generated cache is read in `chunk`-slot tiles, only below `step`, with
    an online softmax. E must be a multiple of `chunk` and the batch of
    `beams_per_image`. Returns f32 [B, D]."""
    if _build.on_cpu(q):
        return beam_decode_attention_chunked_plain(
            q, k_new, v_new, pk, pv, gk, gv, step, layer,
            beams_per_image=beams_per_image, head_dim=head_dim, chunk=chunk)
    R, hd = beams_per_image, head_dim
    n_gen = _check_args(q, k_new, v_new, pk, pv, gk, gv, step, layer, R, hd,
                        None, q.dtype)
    _check_chunks(q, gk, R, chunk)
    out = _attend_async("capdec_beam_decode_attention_chunked", q, k_new,
                        v_new, pk, pv, gk, gv, layer, R, hd, n_gen)
    beam_decode_attention_chunked.launches += 1
    return out


beam_decode_attention_chunked.launches = 0


def beam_decode_attention_chunked_q_plain(
        q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
        pk: torch.Tensor, pv: torch.Tensor, gk: torch.Tensor,
        gv: torch.Tensor, gks: torch.Tensor, gvs: torch.Tensor, step: int,
        layer: int, *, beams_per_image: int, head_dim: int, chunk: int = 8,
        pks: Optional[torch.Tensor] = None,
        pvs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K9 (same signature and result)."""
    _check_chunks(q, gk, beams_per_image, chunk, pks, pvs)
    return _attention_plain(q, k_new, v_new, pk, pv, gk, gv, step, layer,
                            beams_per_image, head_dim,
                            _chunk_reads(step, chunk, gk.shape[2]), gks, gvs,
                            pks, pvs)


def beam_decode_attention_chunked_q(
        q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
        pk: torch.Tensor, pv: torch.Tensor, gk: torch.Tensor,
        gv: torch.Tensor, gks: torch.Tensor, gvs: torch.Tensor, step: int,
        layer: int, *, beams_per_image: int, head_dim: int, chunk: int = 8,
        pks: Optional[torch.Tensor] = None,
        pvs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`beam_decode_attention_chunked` over an int8 generated cache (levels
    gk/gv int8 [B, L, E, D]; scales gks/gvs f32 [B, L, 1, E]).

    With pks/pvs (f32 [L, N, 1, K], from gpt2.quantize_prefix_cache) the
    prefix pk/pv is int8 levels too: its K scale multiplies the score
    after the head sum and its V scale folds into the prefix probability.
    Returns f32 [B, D]."""
    if _build.on_cpu(q):
        return beam_decode_attention_chunked_q_plain(
            q, k_new, v_new, pk, pv, gk, gv, gks, gvs, step, layer,
            beams_per_image=beams_per_image, head_dim=head_dim, chunk=chunk,
            pks=pks, pvs=pvs)
    R, hd = beams_per_image, head_dim
    int8_prefix = pks is not None
    n_gen = _check_args(q, k_new, v_new, pk, pv, gk, gv, step, layer, R, hd,
                        None, torch.int8, torch.int8 if int8_prefix else None)
    _check_chunks(q, gk, R, chunk, pks, pvs)
    _check_gen_scales(q, gk, gks, gvs)
    L, N, K, _ = pk.shape
    for s in ((pks, pvs) if int8_prefix else ()):
        if s.shape != (L, N, 1, K) or s.dtype != torch.float32 or \
                s.device != q.device or not s.is_contiguous():
            raise ValueError("pks/pvs must be contiguous f32 [L, N, 1, K]")
    out = _attend_async("capdec_beam_decode_attention_chunked_q", q, k_new,
                        v_new, pk, pv, gk, gv, layer, R, hd, n_gen,
                        scales=(pks, pvs, gks, gvs))
    beam_decode_attention_chunked_q.launches += 1
    return out


beam_decode_attention_chunked_q.launches = 0


def beam_decode_attention_plain(
        q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
        pk: torch.Tensor, pv: torch.Tensor, gk: torch.Tensor,
        gv: torch.Tensor, step: int, *, beams_per_image: int,
        head_dim: int):
    """Plain PyTorch version of K15 (same signature and result): K2's
    attention math for one layer, then the slot write, in place."""
    if pk.dim() != 3 or gk.dim() != 3 or not 0 <= step < gk.shape[1]:
        raise ValueError(f"K15 takes pk/pv [N, K, D], gk/gv [B, E, D] and "
                         f"0 <= step < E; got pk {tuple(pk.shape)}, gk "
                         f"{tuple(gk.shape)}, step {step}")
    out = _attention_plain(q, k_new, v_new, pk[None], pv[None], gk[:, None],
                           gv[:, None], step, 0, beams_per_image, head_dim,
                           None)
    gk[:, step].copy_(k_new)
    gv[:, step].copy_(v_new)
    return out, gk, gv


def beam_decode_attention(
        q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
        pk: torch.Tensor, pv: torch.Tensor, gk: torch.Tensor,
        gv: torch.Tensor, step: int, *, beams_per_image: int,
        head_dim: int):
    """Fused decode attention of one layer with the slot write fused in
    (K15, the v1 kernel).

    q/k_new/v_new: [B, D] rows with unit column stride and one shared row
    stride; pk/pv: [N, K, D]; gk/gv: [B, E, D], contiguous; step: an int
    in [0, E). Each row b (image b // R) attends over its image's prefix,
    its slots below `step` and the current token; slots at or above
    `step` are never read. Slot `step` of gk/gv then holds k_new/v_new.
    The caches are updated IN PLACE and returned, the counterpart of the
    JAX kernel's donated, aliased buffers: returns (out f32 [B, D], gk,
    gv)."""
    if _build.on_cpu(q):
        return beam_decode_attention_plain(
            q, k_new, v_new, pk, pv, gk, gv, step,
            beams_per_image=beams_per_image, head_dim=head_dim)
    R, hd = beams_per_image, head_dim
    if pk.dim() != 3 or gk.dim() != 3:
        raise ValueError("K15 takes pk/pv [N, K, D] and gk/gv [B, E, D]")
    n_gen = _check_args(q, k_new, v_new, pk[None], pv[None], gk[:, None],
                        gv[:, None], step, 0, R, hd, None, q.dtype)
    for c in (gk, gv):  # the kernel writes them while it reads the rest
        for t in (q, k_new, v_new, pk, pv, gv if c is gk else gk):
            (a0, a1), (b0, b1) = _span(c), _span(t)
            if a0 < b1 and b0 < a1:
                raise ValueError("K15 writes gk/gv in place: they must not "
                                 "overlap each other or the other inputs")
    # one layer: the caches [B, E, D] are the row-major [B, 1, E, D]
    out = _attend_async("capdec_beam_decode_attention", q, k_new, v_new,
                        pk[None], pv[None], gk[:, None], gv[:, None], 0, R,
                        hd, n_gen)
    beam_decode_attention.launches += 1
    return out, gk, gv


beam_decode_attention.launches = 0

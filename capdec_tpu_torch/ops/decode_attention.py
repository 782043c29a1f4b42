"""K2 and K6: fused beam-decode attention over split KV caches (port of
capdec_tpu/ops/decode_attention.py::beam_decode_attention_rowmajor and
::beam_decode_attention_rowmajor_q).

One decode step of one transformer layer. For beam row b (image
n = b // R) and each head, a softmax over the image's shared prefix
slots, the row's generated slots below `step` (read only up to `e_cap`)
and the current token, then the weighted sum of V: f32 [B, D]. K6 reads
an int8 generated cache with per-(row, layer, slot) f32 scales.

On a CUDA tensor a wrapper launches csrc/decode_attention.cu (its note
says what bounds each kernel on the H100 and how the design answers); on
a CPU tensor it runs its plain version, the un-fused attention math of
the JAX reference's decode_step (gpt2.py:612-664).

Generated slots at or above `step` may hold stale or NaN bits after a
bounded fork copy: the kernel never reads them, and the plain version
masks their scores and zeroes their value products through `where`
(0 * NaN would be NaN).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build

NEG_INF = -1e9


def _attention_plain(q, k_new, v_new, pk, pv, gk, gv, step, layer, R, hd,
                     e_cap, gks=None, gvs=None):
    """The un-fused attention math of the JAX reference's decode_step
    (gpt2.py:612-664): products in the input dtype, reductions and softmax
    in f32. With gks/gvs (an int8 generated cache's scales [B, L, 1, E])
    each generated score takes its slot's K scale and each generated
    probability its slot's V scale (gpt2.py:629-646)."""
    B, D = q.shape
    L, N, K, _ = pk.shape
    H = D // hd
    E = gk.shape[2] if e_cap is None else e_cap
    if not 0 < E <= gk.shape[2]:
        raise ValueError(f"e_cap {e_cap} out of range for E={gk.shape[2]}")
    pk_l, pv_l = pk[layer], pv[layer]              # [N, K, D]
    gk_l = gk[:, layer, :E].to(q.dtype)            # [B, E, D]
    gv_l = gv[:, layer, :E].to(q.dtype)
    scale = 1.0 / hd ** 0.5

    def heads(prod):  # [..., D] -> [..., H] per-head sums in f32
        return prod.float().reshape(*prod.shape[:-1], H, hd).sum(-1)

    def spread(p):  # [..., H] -> [..., D]
        return p.to(q.dtype).repeat_interleave(hd, dim=-1)

    valid = (torch.arange(E, device=q.device) < step)[None, :, None]
    sp = heads(q.reshape(N, R, 1, D) * pk_l[:, None])          # [N, R, K, H]
    sg = heads(q[:, None, :] * gk_l)                            # [B, E, H]
    if gks is not None:
        sg = sg * gks[:, layer, 0, :E, None]
    sg = torch.where(valid, sg * scale, NEG_INF)
    sc = heads(q * k_new)[:, None, :]                           # [B, 1, H]
    scores = torch.cat([sp.reshape(B, K, H) * scale, sg, sc * scale], dim=1)
    probs = torch.softmax(scores, dim=1)                        # [B, S, H]
    pg = probs[:, K:K + E]
    if gvs is not None:
        pg = pg * gvs[:, layer, 0, :E, None]
    out = (spread(probs[:, :K]).reshape(N, R, K, D)
           * pv_l[:, None]).sum(2).reshape(B, D)
    out = out + torch.where(valid, spread(pg) * gv_l, 0.0).sum(1)
    out = out + spread(probs[:, K + E]) * v_new
    return out.float()


def beam_decode_attention_rowmajor_plain(
        q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
        pk: torch.Tensor, pv: torch.Tensor, gk: torch.Tensor,
        gv: torch.Tensor, step: int, layer: int, *, beams_per_image: int,
        head_dim: int, e_cap: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of K2 (same signature and result)."""
    return _attention_plain(q, k_new, v_new, pk, pv, gk, gv, step, layer,
                            beams_per_image, head_dim, e_cap)


def _check_args(q, k_new, v_new, pk, pv, gk, gv, step, layer, R, hd,
                e_cap, gen_dtype):
    """Validate a fused-attention call on CUDA tensors; returns the
    generated-slot read count min(step, e_cap)."""
    B, D = q.shape
    L, N, K, Dp = pk.shape
    Bg, Lg, E, Dg = gk.shape
    if any(t.dtype != q.dtype or t.device != q.device
           for t in (k_new, v_new, pk, pv)) or \
            any(t.dtype != gen_dtype or t.device != q.device
                for t in (gk, gv)):
        raise ValueError("decode attention takes one dtype and device "
                         "(an int8 generated cache under K6)")
    if (Dp, Dg, Bg, Lg) != (D, D, B, L) or B != N * R or \
            pv.shape != pk.shape or gv.shape != gk.shape:
        raise ValueError("shape mismatch: q [N*R, D], pk/pv [L, N, K, D], "
                         "gk/gv [N*R, L, E, D]")
    if hd % 32 or hd > 128 or D % hd or not 0 < R <= 32:
        raise ValueError("kernel takes head_dim in {32, 64, 96, 128} and "
                         "1..32 beams per image")
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


def beam_decode_attention_rowmajor(
        q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
        pk: torch.Tensor, pv: torch.Tensor, gk: torch.Tensor,
        gv: torch.Tensor, step: int, layer: int, *, beams_per_image: int,
        head_dim: int, e_cap: Optional[int] = None) -> torch.Tensor:
    """Fused decode attention over row-major caches.

    q/k_new/v_new: [B, D] rows with unit column stride and one shared row
    stride (views of the fused QKV output are fine); pk/pv: [L, N, K, D];
    gk/gv: [B, L, E, D] (read-only); step/layer: ints. Returns f32 [B, D].
    `e_cap`: read at most the first e_cap generated slots."""
    if _build.on_cpu(q):
        return beam_decode_attention_rowmajor_plain(
            q, k_new, v_new, pk, pv, gk, gv, step, layer,
            beams_per_image=beams_per_image, head_dim=head_dim, e_cap=e_cap)
    R, hd = beams_per_image, head_dim
    n_gen = _check_args(q, k_new, v_new, pk, pv, gk, gv, step, layer, R,
                        hd, e_cap, q.dtype)
    B, D = q.shape
    L, N, K, _ = pk.shape
    out = torch.empty(B, D, device=q.device, dtype=torch.float32)
    lib = _build.library()
    _build.check(lib.capdec_beam_decode_attention_rowmajor(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), q.stride(0),
        pk.data_ptr(), pv.data_ptr(), gk.data_ptr(), gv.data_ptr(),
        out.data_ptr(), N, R, L, K, gk.shape[2], D, hd, layer, n_gen,
        _build.dtype_code(q), _build.stream(q.device)),
        "beam_decode_attention_rowmajor")
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
    B, D = q.shape
    L, N, K, _ = pk.shape
    E = gk.shape[2]
    if hd not in (32, 64, 128) or D % 16 or gk.data_ptr() % 16 or \
            gv.data_ptr() % 16:
        raise ValueError("K6 reads 16 levels per load: head_dim in "
                         "{32, 64, 128}, D % 16 == 0, aligned caches")
    for s in (gks, gvs):
        if s.shape != (B, L, 1, E) or s.dtype != torch.float32 or \
                s.device != q.device or not s.is_contiguous():
            raise ValueError("gks/gvs must be contiguous f32 [B, L, 1, E]")
    out = torch.empty(B, D, device=q.device, dtype=torch.float32)
    lib = _build.library()
    _build.check(lib.capdec_beam_decode_attention_rowmajor_q(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), q.stride(0),
        pk.data_ptr(), pv.data_ptr(), gk.data_ptr(), gv.data_ptr(),
        gks.data_ptr(), gvs.data_ptr(), out.data_ptr(), N, R, L, K, E, D, hd,
        layer, n_gen, _build.dtype_code(q), _build.stream(q.device)),
        "beam_decode_attention_rowmajor_q")
    beam_decode_attention_rowmajor_q.launches += 1
    return out


beam_decode_attention_rowmajor_q.launches = 0

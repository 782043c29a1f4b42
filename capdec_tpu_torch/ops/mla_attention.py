"""K16: absorbed multi-head latent attention (MLA) of a decode step, and the
step's latent entry (`mla_prep`), for models/mla_moe.py.

`mla_decode_attention(q_lat, q_pe, lat_new, prefix, gen, step, layer)`
attends each beam row's H query heads over the latent rows of its image's
prefix, its own generated slots below `step` and the step's latent, and
returns the heads' latent outputs [H, B, Dl]: softmax(scale (q_lat . c_kv +
q_pe . k_pe)) . c_kv, each head's q_lat being q_nope W_UK[h]. A latent row
is [c_kv (Dl) | k_pe (Dr)]; the caches are the prefix [L, N, K, Dl + Dr]
and the row-major generated cache [B, L, E, Dl + Dr].

`mla_prep(q, kv_a, norm_w, cos, sin, eps, qk_head)` makes the step's
latent row from the kv_a product (c_kv's RMSNorm, k_pe's rotary
embedding) and rotates each head's q_pe in place in q.

On a CUDA tensor each wrapper launches its hand-written kernel
(csrc/mla_attention.cu, whose note says what bounds K16 and how its
design answers); on a CPU tensor it runs its plain PyTorch version.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

# The kernel's shapes (csrc/mla_attention.cu).
HEADS, LAT, ROPE = 16, 512, 64
ROW = LAT + ROPE
PITCH = ROW + 8           # a latent row in shared memory: 1168 bytes
THREADS = 128
CHUNK = 32                # latent rows a chunk (two buffers)
P_STRIDE = CHUNK + 8      # a row of bf16 numerators
LOG2E = 1.4426950408889634


def mla_attention_plan(B: int, R: int, K: int, step: int, H: int = HEADS,
                       Dl: int = LAT, Dr: int = ROPE) -> dict:
    """K16's launch for B beam rows (R a image) over K prefix slots at
    decode step `step`: `grid` blocks of `threads`, one a row, over
    `slots` (K + step + 1) latent rows in `chunks` chunks of CHUNK, in
    `smem` bytes of shared memory (the queries, two chunk buffers, a
    chunk's f32 scores and bf16 numerators, each head's running max, sum
    and rescale). Raises for a shape the kernel does not take."""
    if (H, Dl, Dr) != (HEADS, LAT, ROPE):
        raise ValueError(f"mla_decode_attention takes {HEADS} heads of "
                         f"latent {LAT} and rope {ROPE}, got {H}, {Dl}, {Dr}")
    if B < 1 or R < 1 or B % R or K < 1 or step < 0:
        raise ValueError(f"mla_decode_attention: B {B} a multiple of R {R}, "
                         f"K {K} >= 1, step {step} >= 0")
    S = K + step + 1
    smem = (HEADS + 2 * CHUNK) * PITCH * 2 + HEADS * CHUNK * 4 \
        + HEADS * P_STRIDE * 2 + 3 * HEADS * 4
    return dict(grid=B, threads=THREADS, slots=S, chunks=-(-S // CHUNK),
                smem=smem)


def mla_decode_attention_plain(q_lat: torch.Tensor, q_pe: torch.Tensor,
                               lat_new: torch.Tensor, prefix: torch.Tensor,
                               gen: torch.Tensor, step: int, layer: int, *,
                               beams_per_image: int, scale: float
                               ) -> torch.Tensor:
    """Plain PyTorch version (f32 scores, softmax and sums)."""
    H, B, Dl = q_lat.shape
    R = beams_per_image
    slots = torch.cat([prefix[layer].repeat_interleave(R, 0),
                       gen[:, layer, :step], lat_new[:, None]], 1).float()
    q = torch.cat([q_lat.transpose(0, 1), q_pe], -1).float()      # [B, H, C]
    p = torch.softmax(torch.einsum("bhc,bsc->bhs", q, slots) * scale, -1)
    out = torch.einsum("bhs,bsc->hbc", p, slots[..., :Dl])
    return out.to(q_lat.dtype)


def mla_decode_attention(q_lat: torch.Tensor, q_pe: torch.Tensor,
                         lat_new: torch.Tensor, prefix: torch.Tensor,
                         gen: torch.Tensor, step: int, layer: int, *,
                         beams_per_image: int, scale: float) -> torch.Tensor:
    """K16. q_lat [H, B, Dl] (contiguous), q_pe [B, H, Dr] (a view with a
    contiguous last dimension), lat_new [B, Dl + Dr] (the step's latent,
    rows contiguous), prefix [L, N, K, Dl + Dr] and gen [B, L, E, Dl + Dr]
    (contiguous), all bf16. Returns [H, B, Dl] bf16."""
    if _build.on_cpu(q_lat):
        return mla_decode_attention_plain(q_lat, q_pe, lat_new, prefix, gen,
                                          step, layer,
                                          beams_per_image=beams_per_image,
                                          scale=scale)
    H, B, Dl = q_lat.shape
    L, N, K, C = prefix.shape
    E = gen.shape[2]
    Dr = C - Dl
    for t in (q_lat, q_pe, lat_new, prefix, gen):
        if t.dtype != torch.bfloat16 or t.device != q_lat.device:
            raise ValueError("mla_decode_attention takes bf16 tensors on one "
                             "device")
    if not (q_lat.is_contiguous() and prefix.is_contiguous()
            and gen.is_contiguous()) or gen.shape[:2] != (B, L) \
            or gen.shape[3] != C or q_pe.shape != (B, H, Dr) \
            or q_pe.stride(2) != 1 or lat_new.shape != (B, C) \
            or lat_new.stride(1) != 1 or N * beams_per_image != B:
        raise ValueError("mla_decode_attention: q_lat [H, B, Dl], q_pe "
                         "[B, H, Dr], lat_new [B, C], prefix [L, N, K, C], "
                         "gen [B, L, E, C]")
    if not 0 <= step < E or not 0 <= layer < L:
        raise ValueError(f"step {step} / layer {layer} out of range")
    plan = mla_attention_plan(B, beams_per_image, K, step, H, Dl, Dr)
    out = torch.empty(H, B, Dl, device=q_lat.device, dtype=torch.bfloat16)
    _build.check(_build.library().capdec_mla_decode_attention(
        q_lat.data_ptr(), q_pe.data_ptr(), q_pe.stride(0), q_pe.stride(1),
        lat_new.data_ptr(), lat_new.stride(0), prefix.data_ptr(),
        gen.data_ptr(), out.data_ptr(), B, beams_per_image, K, L, E, layer,
        step, scale * LOG2E, plan["smem"], _build.stream(q_lat.device)),
        "mla_decode_attention")
    mla_decode_attention.launches += 1
    return out


mla_decode_attention.launches = 0


def rope_tables(positions: int, dim: int, theta: float, device=None):
    """cos, sin [positions, dim / 2] (f32) of the rotary embedding,
    rotate-half form: frequencies theta^(-2i / dim)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=device) / dim))
    ang = torch.arange(positions, dtype=torch.float32, device=device)[:, None] \
        * inv[None]
    return torch.cos(ang), torch.sin(ang)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
           ) -> torch.Tensor:
    """The rotary embedding of x [..., dim] (rotate-half form, f32): pair
    (i, i + dim / 2) turned by the angle of frequency i."""
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h], x[..., h:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def mla_prep_plain(q: torch.Tensor, kv_a: torch.Tensor, norm_w: torch.Tensor,
                   cos: torch.Tensor, sin: torch.Tensor, eps: float,
                   qk_head: int, out: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Plain PyTorch version of `mla_prep` (f32 math)."""
    B = q.shape[0]
    C = kv_a.shape[1]
    Dr = cos.shape[-1] * 2
    Dl = C - Dr
    c = kv_a[:, :Dl].float()
    c = c * torch.rsqrt(c.pow(2).mean(-1, keepdim=True) + eps) * norm_w
    lat = torch.cat([c, rotate(kv_a[:, Dl:].float(), cos, sin)], -1)
    qv = q.view(B, -1, qk_head)
    qv[..., qk_head - Dr:] = rotate(qv[..., qk_head - Dr:].float(), cos,
                                    sin).to(q.dtype)
    if out is None:
        return lat.to(kv_a.dtype)
    out.copy_(lat)
    return out


def mla_prep(q: torch.Tensor, kv_a: torch.Tensor, norm_w: torch.Tensor,
             cos: torch.Tensor, sin: torch.Tensor, eps: float, qk_head: int,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The step's latent rows [B, Dl + Dr] from kv_a [B, Dl + Dr] (c_kv
    RMS-normed with norm_w f32 [Dl] and eps, k_pe rotated by cos/sin f32
    [Dr / 2] of the step's position), and each head's rope part (the last
    Dr of its qk_head values) rotated in place in q [B, H qk_head]. Into
    `out` when given (a [B, Dl + Dr] view with contiguous rows)."""
    if _build.on_cpu(q):
        return mla_prep_plain(q, kv_a, norm_w, cos, sin, eps, qk_head, out)
    B, C = kv_a.shape
    if q.dtype != torch.bfloat16 or kv_a.dtype != torch.bfloat16 \
            or C != ROW or cos.shape != (ROPE // 2,) or q.stride(1) != 1 \
            or kv_a.stride(1) != 1 or q.shape[1] % qk_head \
            or q.shape[1] // qk_head != HEADS:
        raise ValueError("mla_prep takes bf16 q [B, 16 qk_head] and kv_a "
                         f"[B, {ROW}] with contiguous rows")
    if out is None:
        out = torch.empty(B, C, device=q.device, dtype=torch.bfloat16)
    _build.check(_build.library().capdec_mla_prep(
        q.data_ptr(), q.stride(0), kv_a.data_ptr(), kv_a.stride(0),
        norm_w.data_ptr(), cos.data_ptr(), sin.data_ptr(), eps,
        out.data_ptr(), out.stride(0), B, qk_head, _build.stream(q.device)),
        "mla_prep")
    mla_prep.launches += 1
    return out


mla_prep.launches = 0


def softmax_scale(qk_head: int) -> float:
    """1 / sqrt(the query-key width), DeepSeek-V3's without rope scaling."""
    return 1.0 / math.sqrt(qk_head)

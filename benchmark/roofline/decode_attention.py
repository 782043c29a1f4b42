"""K2, `ops/decode_attention.py` beam_decode_attention_rowmajor: one
layer's attention of B = N x R beam rows at decode step `step` over the
image's prefix K/V (shared by its R beams) and the row's generated K/V in
the slots below `step`, plus the step's own k and v. Kernel
`async_attn<...>`, one call a layer.

Bytes, each input read once and the output written once: q, k_new and
v_new [B, D], the prefix K and V [N, K, D], the generated K and V [B,
step, D], all `itemsize`; the f32 output [B, D]. Operations: the scores
and the weighted values over the K + step + 1 keys, 4 D of them a key."""
from __future__ import annotations

KERNELS = ("async_attn",)


def flops(N: int, R: int, K: int, D: int, step: int) -> float:
    return 4.0 * N * R * D * (K + step + 1)


def nbytes(N: int, R: int, K: int, D: int, step: int,
           itemsize: int = 2) -> float:
    B = N * R
    return (3 * B * D + 2 * N * K * D + 2 * B * step * D) * itemsize \
        + B * D * 4

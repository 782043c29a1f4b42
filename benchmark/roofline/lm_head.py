"""K1, `ops/lm_head.py` lm_head_topk: the tied LM head's product with a
row logsumexp and the top-R of each row, without the [B, V] logits
reaching memory. Kernels: `lm_head_wgmma<...>` (bf16) then
`lm_head_merge`, one call each.

Counted as the algorithm needs it: the hidden rows and the vocabulary's
weights read once, each row's top-R values (f32) and indices (int32) and
its logsumexp (f32) written once; the product's 2 B D V operations."""
from __future__ import annotations

KERNELS = ("lm_head_wgmma", "lm_head_merge")


def flops(B: int, D: int, V: int) -> float:
    return 2.0 * B * D * V


def nbytes(B: int, D: int, V: int, R: int, itemsize: int = 2) -> float:
    return (B * D + V * D) * itemsize + B * R * (4 + 4) + B * 4

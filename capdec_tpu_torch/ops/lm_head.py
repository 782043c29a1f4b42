"""K1: fused LM head + logsumexp + exact top-R (port of capdec_tpu/ops/lm_head.py).

`lm_head_topk(hidden, wte, r)` returns the top-r values of
`hidden @ wte^T` (f32), their indices (the lowest index wins a tie, as
`lax.top_k`) and the row logsumexp, without the [B, V] logits ever
reaching device memory on the card.

On a CUDA tensor the wrapper launches the hand-written kernel
(csrc/lm_head.cu; its note says what bounds it on the H100 and how the
design answers); on a CPU tensor it runs `lm_head_topk_plain`, the same
function in plain PyTorch. The TPU kernel's grid-order (`vocab_outer`)
and lane-merge (`merge="lanes"`) variants give the same output and are
not ported.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build

VOCAB_CHUNK = 128  # vocab entries per pass-1 block (csrc/lm_head.cu VC)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis in lax.top_k's order: value descending,
    lowest index first among equal values (a stable sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def lm_head_topk_plain(hidden: torch.Tensor, wte: torch.Tensor, r: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: f32 logits, logsumexp, top-r."""
    logits = torch.matmul(hidden.float(), wte.float().t())
    vals, idx = _top_k(logits, r)
    return vals, idx, torch.logsumexp(logits, dim=-1)


def lm_head_topk(hidden: torch.Tensor, wte: torch.Tensor, r: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused `top_k(hidden @ wte^T, r)` + logsumexp.

    hidden: [B, D] (post-final-layernorm); wte: [V, D] (tied LM head),
    both float32 or both bfloat16. Returns (vals [B, r] f32, idx [B, r]
    int64, lse [B] f32)."""
    if _build.on_cpu(hidden):
        return lm_head_topk_plain(hidden, wte, r)
    B, D = hidden.shape
    V, Dw = wte.shape
    if Dw != D or wte.device != hidden.device or wte.dtype != hidden.dtype:
        raise ValueError("hidden [B, D] and wte [V, D] must share D, device "
                         "and dtype")
    if not (hidden.is_contiguous() and wte.is_contiguous()):
        raise ValueError("lm_head_topk takes contiguous tensors")
    if not 0 < r <= min(V, VOCAB_CHUNK):
        raise ValueError(f"r={r} out of range for V={V}")
    code = _build.dtype_code(hidden)
    if hidden.dtype == torch.bfloat16 and (
            D % 8 or hidden.data_ptr() % 16 or wte.data_ptr() % 16):
        raise ValueError("the bf16 kernel moves 16-byte vectors: D % 8 == 0 "
                         "and 16-byte aligned tensors")
    nc = -(-V // VOCAB_CHUNK)
    dev = hidden.device
    f32 = dict(device=dev, dtype=torch.float32)
    part_m = torch.empty(B, nc, **f32)
    part_l = torch.empty(B, nc, **f32)
    part_v = torch.empty(B, nc, r, **f32)
    part_i = torch.empty(B, nc, r, device=dev, dtype=torch.int32)
    vals = torch.empty(B, r, **f32)
    idx = torch.empty(B, r, device=dev, dtype=torch.int64)
    lse = torch.empty(B, **f32)
    lib = _build.library()
    _build.check(lib.capdec_lm_head_topk(
        hidden.data_ptr(), wte.data_ptr(), B, V, D, r, nc,
        part_m.data_ptr(), part_l.data_ptr(), part_v.data_ptr(),
        part_i.data_ptr(), vals.data_ptr(), idx.data_ptr(), lse.data_ptr(),
        code, _build.stream(dev)), "lm_head_topk")
    lm_head_topk.launches += 1
    return vals, idx, lse


lm_head_topk.launches = 0

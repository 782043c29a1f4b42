"""K1: fused LM head + logsumexp + exact top-R (port of capdec_tpu/ops/lm_head.py).

`lm_head_topk(hidden, wte, r)` returns the top-r values of
`hidden @ wte^T` (f32), their indices (the lowest index wins a tie, as
`lax.top_k`) and the row logsumexp, without the [B, V] logits ever
reaching device memory on the card.

On a CUDA tensor the wrapper launches the hand-written kernel
(csrc/lm_head.cu; its note says what bounds it on the H100 and how the
design answers) with the launch plan `lm_head_plan`; on a CPU tensor it
runs `lm_head_topk_plain`, the same function in plain PyTorch. The TPU
kernel's grid-order (`vocab_outer`) and lane-merge (`merge="lanes"`)
variants give the same output and are not ported.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from . import _build

# The launch plan of csrc/lm_head.cu.
TILE_M = 64        # rows of h a warpgroup multiplies (wgmma's M)
TILE_K = 64        # depth of a slice: one 128-byte swizzled row of bf16
# vocab entries a block holds, the widest that fits: 128 up to D 832, 64 up
# to D 1664, 48 beyond (D 2048: a weight tile of 64 needs 256 KB)
WGMMA_TILE_N = (128, 64, 48)
WGMMA_THREADS = 384  # two consumer warpgroups and a producer one
MAX_STAGES = 8     # h slices in the ring
CONSUMERS = 2      # consumer warpgroups (an mbarrier each)
SMEM_MAX = 232448  # dynamic shared memory a Hopper block can have
H100_SMS = 132
# f32: the FMA kernel, one block per (64-row tile, 128-entry vocab chunk)
FMA_TILE_N, FMA_TILE_K, FMA_THREADS = 128, 32, 256
FMA_SMEM = TILE_M * (FMA_TILE_N + 4) * 4  # its static score tile


def _wgmma_smem(ks: int, tile_n: int, stages: int) -> int:
    """Bytes of dynamic shared memory of the bf16 kernel: the `wgmma_smem`
    of csrc/lm_head.cu, which refuses a launch whose plan disagrees (1 KB
    of alignment, the weight tile, the ring of h slices, the mbarriers)."""
    return (1024 + ks * tile_n * TILE_K * 2 + stages * TILE_M * TILE_K * 2
            + (2 * ks + 2 * stages + CONSUMERS) * 8)


@functools.lru_cache(maxsize=256)
def lm_head_plan(B: int, V: int, D: int, R: int, itemsize: int,
                 sms: int = H100_SMS) -> dict:
    """The launch of csrc/lm_head.cu for hidden [B, D] and weights [V, D]
    of `itemsize` bytes on a card of `sms` SMs.

    bf16 (itemsize 2): `blocks` = min(partials, sms) persistent blocks
    of `threads` (the launch `grid`, x first), block b holding vocab
    tiles b, b + blocks, ... of `tile_n` entries whole (ceil(D / tile_k)
    slices) in `smem` bytes while every 64-row tile of h passes through a
    ring of `stages` slices; tile_n is the widest of WGMMA_TILE_N that
    fits, the ring the deepest (up to MAX_STAGES). f32 (itemsize 4): the
    FMA kernel, a grid of (row tiles of 64, `blocks` vocab chunks of 128). Either writes one partial (max, sum-exp, top-R) per (row, vocab
    tile): `partials` = ceil(V / tile_n), which the second pass merges.
    `r_max` is the largest R the plan takes. Raises if R is out of range
    or the weight tile does not fit a block."""
    if itemsize == 4:
        parts = -(-V // FMA_TILE_N)
        plan = dict(route="fma", tile_m=TILE_M, tile_n=FMA_TILE_N,
                    tile_k=FMA_TILE_K, stages=1, threads=FMA_THREADS,
                    grid=(-(-B // TILE_M), parts), blocks=parts,
                    smem=FMA_SMEM, partials=parts)
    else:
        ks = -(-D // TILE_K)
        fits = [(tile_n, stages) for tile_n in WGMMA_TILE_N
                for stages in range(MAX_STAGES, 1, -1)
                if _wgmma_smem(ks, tile_n, stages) <= SMEM_MAX]
        if not fits:
            raise ValueError(f"lm_head_topk: a {WGMMA_TILE_N[-1]}-entry "
                             f"weight tile of D={D} does not fit one "
                             f"block's {SMEM_MAX} bytes")
        tile_n, stages = fits[0]
        parts = -(-V // tile_n)
        blocks = min(parts, sms)
        plan = dict(route="wgmma", tile_m=TILE_M, tile_n=tile_n,
                    tile_k=TILE_K, stages=stages, threads=WGMMA_THREADS,
                    grid=(blocks, 1), blocks=blocks,
                    smem=_wgmma_smem(ks, tile_n, stages), partials=parts)
    plan["r_max"] = min(V, plan["tile_n"])
    if not 0 < R <= plan["r_max"]:
        raise ValueError(f"r={R} out of range for V={V}: 1..{plan['r_max']}")
    return plan


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

    hidden: [B, D] (post-final-norm); wte: [V, D] (GPT-2's tied LM head,
    or an untied `lm_head.weight`), both float32 or both bfloat16. Returns
    (vals [B, r] f32, idx [B, r] int64, lse [B] f32)."""
    if _build.on_cpu(hidden):
        return lm_head_topk_plain(hidden, wte, r)
    B, D = hidden.shape
    V, Dw = wte.shape
    if Dw != D or wte.device != hidden.device or wte.dtype != hidden.dtype:
        raise ValueError("hidden [B, D] and wte [V, D] must share D, device "
                         "and dtype")
    if not (hidden.is_contiguous() and wte.is_contiguous()):
        raise ValueError("lm_head_topk takes contiguous tensors")
    code = _build.dtype_code(hidden)
    if hidden.dtype == torch.bfloat16 and (
            D % 8 or hidden.data_ptr() % 16 or wte.data_ptr() % 16):
        raise ValueError("the bf16 kernel copies rows by TMA: D % 8 == 0 "
                         "and 16-byte aligned tensors")
    dev = hidden.device
    plan = lm_head_plan(B, V, D, r, hidden.element_size(),
                        _build.sm_count(dev))
    p = plan["partials"]
    # the partials in one allocation: max, sum-exp [B, p], top-r values
    # [B, p, r] (f32) and indices [B, p, r] (int32)
    scratch = torch.empty(B * p * (2 + 2 * r), device=dev,
                          dtype=torch.float32)
    part_m, part_l, part_v, part_i = scratch.split(
        [B * p, B * p, B * p * r, B * p * r])
    vals = torch.empty(B, r, device=dev, dtype=torch.float32)
    idx = torch.empty(B, r, device=dev, dtype=torch.int64)
    lse = torch.empty(B, device=dev, dtype=torch.float32)
    _build.check(_build.library().capdec_lm_head_topk(
        hidden.data_ptr(), wte.data_ptr(), B, V, D, r, p,
        part_m.data_ptr(), part_l.data_ptr(), part_v.data_ptr(),
        part_i.data_ptr(), vals.data_ptr(), idx.data_ptr(), lse.data_ptr(),
        plan["tile_n"], plan["stages"], plan["threads"], plan["blocks"],
        plan["smem"], code, _build.stream(dev)), "lm_head_topk")
    lm_head_topk.launches += 1
    return vals, idx, lse


lm_head_topk.launches = 0

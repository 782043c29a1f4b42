"""Matmul operations of one train step, frozen with the benchmark: the
port's `utils/flops.py::train_step_matmul_flops` as it stood when the
benchmark was written, over a configuration file's `model` object.

  * a product [m,k]x[k,n] costs 2 m k n; attention scores and values use
    the causal average span (S+1)/2
  * a frozen weight's backward costs its dX product; a trained one dX + dW
  * the LM head runs on the n_tokens scored positions only
"""
from __future__ import annotations

from typing import Dict


def _gpt2_block(d: int, n_pos: int) -> float:
    dense = 2 * d * 3 * d + 2 * d * d + 2 * (2 * d * 4 * d)
    attn = 2 * (2 * d * (n_pos + 1) / 2)
    return dense + attn


def _mapper_block(d: int, n_pos: int, mlp_ratio: float) -> float:
    dense = 2 * d * d + 2 * d * 2 * d + 2 * d * d + 2 * (2 * mlp_ratio * d * d)
    attn = 2 * (2 * d * n_pos)
    return dense + attn


def train_step_flops(cfg: Dict, batch: int, n_tokens: int,
                     only_prefix: bool = False) -> float:
    g, m = cfg["gpt2"], cfg["mapper"]
    D = g["n_embd"]
    S = m["prefix_length"] + n_tokens
    blk = _gpt2_block(D, S)
    gpt_fwd = batch * S * g["n_layer"] * blk
    gpt_bwd = gpt_fwd * (1.0 if only_prefix else 2.0) \
        + batch * S * g["n_layer"] * 2 * (2 * D * (S + 1) / 2)
    head_one = 2 * D * g["vocab_size"] * batch * n_tokens
    head = head_one * (2.0 if only_prefix else 3.0)
    if m["type"] == "transformer":
        mp_pos = m["clip_length"] + m["prefix_length"]
        mapper_fwd = batch * mp_pos * m["num_layers"] * _mapper_block(
            D, mp_pos, m["mlp_ratio"]) \
            + 2 * m["prefix_size"] * m["clip_length"] * D * batch
    else:
        h = D * m["prefix_length"]
        mapper_fwd = 2 * batch * (m["prefix_size"] * h // 2 + (h // 2) * h)
    return gpt_fwd + gpt_bwd + head + 3.0 * mapper_fwd

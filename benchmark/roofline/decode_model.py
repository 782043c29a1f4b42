"""Model matmul operations of one served caption (beam search), counted
from the architecture; elementwise work is left out, as MFU's convention
has it. Products: 2 m k n operations.

  mapper   transformer: linear 2 C CL D; per layer and token of the
           CL + K pseudo tokens 16 D^2 (q, kv, project, fc1/fc2 at
           mlp_ratio 2) + 4 D S (scores and values over S tokens);
           mlp: 2 (C H + H D K), H = D K / 2
  prefill  K prefix positions through the L blocks (24 D^2 a token and
           layer, 4 D (p + 1) for causal attention at position p), then
           the LM head at the last position (2 D V)
  steps    E - 1 decode steps of R beam rows: per row L (24 D^2 +
           4 D (K + s + 1)) at step s, and the LM head 2 D V
"""
from __future__ import annotations

from typing import Dict


def mapper_flops(m: Dict, D: int) -> float:
    """The mapper `m`'s matmul operations for one image, at the
    decoder's width D."""
    C, K = m["prefix_size"], m["prefix_length"]
    if m["type"] == "mlp":
        H = D * K // 2
        return 2.0 * (C * H + H * D * K)
    CL = m["clip_length"]
    S = CL + K
    ratio = m["mlp_ratio"]
    per_token = (2 + 4 + 2 + 4 * ratio) * D * D + 4 * D * S
    return 2.0 * C * CL * D + S * m["num_layers"] * per_token


def gpt2_token_flops(cfg: Dict, keys: int) -> float:
    """One token through every block, attending over `keys` keys."""
    g = cfg["gpt2"]
    D = g["n_embd"]
    return g["n_layer"] * (24.0 * D * D + 4.0 * D * keys)


def caption_flops(cfg: Dict, beam_size: int, entry_length: int) -> float:
    """Matmul operations of one caption decoded to `entry_length` tokens
    (every step run: the benchmark's random weights never stop early)."""
    g = cfg["gpt2"]
    D, V = g["n_embd"], g["vocab_size"]
    K = cfg["mapper"]["prefix_length"]
    head = 2.0 * D * V
    prefill = sum(gpt2_token_flops(cfg, p + 1) for p in range(K)) + head
    steps = sum(beam_size * (gpt2_token_flops(cfg, K + s + 1) + head)
                for s in range(entry_length - 1))
    return mapper_flops(cfg["mapper"], D) + prefill + steps

"""Analytic matmul-FLOP accounting for the caption model's train step
(the port's copy of capdec_tpu/utils/flops.py, over the port's config).

MFU needs a trustworthy numerator, so the FLOPs are counted analytically
from the architecture: the standard 6ND-style accounting, restricted to
matmuls (the MFU convention: elementwise work is not counted against the
tensor-core peak).

Conventions:
  * a matmul [m,k]x[k,n] costs 2*m*k*n FLOPs
  * attention scores/outputs use the causal average span (S+1)/2
  * backward through a frozen weight still costs its dX matmul
    (2*m*k*n); a trained weight costs dX + dW (2x forward)

Reference step being modeled: train.py:344-356 (noise -> forward ->
CE on logits[:, K-1:-1] -> backward -> AdamW), with `--only_prefix`
freezing GPT-2 (train.py:276-284).
"""
from __future__ import annotations

from ..models import caption_model


def gpt2_block_matmul_flops(d: int, n_pos: int) -> float:
    """Forward matmul FLOPs of ONE GPT-2 block for ONE token at causal
    position average: qkv (2*d*3d) + attn out (2*d*d) + mlp up/down
    (2*d*4d * 2) + score/value matmuls (2 * 2*d*avg_span)."""
    dense = 2 * d * 3 * d + 2 * d * d + 2 * (2 * d * 4 * d)
    attn = 2 * (2 * d * (n_pos + 1) / 2)
    return dense + attn


def mapper_transformer_block_flops(d: int, n_pos: int,
                                   mlp_ratio: float) -> float:
    """Forward matmul FLOPs of one mapper transformer layer per token:
    to_queries (2d^2) + to_keys_values (4d^2) + project (2d^2) +
    fc1/fc2 (2 * 2*ratio*d^2) + attention (bidirectional: full span)."""
    dense = 2 * d * d + 2 * d * 2 * d + 2 * d * d + 2 * (2 * mlp_ratio * d * d)
    attn = 2 * (2 * d * n_pos)
    return dense + attn


def train_step_matmul_flops(cfg: caption_model.CaptionModelConfig,
                            batch: int, n_tokens: int) -> float:
    """Total fwd+bwd matmul FLOPs of one train step at `batch` with
    `n_tokens` caption tokens (sequence = prefix_length + n_tokens)."""
    g = cfg.gpt2
    m = cfg.mapper
    S = cfg.prefix_length + n_tokens

    # GPT-2 trunk: forward, and backward dX even when frozen (the loss
    # gradient must reach the mapper through every layer). dW matmuls
    # are added only when GPT-2 trains. Attention backward needs both
    # dQ/dK (from scores) and dV/dprobs — 2x the forward attn matmuls.
    blk = gpt2_block_matmul_flops(g.n_embd, S)
    gpt_fwd = batch * S * g.n_layer * blk
    gpt_bwd = gpt_fwd * (1.0 if cfg.only_prefix else 2.0) \
        + batch * S * g.n_layer * 2 * (2 * g.n_embd * (S + 1) / 2)

    # LM head on the loss slice only (logits[:, K-1:-1] -> n_tokens
    # positions, caption_model.loss_forward): fwd + dX (wte frozen
    # under only_prefix; trained adds dW).
    head_one = 2 * g.n_embd * g.vocab_size * batch * n_tokens
    head = head_one * (2.0 if cfg.only_prefix else 3.0)

    # Mapper (always trained): fwd + dX + dW = 3x forward.
    if m.canonical_type() == "transformer":
        mp_pos = m.clip_length + m.prefix_length
        mblk = mapper_transformer_block_flops(m.dim_embedding, mp_pos,
                                              m.mlp_ratio)
        mapper_fwd = batch * mp_pos * m.num_layers * mblk \
            + 2 * m.dim_clip * m.clip_length * m.dim_embedding * batch
    elif m.canonical_type() in ("mlp", "mapping_network"):
        # the JAX package counts mapping_network with the mlp formula too
        h = m.dim_embedding * m.prefix_length
        mapper_fwd = 2 * batch * (m.dim_clip * h // 2 + (h // 2) * h)
    else:  # transformer_decoder: encoder over clip_length at dim_ref +
        # interleaved cross/self decoder over prefix_length
        dr = m.enc_dec_dim_ref
        enc = batch * m.clip_length * m.num_layers * \
            mapper_transformer_block_flops(dr, m.clip_length, m.mlp_ratio)
        dec = batch * m.prefix_length * 2 * m.num_layers * \
            mapper_transformer_block_flops(
                m.dim_embedding, m.clip_length + m.prefix_length, m.mlp_ratio)
        mapper_fwd = enc + dec + 2 * m.dim_clip * m.clip_length * dr * batch
    mapper = 3.0 * mapper_fwd

    return gpt_fwd + gpt_bwd + head + mapper

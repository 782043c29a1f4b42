"""Model matmul operations of one served caption of the MLA-MoE decoder
(beam search), counted from the architecture as the program computes
them; elementwise work, the norms, the rotary embedding and the
router's choice are left out, as MFU's convention has it. Products: 2 m
k n operations. Only the active experts count: the `num_experts_per_tok`
routed ones and the shared ones, a token.

  mapper   roofline/decode_model.py::mapper_flops at the decoder's width
  prefill  K prefix positions in the expanded form: q, kv_a, kv_b and o
           products, 2 H (p + 1) (qk + v) for causal attention at
           position p, the MLP (dense SwiGLU, or the router, the active
           experts and the shared ones); then the LM head at the last
           position (2 D V)
  steps    E - 1 decode steps of R beam rows in the absorbed form: per row
           and layer the q and kv_a products, q_nope W_UK (2 H nope r),
           2 H S (r + rope + r) over the S = K + s + 1 latent rows at step
           s, o_lat W_UV (2 H r v), o, the MLP; and the LM head 2 D V
"""
from __future__ import annotations

from typing import Dict

from benchmark.roofline.decode_model import mapper_flops


def _mlp_flops(c: Dict, layer: int) -> float:
    D = c["hidden_size"]
    if layer < c["first_k_dense_replace"]:
        return 6.0 * D * c["intermediate_size"]
    I = c["moe_intermediate_size"]
    active = c["num_experts_per_tok"] + c["n_shared_experts"]
    return 2.0 * D * c["n_routed_experts"] + 6.0 * D * I * active


def _proj_flops(c: Dict) -> float:
    """q, kv_a and o products of one token."""
    D, H = c["hidden_size"], c["num_attention_heads"]
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    lat = c["kv_lora_rank"] + c["qk_rope_head_dim"]
    return 2.0 * D * (H * qk + lat) + 2.0 * H * c["v_head_dim"] * D


def prefill_token_flops(c: Dict, keys: int) -> float:
    H, r = c["num_attention_heads"], c["kv_lora_rank"]
    nope, rope, v = c["qk_nope_head_dim"], c["qk_rope_head_dim"], \
        c["v_head_dim"]
    per = _proj_flops(c) + 2.0 * r * H * (nope + v) \
        + 2.0 * H * keys * (nope + rope + v)
    return sum(per + _mlp_flops(c, i) for i in range(c["num_hidden_layers"]))


def decode_token_flops(c: Dict, keys: int) -> float:
    H, r = c["num_attention_heads"], c["kv_lora_rank"]
    nope, rope, v = c["qk_nope_head_dim"], c["qk_rope_head_dim"], \
        c["v_head_dim"]
    per = _proj_flops(c) + 2.0 * H * nope * r + 2.0 * H * keys * (
        2 * r + rope) + 2.0 * H * r * v
    return sum(per + _mlp_flops(c, i) for i in range(c["num_hidden_layers"]))


def caption_flops(cfg: Dict, beam_size: int, entry_length: int) -> float:
    """Matmul operations of one caption decoded to `entry_length` tokens
    (every step run: random weights never stop early)."""
    c = cfg["mla_moe"]
    D, V = c["hidden_size"], c["vocab_size"]
    K = cfg["mapper"]["prefix_length"]
    head = 2.0 * D * V
    prefill = sum(prefill_token_flops(c, p + 1) for p in range(K)) + head
    steps = sum(beam_size * (decode_token_flops(c, K + s + 1) + head)
                for s in range(entry_length - 1))
    return mapper_flops(cfg["mapper"], D) + prefill + steps

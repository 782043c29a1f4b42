"""The plain reference of the Kimi-VL-A3B captioner: CapDec's mapper in
front of Kimi-VL-A3B-Instruct's text model (`text_config`: a DeepSeek-V3
block, https://huggingface.co/moonshotai/Kimi-VL-A3B-Instruct).

The decoder, as HuggingFace's `DeepseekV3ForCausalLM` computes it with
`q_lora_rank` None:
  * RMSNorm x / sqrt(mean(x^2) + eps) * w (eps `rms_norm_eps`, 1e-6 for
    `kv_a_layernorm`, HF's default there);
  * multi-head latent attention in the expanded form: q = h W_q, per head
    [q_nope | q_pe]; [c_kv | k_pe] = h W_kva; c = rmsnorm(c_kv);
    [k_nope | v] = c W_kvb per head; RoPE (theta `rope_theta`, no scaling)
    on q_pe and on k_pe, which every head shares; causal softmax of
    (q_nope . k_nope + q_pe . k_pe) / sqrt(qk_nope + qk_rope); the heads'
    values through W_o;
  * SwiGLU MLPs (silu(h W_g) * (h W_u)) W_d: dense for the first
    `first_k_dense_replace` layers, then `n_routed_experts` experts a
    layer with `n_shared_experts` shared ones (one SwiGLU of their summed
    width): sigmoid scores of h W_gate, the `num_experts_per_tok` largest
    of score + e_score_correction_bias chosen (`noaux_tc` with one group),
    the chosen experts' unbiased scores divided by their sum (+1e-20,
    `norm_topk_prob`) and times `routed_scaling_factor`; each chosen
    expert's SwiGLU by a plain loop over the experts;
  * a final RMSNorm and the untied LM head.
The mapper is CapDec's TransformerMapper at the decoder's width
(reference/model.py::map_prefix).

Departures from the published description: RoPE is the rotate-half form
on the rope dims, where HF's DeepSeek-V3 code first de-interleaves the
pairs (a fixed permutation of the rope rows of q_proj and
kv_a_proj_with_mqa, which random weights do not tell apart); each
layer's experts are stacked tensors, `mlp.experts.gate_up_proj` [E, 2 I,
D] (the gate's rows first) and `mlp.experts.down_proj` [E, D, I], where
the published checkpoint holds `mlp.experts.<e>.{gate,up,down}_proj`;
the shared experts are one SwiGLU `mlp.shared_experts.*` as published.
MoonViT and its projector are left out: CapDec's mapper stands in front.

Products run in float32 with TF32 off, taking each layer's weights from
the state dict (bf16 in the benchmark's cell) as float32 copies one layer
at a time, so that a 16B bf16 state dict never becomes a float32 copy;
`Precision("fp8")` (reference/model.py) rounds both operands of every
product to float8 e4m3 first. `beam_search` keeps each layer's latent
rows of the positions before (the same numbers a full forward recomputes).
Nothing here imports the program under test.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from benchmark.reference import model as _ref

Tensor = torch.Tensor
Precision = _ref.Precision
F32 = _ref.F32
disable_tf32 = _ref.disable_tf32


def _cfg(model_cfg: Dict) -> Dict:
    return model_cfg["mla_moe"]


def layout(model_cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(key, shape, init) of every tensor, in a fixed order (the kinds of
    benchmark/weights.py: the configuration's `weights` scales, `one`,
    `zero` and the mapper's)."""
    c = _cfg(model_cfg)
    D, V, L = c["hidden_size"], c["vocab_size"], c["num_hidden_layers"]
    H, nope, rope = (c["num_attention_heads"], c["qk_nope_head_dim"],
                     c["qk_rope_head_dim"])
    r, vd = c["kv_lora_rank"], c["v_head_dim"]
    E, I = c["n_routed_experts"], c["moe_intermediate_size"]
    S = I * c["n_shared_experts"]
    out = [("gpt.model.embed_tokens.weight", (V, D), "embed")]
    for i in range(L):
        b = f"gpt.model.layers.{i}."
        out += [(b + "input_layernorm.weight", (D,), "one"),
                (b + "self_attn.q_proj.weight", (H * (nope + rope), D),
                 "attn_in"),
                (b + "self_attn.kv_a_proj_with_mqa.weight", (r + rope, D),
                 "attn_in"),
                (b + "self_attn.kv_a_layernorm.weight", (r,), "one"),
                (b + "self_attn.kv_b_proj.weight", (H * (nope + vd), r),
                 "kv_b"),
                (b + "self_attn.o_proj.weight", (D, H * vd), "attn_out"),
                (b + "post_attention_layernorm.weight", (D,), "one")]
        if i < c["first_k_dense_replace"]:
            W = c["intermediate_size"]
            out += [(b + "mlp.gate_proj.weight", (W, D), "mlp_in"),
                    (b + "mlp.up_proj.weight", (W, D), "mlp_in"),
                    (b + "mlp.down_proj.weight", (D, W), "mlp_out")]
        else:
            out += [(b + "mlp.gate.weight", (E, D), "router"),
                    (b + "mlp.gate.e_score_correction_bias", (E,),
                     "router_bias"),
                    (b + "mlp.experts.gate_up_proj", (E, 2 * I, D),
                     "expert_in"),
                    (b + "mlp.experts.down_proj", (E, D, I), "expert_out"),
                    (b + "mlp.shared_experts.gate_proj.weight", (S, D),
                     "mlp_in"),
                    (b + "mlp.shared_experts.up_proj.weight", (S, D),
                     "mlp_in"),
                    (b + "mlp.shared_experts.down_proj.weight", (D, S),
                     "mlp_out")]
    out += [("gpt.model.norm.weight", (D,), "one"),
            ("gpt.lm_head.weight", (V, D), "head")]
    return out + _ref.mapper_layout(model_cfg["mapper"], D)


def _w(sd: Dict[str, Tensor], key: str) -> Tensor:
    """A weight as float32 (a copy of a bf16 tensor, the tensor itself in
    f32)."""
    return sd[key].float()


def _rms(x: Tensor, w: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _linear(x: Tensor, w: Tensor, p: Precision) -> Tensor:
    return p.matmul(x, w.t())


def _rope(x: Tensor, pos: Tensor, dim: int, theta: float) -> Tensor:
    """Rotate-half RoPE of x [..., T, dim] at positions pos [T]."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=x.device) / dim))
    ang = pos.float()[:, None] * inv[None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    h = dim // 2
    x1, x2 = x[..., :h], x[..., h:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _swiglu(x: Tensor, wg: Tensor, wu: Tensor, wd: Tensor,
            p: Precision) -> Tensor:
    return _linear(torch.nn.functional.silu(_linear(x, wg, p))
                   * _linear(x, wu, p), wd, p)


def route(c: Dict, logits: Tensor, bias: Tensor) -> Tuple[Tensor, Tensor]:
    """The published routing of f32 router logits [T, E]: (chosen experts
    [T, k], their weights [T, k]) — chosen by score + bias, weighted by
    the unbiased score, normalised and scaled."""
    s = torch.sigmoid(logits)
    idx = torch.topk(s + bias, c["num_experts_per_tok"], dim=-1).indices
    w = s.gather(-1, idx)
    if c["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * c["routed_scaling_factor"]


def _moe(c: Dict, sd: Dict[str, Tensor], b: str, h: Tensor,
         p: Precision) -> Tensor:
    """The routed and shared experts of layer prefix b on h [T, D]."""
    E, I = c["n_routed_experts"], c["moe_intermediate_size"]
    idx, w = route(c, _linear(h, _w(sd, b + "mlp.gate.weight"), p),
                   _w(sd, b + "mlp.gate.e_score_correction_bias"))
    out = _swiglu(h, _w(sd, b + "mlp.shared_experts.gate_proj.weight"),
                  _w(sd, b + "mlp.shared_experts.up_proj.weight"),
                  _w(sd, b + "mlp.shared_experts.down_proj.weight"), p)
    gu = _w(sd, b + "mlp.experts.gate_up_proj")
    dn = _w(sd, b + "mlp.experts.down_proj")
    flat = idx.reshape(-1)
    order = torch.argsort(flat)
    counts = torch.bincount(flat, minlength=E).tolist()
    start = 0
    for e in range(E):
        pairs = order[start:start + counts[e]]
        start += counts[e]
        if not len(pairs):
            continue
        tok, j = pairs // idx.shape[1], pairs % idx.shape[1]
        y = _swiglu(h[tok], gu[e, :I], gu[e, I:], dn[e], p)
        out.index_add_(0, tok, y * w[tok, j][:, None])
    return out


def hidden(sd: Dict[str, Tensor], model_cfg: Dict, embeds: Tensor,
           p: Precision = F32, past: Optional[List[Tensor]] = None) -> Tensor:
    """The decoder over input embeddings [B, T, D], causal, at positions
    P .. P + T - 1: the final-normed hidden states [B, T, D].

    With `past` (a list of each layer's latent rows [B, P, r + rope] of
    the positions before: normed c_kv and rotated k_pe, empty at the
    start) the attention reads those too, and each layer's entry gains
    the new rows."""
    c = _cfg(model_cfg)
    B, T, D = embeds.shape
    H, nope, rope = (c["num_attention_heads"], c["qk_nope_head_dim"],
                     c["qk_rope_head_dim"])
    r, vd, eps = c["kv_lora_rank"], c["v_head_dim"], c["rms_norm_eps"]
    P = past[0].shape[1] if past else 0
    pos = torch.arange(P, P + T, device=embeds.device)
    allowed = torch.ones(T, P + T, dtype=torch.bool,
                         device=embeds.device).tril(P)
    scale = 1.0 / math.sqrt(nope + rope)
    x = embeds.float()
    for i in range(c["num_hidden_layers"]):
        b = f"gpt.model.layers.{i}."
        h = _rms(x, _w(sd, b + "input_layernorm.weight"), eps)
        q = _linear(h, _w(sd, b + "self_attn.q_proj.weight"), p).view(
            B, T, H, nope + rope)
        kva = _linear(h, _w(sd, b + "self_attn.kv_a_proj_with_mqa.weight"), p)
        lat = torch.cat(
            [_rms(kva[..., :r], _w(sd, b + "self_attn.kv_a_layernorm.weight"),
                  1e-6),
             _rope(kva[..., r:], pos, rope, c["rope_theta"])], -1)
        if past is not None:
            if i < len(past):
                lat = torch.cat([past[i], lat], 1)
                past[i] = lat
            else:
                past.append(lat)
        S = lat.shape[1]
        kv = _linear(lat[..., :r], _w(sd, b + "self_attn.kv_b_proj.weight"),
                     p).view(B, S, H, nope + vd)
        qq = torch.cat([q[..., :nope],
                        _rope(q[..., nope:].transpose(1, 2), pos, rope,
                              c["rope_theta"]).transpose(1, 2)], -1)
        kk = torch.cat([kv[..., :nope],
                        lat[:, :, None, r:].expand(B, S, H, rope)], -1)
        qq, kk, vv = (t.transpose(1, 2) for t in (qq, kk, kv[..., nope:]))
        s = p.matmul(qq, kk.transpose(-1, -2)) * scale
        s = s.masked_fill(~allowed, float("-inf"))
        o = p.matmul(torch.softmax(s, -1), vv).transpose(1, 2).reshape(
            B, T, H * vd)
        x = x + _linear(o, _w(sd, b + "self_attn.o_proj.weight"), p)
        h = _rms(x, _w(sd, b + "post_attention_layernorm.weight"), eps)
        if i < c["first_k_dense_replace"]:
            x = x + _swiglu(h, _w(sd, b + "mlp.gate_proj.weight"),
                            _w(sd, b + "mlp.up_proj.weight"),
                            _w(sd, b + "mlp.down_proj.weight"), p)
        else:
            x = x + _moe(c, sd, b, h.reshape(B * T, D), p).view(B, T, D)
    return _rms(x, _w(sd, "gpt.model.norm.weight"), eps)


def logits(sd: Dict[str, Tensor], h: Tensor, p: Precision = F32) -> Tensor:
    """The untied LM head: h [.., D] -> [.., V]."""
    return p.matmul(h, _w(sd, "gpt.lm_head.weight").t())


def _embed(sd: Dict[str, Tensor], tokens: Tensor) -> Tensor:
    return sd["gpt.model.embed_tokens.weight"][tokens].float()


def _prefix(sd, model_cfg, clip_embeds, p):
    """The mapper's prefix of the embeddings as the client sent them (the
    serving path L2-normalises them), with the mapper in float32."""
    m = {k: v.float() for k, v in sd.items() if k.startswith("clip_project.")}
    return _ref.map_prefix(m, model_cfg, _ref.l2_normalize(clip_embeds), p)


def caption_logits(sd: Dict[str, Tensor], model_cfg: Dict, clip_embeds: Tensor,
                   tokens: Tensor, p: Precision = F32) -> Tensor:
    """Teacher-forced next-token logits [B, T, V] of served captions
    tokens [B, T]: row t scores token t given the prefix and tokens < t."""
    K = model_cfg["mapper"]["prefix_length"]
    prefix = _prefix(sd, model_cfg, clip_embeds, p)
    h = hidden(sd, model_cfg, torch.cat([prefix, _embed(sd, tokens)], 1), p)
    return logits(sd, h[:, K - 1:K - 1 + tokens.shape[1]], p)


@torch.no_grad()
def beam_search(sd: Dict[str, Tensor], model_cfg: Dict, clip_embeds: Tensor,
                beam_size: int, entry_length: int, stop_token: int,
                p: Precision = F32) -> Tuple[List[List[int]], Tensor]:
    """ClipCap's `generate_beam` over the images of clip_embeds [N, C], as
    reference/model.py::beam_search, with this decoder: each image's best
    caption and its length-normalised score [N]."""
    N, R = clip_embeds.shape[0], beam_size
    past: List[Tensor] = []
    h = hidden(sd, model_cfg, _prefix(sd, model_cfg, clip_embeds, p), p,
               past)
    logp = torch.log_softmax(logits(sd, h[:, -1], p), -1)
    V = logp.shape[-1]
    scores, tok = logp.topk(R, -1)                          # [N, R]
    tokens = tok[..., None]
    past[:] = [t.repeat_interleave(R, 0) for t in past]
    dev = clip_embeds.device
    lengths = torch.ones(N, R, device=dev)
    stopped = tok == stop_token
    base = torch.arange(N, device=dev)[:, None] * R
    for _ in range(1, entry_length):
        if bool(stopped.all()):
            break
        h = hidden(sd, model_cfg, _embed(sd, tok.reshape(N * R, 1)), p, past)
        logp = torch.log_softmax(logits(sd, h[:, -1], p), -1).reshape(N, R, V)
        logp = logp.masked_fill(stopped[..., None], -math.inf)
        logp[..., 0] = torch.where(stopped, 0.0, logp[..., 0])
        lengths = lengths + (~stopped).float()
        avg, idx = ((scores[..., None] + logp) / lengths[..., None]
                    ).reshape(N, R * V).topk(R, -1)
        src, tok = idx // V, idx % V
        lengths, stopped = lengths.gather(1, src), stopped.gather(1, src)
        tokens = torch.cat([tokens.gather(1, src[..., None].expand_as(tokens)),
                            tok[..., None]], 2)
        rows = (base + src).reshape(-1)
        past[:] = [t[rows] for t in past]
        scores = avg * lengths
        stopped = stopped | (tok == stop_token)
    final = scores / lengths
    best = final.argmax(1)
    caps = [tokens[n, best[n], :int(lengths[n, best[n]])].tolist()
            for n in range(N)]
    return caps, final.gather(1, best[:, None])[:, 0]

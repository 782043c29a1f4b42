"""A DeepSeek-V3-style decoder (the text model of Kimi-VL-A3B) behind
CapDec's mapper: multi-head latent attention (MLA), RMSNorm, RoPE, a
leading dense SwiGLU layer and then layers of routed experts with shared
ones, and an untied LM head.

Block (HuggingFace `DeepseekV3DecoderLayer`, `q_lora_rank` None):
    h = rmsnorm(x);  q = h W_q  (H heads of [q_nope | q_pe]);
    [c_kv | k_pe] = h W_kva;  c = rmsnorm(c_kv) (eps 1e-6);
    [k_nope | v] = c W_kvb  (per head);  RoPE on q_pe and k_pe (shared by
    the heads);  x += softmax((q_nope.k_nope + q_pe.k_pe) / sqrt(192)) v W_o
    h = rmsnorm(x);  x += mlp(h)
where mlp is SwiGLU (dense, layers < first_k_dense_replace) or the
routed experts: sigmoid scores, the top k of score +
e_score_correction_bias chosen, their unbiased scores normalised and
scaled by routed_scaling_factor, each chosen expert's SwiGLU weighted
by its score, plus the shared experts' SwiGLU.

Departures from the published layout (which the benchmark's reference,
benchmark/reference/mla_moe.py, shares): RoPE is the rotate-half form
on the 64 rope dims (HF's code first de-interleaves the pairs, a fixed
permutation of the rope rows of q_proj and kv_a_proj_with_mqa), and each
layer's experts are stacked: `mlp.experts.gate_up_proj` [E, 2 I, D] (gate
rows first) and `mlp.experts.down_proj` [E, D, I].

Serving holds the weights as given (bf16 for the benchmark's cell:
`params_from_torch_state_dict` assigns the state dict's tensors, no
copy) and runs the residual stream in f32, the products in the compute
dtype and the norms, softmax and router scores in f32. Prefill runs the
expanded attention over the prefix and leaves the latent rows [c (512) |
k_pe (64)] of every layer in the prefix cache [L, N, K, 576]; a decode
step attends in the absorbed form through the latent cache (K16,
ops/mla_attention.py; the generated cache [B, L, E, 576] is row-major,
written by K3 and forked by K4 as one tensor under "k"), with the
routed experts sorted by expert and multiplied by one grouped product a
projection (ops/moe.py). The beam engine reaches this module through
models/decoders.py; greedy/top-p decoding, int8 caches, the seq-major
cache, ancestry, a tp mesh and training are GPT-2's alone and raise here.

Spans (utils/profiling.py): `mla.attention` around K16's call, and
`moe.route`, `moe.dispatch`, `moe.experts`, `moe.combine` in each routed
layer, timed on the device (a decode step's carry its `step`). Counter:
the prefix cache's "expert_rows" int32 [routed layers, E], the rows each
expert took over the batch's decode steps.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..ops import cache_reorder, mla_attention, moe, rmsnorm
from ..utils import profiling

Cache = Dict[str, torch.Tensor]
# What decode_step counts on the device, read from the prefix cache by
# the beam engine's caller (CaptionServer.stats).
DECODE_COUNTERS = ("expert_rows",)


@dataclasses.dataclass(frozen=True)
class MLAMoEConfig:
    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264        # the dense layers' SwiGLU
    moe_intermediate_size: int = 1408     # an expert's SwiGLU
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_shared_experts: int = 2
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-5
    kv_norm_eps: float = 1e-6             # kv_a_layernorm's (HF default)
    rope_theta: float = 800000.0
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    rope_positions: int = 256             # rows of the rotary tables
    compute_dtype: torch.dtype = torch.float32

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        return self.kv_lora_rank + self.qk_rope_head_dim

    # the names GPT2Config gives the mapper's width and the depth
    @property
    def n_embd(self) -> int:
        return self.hidden_size

    @property
    def n_layer(self) -> int:
        return self.num_hidden_layers

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_k_dense_replace


class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))


class Attention(nn.Module):
    def __init__(self, c: MLAMoEConfig):
        super().__init__()
        H, D = c.num_attention_heads, c.hidden_size
        self.q_proj = nn.Linear(D, H * c.qk_head_dim, bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(D, c.latent_dim, bias=False)
        self.kv_a_layernorm = RMSNorm(c.kv_lora_rank)
        self.kv_b_proj = nn.Linear(
            c.kv_lora_rank, H * (c.qk_nope_head_dim + c.v_head_dim),
            bias=False)
        self.o_proj = nn.Linear(H * c.v_head_dim, D, bias=False)


class MLP(nn.Module):
    def __init__(self, D: int, I: int):
        super().__init__()
        self.gate_proj = nn.Linear(D, I, bias=False)
        self.up_proj = nn.Linear(D, I, bias=False)
        self.down_proj = nn.Linear(I, D, bias=False)


class Gate(nn.Module):
    def __init__(self, E: int, D: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(E, D))
        self.e_score_correction_bias = nn.Parameter(torch.zeros(E))


class Experts(nn.Module):
    """E stacked SwiGLU experts: gate_up_proj [E, 2 I, D] (the gate's I rows
    first), down_proj [E, D, I]."""

    def __init__(self, E: int, D: int, I: int):
        super().__init__()
        self.gate_up_proj = nn.Parameter(torch.empty(E, 2 * I, D))
        self.down_proj = nn.Parameter(torch.empty(E, D, I))


class MoE(nn.Module):
    def __init__(self, c: MLAMoEConfig):
        super().__init__()
        E, D, I = c.n_routed_experts, c.hidden_size, c.moe_intermediate_size
        self.gate = Gate(E, D)
        self.experts = Experts(E, D, I)
        self.shared_experts = MLP(D, I * c.n_shared_experts)


class Layer(nn.Module):
    def __init__(self, c: MLAMoEConfig, i: int):
        super().__init__()
        self.input_layernorm = RMSNorm(c.hidden_size)
        self.self_attn = Attention(c)
        self.post_attention_layernorm = RMSNorm(c.hidden_size)
        self.mlp = MoE(c) if c.is_moe(i) else \
            MLP(c.hidden_size, c.intermediate_size)


class Body(nn.Module):
    def __init__(self, c: MLAMoEConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(c.vocab_size, c.hidden_size)
        self.layers = nn.ModuleList(Layer(c, i)
                                    for i in range(c.num_hidden_layers))
        self.norm = RMSNorm(c.hidden_size)


class MLAMoEModel(nn.Module):
    """State-dict keys `model.*` and `lm_head.weight`, as HuggingFace's
    DeepseekV3ForCausalLM (experts stacked, above)."""

    def __init__(self, cfg: MLAMoEConfig, device=None):
        super().__init__()
        with torch.device(device or "cpu"):
            self.model = Body(cfg)
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                     bias=False)


def params_from_torch_state_dict(sd: Dict[str, torch.Tensor],
                                 cfg: MLAMoEConfig) -> MLAMoEModel:
    """The model holding the state dict's tensors themselves (built on the
    meta device, then assigned): no weight is copied, so a 32 GB bf16
    state dict is held once. Strict: every key, no other."""
    model = MLAMoEModel(cfg, device="meta")
    model.load_state_dict(sd, strict=True, assign=True)
    for p in model.parameters():
        p.requires_grad_(False)
    return model


# ---------------------------------------------------------------------------
# What decoding reads: f32 norms and router, rotary tables, W_UK / W_UV
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Layer:
    ln_in: torch.Tensor
    ln_post: torch.Tensor
    kv_norm: torch.Tensor
    w_uk: torch.Tensor           # [H, nope, Dl]: q_lat = q_nope W_UK[h]
    w_uv_t: torch.Tensor         # [H, Dl, v]: o_h = o_lat W_UV[h]^T
    router: Optional[torch.Tensor] = None       # f32 [E, D]
    router_bias: Optional[torch.Tensor] = None  # f32 [E]


@dataclasses.dataclass
class _Params:
    layers: List[_Layer]
    norm: torch.Tensor
    cos: torch.Tensor            # [rope_positions, Dr / 2]
    sin: torch.Tensor


def _f32(p: torch.Tensor) -> torch.Tensor:
    return p.detach().float()


def decode_params(model: MLAMoEModel, cfg: MLAMoEConfig) -> _Params:
    """The model's f32 norms, router and rotary tables and its W_UK / W_UV
    views, made once and kept on the model."""
    p = model.__dict__.get("_decode_params")
    if p is not None:
        return p
    H, nope, v = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    layers = []
    for i, lay in enumerate(model.model.layers):
        a = lay.self_attn
        kvb = a.kv_b_proj.weight.detach().view(H, nope + v, cfg.kv_lora_rank)
        entry = _Layer(_f32(lay.input_layernorm.weight),
                       _f32(lay.post_attention_layernorm.weight),
                       _f32(a.kv_a_layernorm.weight), kvb[:, :nope],
                       kvb[:, nope:].transpose(1, 2))
        if cfg.is_moe(i):
            entry.router = _f32(lay.mlp.gate.weight)
            entry.router_bias = _f32(lay.mlp.gate.e_score_correction_bias)
        layers.append(entry)
    dev = model.lm_head.weight.device
    cos, sin = mla_attention.rope_tables(cfg.rope_positions,
                                         cfg.qk_rope_head_dim,
                                         cfg.rope_theta, dev)
    p = _Params(layers, _f32(model.model.norm.weight), cos, sin)
    model.__dict__["_decode_params"] = p
    return p


def cast_params_for_decode(model: MLAMoEModel, cfg: MLAMoEConfig
                           ) -> MLAMoEModel:
    """The model with its matrices in the compute dtype: itself when they
    are already (the served bf16 weights are never copied), else a copy
    cast so (the small models of tests)."""
    cdt = cfg.compute_dtype
    if any(p.dim() > 1 and p.dtype != cdt for p in model.parameters()):
        src = model
        model = MLAMoEModel(cfg, device="meta")
        model.load_state_dict(
            {k: t.detach().to(cdt) if t.dim() > 1 else t.detach().float()
             for k, t in src.state_dict().items()}, strict=True, assign=True)
    decode_params(model, cfg)
    return model


def lm_head_weight(model: MLAMoEModel) -> torch.Tensor:
    """K1's weights: the untied head [V, D]."""
    return model.lm_head.weight


def kv_width(model: MLAMoEModel) -> int:
    """The width of a cache row: the latent, kv_lora_rank + rope dims."""
    return model.model.layers[0].self_attn.kv_a_proj_with_mqa.weight.shape[0]


def embed_tokens(model: MLAMoEModel, tokens: torch.Tensor) -> torch.Tensor:
    return model.model.embed_tokens.weight[tokens]


def init_gen_cache_rowmajor(cfg: MLAMoEConfig, batch: int, max_new: int,
                            dtype: Optional[torch.dtype] = None, device=None,
                            width: Optional[int] = None) -> Cache:
    """The row-major latent cache [B, L, E, kv_lora_rank + rope] as one
    tensor under "k": a fork copy moves a row's (row, layer) slot ranges."""
    shape = (batch, cfg.num_hidden_layers, max_new, width or cfg.latent_dim)
    return {"k": torch.zeros(shape, dtype=dtype or cfg.compute_dtype,
                             device=device)}


def _refuse(what: str):
    raise NotImplementedError(f"the MLA-MoE decoder (models/mla_moe.py) "
                              f"does not take {what}")


# ---------------------------------------------------------------------------
# The blocks
# ---------------------------------------------------------------------------

def _norm(x, y, w, eps, cdt, kernels, assign=False, out=None):
    """x += y (x = y with assign), then rmsnorm(x) * w in cdt: the kernel
    where it takes y, else its plain version."""
    if kernels and x.is_cuda and y.dtype == torch.bfloat16:
        return rmsnorm.residual_rmsnorm(x, y, w, eps, cdt, assign, out)
    return rmsnorm.residual_rmsnorm_plain(x, y, w, eps, cdt, assign, out)


def _mm(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    return torch.mm(x, lin.weight.t())


def _mlp(h: torch.Tensor, mlp: MLP, kernels: bool) -> torch.Tensor:
    act = (moe.swiglu if kernels else moe.swiglu_plain)(
        _mm(h, mlp.gate_proj), _mm(h, mlp.up_proj))
    return _mm(act, mlp.down_proj)


def _moe(x: torch.Tensor, h: torch.Tensor, mlp: MoE, lp: _Layer,
         cfg: MLAMoEConfig, kernels: bool, counter: Optional[torch.Tensor],
         meta: Dict[str, Any]) -> torch.Tensor:
    """The routed experts of h [T, D] added into x [T, D] (f32) in place;
    returns the shared experts' output."""
    E, k = cfg.n_routed_experts, cfg.num_experts_per_tok
    ex = mlp.experts
    with profiling.span("moe.route", **meta):
        logits = torch.mm(h.float(), lp.router.t())
        idx, w = (moe.route if kernels else moe.route_plain)(
            logits, lp.router_bias, k, cfg.norm_topk_prob,
            cfg.routed_scaling_factor)
    with profiling.span("moe.dispatch", **meta):
        offs, pos, token_of = (moe.dispatch if kernels else moe.dispatch_plain)(
            idx, E, counter)
        xs = h.index_select(0, token_of)
    with profiling.span("moe.experts", **meta):
        ys = moe.expert_products(xs, ex.gate_up_proj, ex.down_proj, offs,
                                 kernels)
    with profiling.span("moe.combine", **meta):
        (moe.combine if kernels else moe.combine_plain)(x, ys, pos, w)
    return _mlp(h, mlp.shared_experts, kernels)


def _mlp_block(x, h, layer: Layer, i: int, lp: _Layer, cfg: MLAMoEConfig,
               kernels: bool, counters: Optional[torch.Tensor],
               meta: Dict[str, Any]) -> torch.Tensor:
    """The layer's MLP on h: the dense SwiGLU's output, or the routed
    experts added into x and the shared experts' output."""
    if not cfg.is_moe(i):
        return _mlp(h, layer.mlp, kernels)
    row = None if counters is None else \
        counters[i - cfg.first_k_dense_replace]
    return _moe(x, h, layer.mlp, lp, cfg, kernels, row, meta)


def _latent(kv_a: torch.Tensor, lp: _Layer, cfg: MLAMoEConfig,
            cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Latent rows [T, Dl + Dr] in the compute dtype from the kv_a product
    (f32 norm and rotation), cos/sin broadcasting over T."""
    Dl = cfg.kv_lora_rank
    c = kv_a[:, :Dl].float()
    c = c * torch.rsqrt(c.pow(2).mean(-1, keepdim=True) + cfg.kv_norm_eps) \
        * lp.kv_norm
    return torch.cat([c, mla_attention.rotate(kv_a[:, Dl:].float(), cos, sin)],
                     -1).to(kv_a.dtype)


@torch.no_grad()
def prefill(model: MLAMoEModel, cfg: MLAMoEConfig,
            inputs_embeds: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """Run the prefix [N, K, D] once at positions 0..K-1 (expanded
    attention, causal); return (last-position logits [N, V] f32, the
    prefix cache {"k": latent rows [L, N, K, Dl + Dr], "expert_rows":
    int32 zeros [routed layers, E]}). On the card in bf16 the norms, the
    experts' glue and the grouped products run by their kernels, else by
    their plain versions."""
    N, K, D = inputs_embeds.shape
    cdt = cfg.compute_dtype
    kernels = inputs_embeds.is_cuda and cdt == torch.bfloat16
    p = decode_params(model, cfg)
    H, nope, v = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    Dr, eps = cfg.qk_rope_head_dim, cfg.rms_norm_eps
    T = N * K
    cos, sin = p.cos[:K].repeat(N, 1), p.sin[:K].repeat(N, 1)    # [T, Dr/2]
    x = inputs_embeds.reshape(T, D).float().clone()
    h = (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)
         * p.layers[0].ln_in).to(cdt)
    layers = list(model.model.layers)
    lat = torch.empty(len(layers), N, K, cfg.latent_dim, dtype=cdt,
                      device=x.device)
    causal = torch.ones(K, K, dtype=torch.bool, device=x.device).tril()
    scale = mla_attention.softmax_scale(cfg.qk_head_dim)
    for i, (layer, lp) in enumerate(zip(layers, p.layers)):
        a = layer.self_attn
        q = _mm(h, a.q_proj).view(T, H, cfg.qk_head_dim)
        row = _latent(_mm(h, a.kv_a_proj_with_mqa), lp, cfg, cos, sin)
        lat[i] = row.view(N, K, -1)
        kv = _mm(row[:, :cfg.kv_lora_rank], a.kv_b_proj).view(T, H, nope + v)
        q_pe = mla_attention.rotate(q[..., nope:].float(), cos[:, None],
                                    sin[:, None]).to(cdt)
        qq = torch.cat([q[..., :nope], q_pe], -1)
        kk = torch.cat([kv[..., :nope],
                        row[:, None, cfg.kv_lora_rank:].expand(T, H, Dr)], -1)
        qq, kk, vv = (t.reshape(N, K, H, -1).transpose(1, 2)
                      for t in (qq, kk, kv[..., nope:]))
        s = torch.matmul(qq, kk.transpose(-1, -2)).float() * scale
        s = s.masked_fill(~causal, float("-inf"))
        o = torch.matmul(torch.softmax(s, -1).to(cdt), vv)
        o = o.transpose(1, 2).reshape(T, H * v)
        h = _norm(x, _mm(o, a.o_proj), lp.ln_post, eps, cdt, kernels)
        y = _mlp_block(x, h, layer, i, lp, cfg, kernels, None, {})
        nxt = p.layers[i + 1].ln_in if i + 1 < len(layers) else p.norm
        h = _norm(x, y, nxt, eps, cdt, kernels)
    last = h.view(N, K, D)[:, -1]
    logits = torch.matmul(last, model.lm_head.weight.t()).float()
    n_moe = cfg.num_hidden_layers - cfg.first_k_dense_replace
    return logits, {"k": lat,
                    "expert_rows": torch.zeros(n_moe, cfg.n_routed_experts,
                                               dtype=torch.int32,
                                               device=x.device)}


@torch.no_grad()
def decode_step(model: MLAMoEModel, cfg: MLAMoEConfig,
                token_embed: torch.Tensor, prefix_cache: Cache,
                gen_cache: Cache, step: int, *,
                e_cap: Optional[int] = None,
                fused_attention: bool = True,
                chunk_slot_write: bool = True,
                fused_slot_chunks: int = 0,
                rowmajor: bool = True,
                slot_write_kernel: bool = False,
                anc_rows: Optional[torch.Tensor] = None,
                return_hidden: bool = True,
                fused_epilogues: bool = True) -> torch.Tensor:
    """One decode step of B = N x R beam rows at generated position `step`
    (position K + step): attends over the prefix latent, the row's latent
    slots < step and the step's own, and writes each layer's latent row
    into slot `step` of the row-major cache gen_cache["k"] [B, L, E, C] IN
    PLACE (K3, or the plain write). Returns the final-normed hidden state
    [B, D] in the compute dtype (K1's input), or with
    `return_hidden=False` the f32 logits [B, V]. `fused_attention` runs
    K16 (else its plain version), `chunk_slot_write` / `slot_write_kernel`
    K3 / K14's route, and `fused_epilogues` the norms, the latent's entry,
    the router, the expert sort, the grouped products, the SwiGLU and the
    combine by their kernels (else the plain versions and the per-expert
    loop). The routed layers add their rows per expert into
    prefix_cache["expert_rows"]. The seq-major cache, ancestry, the
    slot-bounded kernels and int8 caches raise."""
    if not rowmajor:
        _refuse("the seq-major cache")
    if anc_rows is not None:
        _refuse("ancestry attention")
    if fused_slot_chunks:
        _refuse("the slot-bounded kernels (fused_slot_chunks)")
    if "ks" in gen_cache or "ks" in prefix_cache or "v" in gen_cache:
        _refuse("an int8 or K/V cache")
    B = token_embed.shape[0]
    pk, gk = prefix_cache["k"], gen_cache["k"]
    L, N, K, C = pk.shape
    R = B // N
    cdt = cfg.compute_dtype
    kernels = fused_epilogues
    p = decode_params(model, cfg)
    H, nope = cfg.num_attention_heads, cfg.qk_nope_head_dim
    eps, pos = cfg.rms_norm_eps, K + step
    cos, sin = p.cos[pos], p.sin[pos]
    scale = mla_attention.softmax_scale(cfg.qk_head_dim)
    attend = mla_attention.mla_decode_attention if fused_attention \
        else mla_attention.mla_decode_attention_plain
    prep = mla_attention.mla_prep if kernels else mla_attention.mla_prep_plain
    counters = prefix_cache.get("expert_rows")
    meta = {"step": step}
    x = torch.empty(B, cfg.hidden_size, dtype=torch.float32,
                    device=token_embed.device)
    h = _norm(x, token_embed, p.layers[0].ln_in, eps, cdt, kernels,
              assign=True)
    lats = torch.empty(L, B, C, dtype=cdt, device=x.device)
    layers = list(model.model.layers)
    for i, (layer, lp) in enumerate(zip(layers, p.layers)):
        a = layer.self_attn
        q = _mm(h, a.q_proj)                                # [B, H qk]
        prep(q, _mm(h, a.kv_a_proj_with_mqa), lp.kv_norm, cos, sin,
             cfg.kv_norm_eps, cfg.qk_head_dim, out=lats[i])
        qv = q.view(B, H, cfg.qk_head_dim)
        q_lat = torch.bmm(qv[..., :nope].transpose(0, 1), lp.w_uk)
        with profiling.span("mla.attention", **meta):
            o_lat = attend(q_lat, qv[..., nope:], lats[i], pk, gk, step, i,
                           beams_per_image=R, scale=scale)
        o = torch.bmm(o_lat, lp.w_uv_t).transpose(0, 1).reshape(B, -1)
        h = _norm(x, _mm(o, a.o_proj), lp.ln_post, eps, cdt, kernels)
        y = _mlp_block(x, h, layer, i, lp, cfg, kernels, counters, meta)
        nxt = p.layers[i + 1].ln_in if i + 1 < len(layers) else p.norm
        h = _norm(x, y, nxt, eps, cdt, kernels)
    cr = cache_reorder
    if chunk_slot_write:
        cr.write_gen_slot_chunk(gk, None, lats.unbind(0), None, step)
    elif slot_write_kernel:
        cr.write_gen_slot(gk, None, lats.unbind(0), None, step)
    else:
        cr.write_gen_slot_chunk_plain(gk, None, lats.unbind(0), None, step)
    if return_hidden:
        return h
    return torch.matmul(h, model.lm_head.weight.t()).float()

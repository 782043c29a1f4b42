"""GPT-2 decoder-only language model in PyTorch (port of capdec_tpu/models/gpt2.py).

The module tree and parameter names are HuggingFace's `GPT2LMHeadModel`
(`transformer.wte`, `transformer.h.{i}.attn.c_attn`, ... , tied
`lm_head`), so a reference CapDec checkpoint's `gpt.*` keys load with
`load_state_dict(strict=True)`. Attention/MLP weights are HF Conv1D
matrices stored [in, out].

The compute follows the JAX reference: matrix products run in
`GPT2Config.compute_dtype` (bfloat16 on the card) and are read back in
float32 before the bias add; layernorm statistics and softmaxes stay in
float32. `forward_hidden` / `forward` run the full sequence with
gradients (training; the JAX `forward_hidden`, gpt2.py:238-295), through
the block `prefill` shares. Two functions carry the beam-decode path:

  * `prefill` runs the [N, K, D] prefix once and returns the last
    position's logits plus the per-image prefix cache {k, v: [L, N, K, D]}.
  * `decode_step` is the JAX `decode_step`: per layer ln_1 -> QKV ->
    decode attention (ops/decode_attention.py) -> c_proj -> ln_2 -> MLP,
    then one slot write of the step's K/V for all layers
    (ops/cache_reorder.py), in place. Its blocks run `_decode_block`: the
    products by `torch.mm` in the compute dtype, the work between them
    as the fused epilogues of ops/epilogue.py (bias adds, casts, GELU,
    residual sums, layernorms), which round where `_block` rounds. The
    beam engine's row-major cache [B, L, E, D] takes kernel K2 and the
    slot write K3 (or K14), or the slot-bounded K8 (`fused_slot_chunks`);
    an int8 generated cache
    (`init_gen_cache_rowmajor_int8`: levels plus per-slot scales) takes
    K6 or K9 and the quantising slot write K5, and K9 also reads an int8
    prefix cache (`quantize_prefix_cache`). The seq-major cache
    [L, B, E, D] (`init_gen_cache`, `init_gen_cache_int8`; greedy, and
    the beam engine's `rowmajor_cache=False`) takes the plain attention
    math and the slot write K13 or its plain version; so does ancestry
    attention, which reads each beam's slots from the rows that hold them.

The JAX package's single-cache API is here too: `init_kv_cache` (one
fixed-shape cache [L, B, H, S_max, hd]), `reorder_kv_cache` (a row
gather) and `forward_with_cache` (prefill or decode over that cache
through the same block). No engine calls them, and no kernel runs them:
the JAX functions are XLA, not Pallas.

A tp rank's model (parallel/mesh.shard_params, Megatron) holds n_head /
tp whole heads of every block and its slice of the MLP's hidden width:
the blocks take their K/V width from their own weights (`kv_width`), the
cache constructors take it as `width`, and the two c_projs sum their
partial products over tp before the bias (parallel/tp.py). Embeddings,
layernorms and the tied head stay whole, so K1 runs at full D.
"""
from __future__ import annotations

import copy

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import cache_reorder, decode_attention, epilogue

Cache = Dict[str, torch.Tensor]

NEG_INF = -1e9  # additive mask value, as in the JAX reference


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    """Hyperparameters of the decoder. Defaults = GPT-2 base (124M)."""

    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    # dtype of matrix-product inputs; float32 params are cast for decode.
    compute_dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """GPT-2's tanh-approximate GELU (HF `gelu_new`):
    0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))), one elementwise pass."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# Modules (HF GPT2LMHeadModel names)
# ---------------------------------------------------------------------------


class Conv1D(nn.Module):
    """HF GPT-2's Conv1D: weight [in, out], y = x @ W + b."""

    def __init__(self, d_in: int, d_out: int, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_in, d_out, device=device,
                                               dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(d_out, device=device,
                                             dtype=dtype))


class Attention(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None, dtype=torch.float32):
        super().__init__()
        D = cfg.n_embd
        self.c_attn = Conv1D(D, 3 * D, device, dtype)
        self.c_proj = Conv1D(D, D, device, dtype)


class MLP(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None, dtype=torch.float32):
        super().__init__()
        D = cfg.n_embd
        self.c_fc = Conv1D(D, 4 * D, device, dtype)
        self.c_proj = Conv1D(4 * D, D, device, dtype)


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None, dtype=torch.float32):
        super().__init__()
        D, eps = cfg.n_embd, cfg.layer_norm_epsilon
        self.ln_1 = nn.LayerNorm(D, eps=eps, device=device, dtype=dtype)
        self.attn = Attention(cfg, device, dtype)
        self.ln_2 = nn.LayerNorm(D, eps=eps, device=device, dtype=dtype)
        self.mlp = MLP(cfg, device, dtype)
        # a tp rank's block (parallel/mesh.shard_params): its TPGroup
        self.tp = None


class Transformer(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None, dtype=torch.float32):
        super().__init__()
        D = cfg.n_embd
        self.wte = nn.Embedding(cfg.vocab_size, D, device=device, dtype=dtype)
        self.wpe = nn.Embedding(cfg.n_positions, D, device=device,
                                dtype=dtype)
        self.h = nn.ModuleList(Block(cfg, device, dtype)
                               for _ in range(cfg.n_layer))
        self.ln_f = nn.LayerNorm(D, eps=cfg.layer_norm_epsilon,
                                 device=device, dtype=dtype)


class GPT2LMHeadModel(nn.Module):
    """GPT-2 with the LM head tied to the token embedding."""

    def __init__(self, cfg: GPT2Config, device=None, dtype=torch.float32):
        super().__init__()
        self.transformer = Transformer(cfg, device, dtype)
        self.lm_head = nn.Linear(cfg.n_embd, cfg.vocab_size, bias=False,
                                 device=device, dtype=dtype)
        self.lm_head.weight = self.transformer.wte.weight  # tied head


@torch.no_grad()
def init_params(model: GPT2LMHeadModel, cfg: GPT2Config,
                generator: torch.Generator) -> GPT2LMHeadModel:
    """Random init in place, GPT-2's scheme as in the JAX reference:
    normal(0.02) matrices, residual projections scaled by 1/sqrt(2L),
    wpe std 0.01, zero biases, unit layernorm scales."""
    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                            dtype=torch.float32) * std)

    proj_std = 0.02 / math.sqrt(2 * cfg.n_layer)
    t = model.transformer
    normal_(t.wte.weight, 0.02)
    normal_(t.wpe.weight, 0.01)
    for blk in t.h:
        normal_(blk.attn.c_attn.weight, 0.02)
        normal_(blk.attn.c_proj.weight, proj_std)
        normal_(blk.mlp.c_fc.weight, 0.02)
        normal_(blk.mlp.c_proj.weight, proj_std)
        for p in (blk.attn.c_attn.bias, blk.attn.c_proj.bias,
                  blk.mlp.c_fc.bias, blk.mlp.c_proj.bias):
            p.zero_()
        for ln in (blk.ln_1, blk.ln_2):
            ln.weight.fill_(1.0)
            ln.bias.zero_()
    t.ln_f.weight.fill_(1.0)
    t.ln_f.bias.zero_()
    return model


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """Layernorm in float32, cast back to the input dtype (the decode cast
    keeps ln parameters in float32, so `.float()` on them is free)."""
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                     ln.bias.float(), ln.eps)
    return y.to(x.dtype)


def _dense(x: torch.Tensor, layer: Conv1D, cdt: torch.dtype) -> torch.Tensor:
    """x @ W in the compute dtype, read back in float32, + bias (f32)."""
    return (torch.matmul(x.to(cdt), layer.weight.to(cdt)).float()
            + layer.bias.float())


def _attention(q, k, v, bias):
    """q: [B,H,T,d]; k,v: [B,H,S,d]; bias additive [.., T, S]. f32 out."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    probs = torch.softmax(scores * scale + bias, dim=-1).to(q.dtype)
    return torch.matmul(probs.float(), v.float())


def final_logits(model: GPT2LMHeadModel, cfg: GPT2Config,
                 x: torch.Tensor) -> torch.Tensor:
    """ln_f + tied LM head over hidden states [.., D] -> f32 logits."""
    x = _layer_norm(x, model.transformer.ln_f)
    cdt = cfg.compute_dtype
    return torch.matmul(x.to(cdt),
                        model.transformer.wte.weight.to(cdt).t()).float()


def final_hidden(model: GPT2LMHeadModel, cfg: GPT2Config,
                 x: torch.Tensor) -> torch.Tensor:
    """ln_f only, in the compute dtype: the input of the LM-head kernel
    (ops/lm_head.py), which does the tied-head product itself."""
    return _layer_norm(x, model.transformer.ln_f).to(cfg.compute_dtype)


def embed_tokens(model: GPT2LMHeadModel, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """Token embedding lookup (reference `gpt.transformer.wte(tokens)`)."""
    return model.transformer.wte.weight[tokens]


def _dense_in(x: torch.Tensor, layer: Conv1D, cdt: torch.dtype,
              tp) -> torch.Tensor:
    """`_dense` of a layer whose output a tp rank splits (c_attn, c_fc):
    the replicated input enters through `copy_in`."""
    return _dense(x if tp is None else tp.copy_in(x), layer, cdt)


def _dense_out(x: torch.Tensor, layer: Conv1D, cdt: torch.dtype,
               tp) -> torch.Tensor:
    """`_dense` of a layer whose input a tp rank splits (the c_projs): the
    partial products are summed over tp before the bias, which is added
    once."""
    if tp is None:
        return _dense(x, layer, cdt)
    y = torch.matmul(x.to(cdt), layer.weight.to(cdt)).float()
    return tp.reduce_out(y) + layer.bias.float()


# The decoder interface (models/decoders.py): GPT-2 counts nothing on the
# device in a decode step.
DECODE_COUNTERS = ()


def lm_head_weight(model: GPT2LMHeadModel) -> torch.Tensor:
    """K1's weights: the tied embedding wte [V, D]."""
    return model.transformer.wte.weight


def cast_params_for_decode(model: GPT2LMHeadModel,
                           cfg: GPT2Config) -> GPT2LMHeadModel:
    """The decoder cast once for decode: matrices in the compute dtype, so
    every step reads half the bytes in bf16; biases and layernorm
    parameters rounded to the compute dtype (as the JAX reference casts
    every leaf) but held in float32, the dtype they are applied in, so no
    step converts them again. The model itself when it is already so (or
    for float32 configs)."""
    cdt = cfg.compute_dtype
    if all(p.dtype == (cdt if p.dim() > 1 else torch.float32)
           for p in model.parameters()):
        return model
    model = copy.deepcopy(model)
    with torch.no_grad():
        for p in model.parameters():
            p.data = p.data.to(cdt) if p.dim() > 1 else \
                p.data.to(cdt).float()
    return model


def kv_width(model: GPT2LMHeadModel) -> int:
    """The K/V width of the model's blocks: n_embd, or n_embd / tp on a
    tp rank (its `c_attn` holds its heads' q, k and v columns)."""
    return model.transformer.h[0].attn.c_attn.weight.shape[1] // 3


def _block_mlp(x: torch.Tensor, blk: Block, cdt) -> torch.Tensor:
    h = _layer_norm(x, blk.ln_2)
    h = gelu_new(_dense_in(h, blk.mlp.c_fc, cdt, blk.tp)).to(cdt)
    h = _dense_out(h, blk.mlp.c_proj, cdt, blk.tp)
    return x + h.to(x.dtype)


def _block(x: torch.Tensor, blk: Block, bias: torch.Tensor,
           cfg: GPT2Config,
           cache_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
           cache_index: int = 0) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """One transformer block on the full sequence x [B, T, D] with the
    additive f32 attention bias (broadcastable to [B, H, T, S]); returns
    (y, k, v), k/v [B, T, W] in the compute dtype (JAX `_block`,
    gpt2.py:158-204). W is the block's K/V width: D, or D / tp on a tp
    rank, which holds n_head / tp whole heads.

    With `cache_kv`, the layer's (k, v) [B, H, S, hd] of `init_kv_cache`,
    the T new K/V are written at slots cache_index.. of copies of them in
    the cache's dtype, the attention reads the whole cache back in the
    compute dtype, and the copies are returned as k and v."""
    B, T, _ = x.shape
    hd = cfg.head_dim
    cdt = cfg.compute_dtype
    h = _layer_norm(x, blk.ln_1)
    qkv = _dense_in(h, blk.attn.c_attn, cdt, blk.tp).to(cdt)
    W = qkv.shape[-1] // 3
    q, k, v = qkv.split(W, dim=-1)
    heads = lambda a: a.reshape(B, T, W // hd, hd).transpose(1, 2)
    keys, vals = heads(k), heads(v)
    if cache_kv is not None:
        k, v = (c.slice_scatter(new.to(c.dtype), dim=2, start=cache_index,
                                end=cache_index + T)
                for c, new in zip(cache_kv, (keys, vals)))
        keys, vals = k.to(cdt), v.to(cdt)
    attn = _attention(heads(q), keys, vals, bias)
    attn = attn.transpose(1, 2).reshape(B, T, W).to(cdt)
    attn = _dense_out(attn, blk.attn.c_proj, cdt, blk.tp)
    return _block_mlp(x + attn.to(x.dtype), blk, cdt), k, v


def _causal_bias(T: int, device) -> torch.Tensor:
    causal = torch.ones(T, T, dtype=torch.bool, device=device).tril()
    return torch.where(causal, 0.0, NEG_INF).to(torch.float32)


def forward_hidden(model: GPT2LMHeadModel, cfg: GPT2Config,
                   inputs_embeds: torch.Tensor,
                   attention_mask: Optional[torch.Tensor] = None,
                   position_offset: Union[int, torch.Tensor] = 0,
                   attention_bias: Optional[torch.Tensor] = None,
                   positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Transformer stack only: [B, T, D] -> final hidden states [B, T, D]
    in the compute dtype (before ln_f and the LM head), with gradients.

    `attention_mask`: optional [B, T] 1/0 key mask (HF semantics: masked
    keys leave the attention; queries still produce outputs).
    `attention_bias`: optional additive bias REPLACING the causal mask
    (sequence packing): [T, T], [B, T, T] (the batch axis leads: row b's
    mask applies to every head of row b) or [B, H, T, T].
    `positions`: optional explicit wpe indices [T]; default
    `position_offset + arange(T)`."""
    B, T, D = inputs_embeds.shape
    t = model.transformer
    if positions is None:
        positions = position_offset + torch.arange(
            T, device=inputs_embeds.device)
    x = (inputs_embeds + t.wpe.weight[positions]).to(cfg.compute_dtype)
    if attention_bias is None:
        bias = _causal_bias(T, x.device)[None, None]
    else:
        bias = attention_bias
        if bias.dim() == 2:        # [T, T] -> [1, 1, T, T]
            bias = bias[None, None]
        elif bias.dim() == 3:      # [B, T, T] -> [B, 1, T, T]
            bias = bias[:, None]
    if attention_mask is not None:
        bias = bias + torch.where(attention_mask[:, None, None, :] > 0,
                                  0.0, NEG_INF)
    bias = bias.to(torch.float32)
    for blk in t.h:
        x = _block(x, blk, bias, cfg)[0]
    return x


def forward(model: GPT2LMHeadModel, cfg: GPT2Config,
            inputs_embeds: torch.Tensor,
            attention_mask: Optional[torch.Tensor] = None,
            position_offset: Union[int, torch.Tensor] = 0) -> torch.Tensor:
    """Full-sequence forward with a causal mask: inputs_embeds [B, T, D]
    -> f32 logits [B, T, V]. `attention_mask` as in `forward_hidden`."""
    x = forward_hidden(model, cfg, inputs_embeds, attention_mask,
                       position_offset)
    return final_logits(model, cfg, x)


def init_kv_cache(cfg: GPT2Config, batch: int, max_len: int,
                  dtype: Optional[torch.dtype] = None,
                  device=None) -> Cache:
    """The fixed-shape cache of `forward_with_cache` (JAX
    `init_kv_cache`): zeros k, v [L, B, H, S_max, head_dim], in the
    compute dtype unless `dtype` is given."""
    dtype = dtype or cfg.compute_dtype
    shape = (cfg.n_layer, batch, cfg.n_head, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def reorder_kv_cache(cache: Cache, source: torch.Tensor) -> Cache:
    """Row b of the result is row source[b] of the cache, for every entry
    (axis 1, the batch axis: beam-search reordering; JAX
    `reorder_kv_cache`). Out of place."""
    return {name: c.index_select(1, source.to(c.device, torch.int64))
            for name, c in cache.items()}


def forward_with_cache(model: GPT2LMHeadModel, cfg: GPT2Config,
                       inputs_embeds: torch.Tensor, cache: Cache,
                       cache_index: Union[int, torch.Tensor],
                       key_mask: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Cache]:
    """Cached forward for prefill (T > 1) or decode (T = 1) over the cache
    of `init_kv_cache` (JAX `forward_with_cache`, gpt2.py:298-336).

    inputs_embeds [B, T, D] sit at positions cache_index + t. Each layer
    writes its T new K/V (in the cache's dtype) at slot cache_index of a
    copy of its cache and attends over the whole cache: slot s is visible
    to query t iff s <= cache_index + t, and `key_mask` [B, S_max] (1/0
    or bool) masks slots further. Both masks add the finite NEG_INF to
    f32 scores, as the JAX function does, so a query whose every slot is
    masked takes a uniform softmax, not NaN. Returns (f32 logits [B, T,
    V], the new cache); the given cache is not changed.

    Edges, as JAX computes them: the write starts at min(cache_index,
    S_max - T), the clamp of `lax.dynamic_update_slice`, while the mask
    keeps the unclamped index. Refused with ValueError: T > S_max (JAX
    raises too), a negative index (JAX wraps it from the end of the cache
    and of wpe), and positions past n_positions (JAX's `jnp.take` gives
    NaN rows). `cache_index` is an int or a 0-d tensor; a tensor costs
    one host sync a call (its `.item()`)."""
    T = inputs_embeds.shape[1]
    S = cache["k"].shape[3]
    t = model.transformer
    index = int(cache_index)
    if T > S:
        raise ValueError(f"{T} new positions do not fit a cache of {S}")
    if index < 0 or index + T > t.wpe.weight.shape[0]:
        raise ValueError(f"positions {index}..{index + T - 1} are outside "
                         f"0..{t.wpe.weight.shape[0] - 1}")
    dev = inputs_embeds.device
    queries = index + torch.arange(T, device=dev)
    x = (inputs_embeds + t.wpe.weight[queries]).to(cfg.compute_dtype)
    visible = torch.arange(S, device=dev)[None, :] <= queries[:, None]
    bias = torch.where(visible, 0.0, NEG_INF)[None, None]
    if key_mask is not None:
        bias = bias + torch.where(key_mask[:, None, None, :] > 0, 0.0,
                                  NEG_INF)
    bias = bias.to(torch.float32)
    write = min(index, S - T)
    ks, vs = [], []
    for layer, blk in enumerate(t.h):
        x, k, v = _block(x, blk, bias, cfg,
                         (cache["k"][layer], cache["v"][layer]), write)
        ks.append(k)
        vs.append(v)
    return (final_logits(model, cfg, x),
            {"k": torch.stack(ks), "v": torch.stack(vs)})


@torch.no_grad()
def prefill(model: GPT2LMHeadModel, cfg: GPT2Config,
            inputs_embeds: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """Run the prefix [N, K, D] once; return (last-position logits [N, V]
    f32, prefix_cache {k, v: [L, N, K, D]} in the compute dtype). The
    K x K causal attention is plain matmul + softmax (it was XLA, not
    Pallas, in the reference)."""
    N, K, D = inputs_embeds.shape
    t = model.transformer
    x = (inputs_embeds + t.wpe.weight[:K]).to(cfg.compute_dtype)
    bias = _causal_bias(K, x.device)
    ks, vs = [], []
    for blk in t.h:
        x, k, v = _block(x, blk, bias, cfg)
        ks.append(k)
        vs.append(v)
    logits = final_logits(model, cfg, x[:, -1])
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}


def init_gen_cache(cfg: GPT2Config, batch: int, max_new: int,
                   dtype: Optional[torch.dtype] = None,
                   device=None, width: Optional[int] = None) -> Cache:
    """Seq-major generated cache [L, B, E, D] (greedy/top-p decode, which
    never moves rows). D is `width` when given: a tp rank's
    `kv_width(model)`, as for every cache constructor here."""
    dtype = dtype or cfg.compute_dtype
    shape = (cfg.n_layer, batch, max_new, width or cfg.n_embd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_gen_cache_int8(cfg: GPT2Config, batch: int, max_new: int,
                        device=None, width: Optional[int] = None) -> Cache:
    """Seq-major int8 generated cache (greedy/top-p): levels k/v int8
    [L, B, E, D] plus per-slot absmax scales ks/vs f32 [L, B, 1, E]."""
    shape = (cfg.n_layer, batch, max_new, width or cfg.n_embd)
    sshape = (cfg.n_layer, batch, 1, max_new)
    return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "ks": torch.zeros(sshape, dtype=torch.float32, device=device),
            "vs": torch.zeros(sshape, dtype=torch.float32, device=device)}


def quantize_prefix_cache(prefix_cache: Cache) -> Cache:
    """Quantise a prefill prefix cache ({k, v: [L, N, K, D]}) to int8
    levels plus per-(layer, image, slot) absmax scales ks/vs
    [L, N, 1, K] f32. The prefix is read every step by every beam; int8
    halves those bytes. Read by the chunked int8 attention (kernel K9)."""
    qk, sk = cache_reorder.absmax_int8_quant(prefix_cache["k"])
    qv, sv = cache_reorder.absmax_int8_quant(prefix_cache["v"])
    return {"k": qk, "v": qv,
            "ks": sk[..., 0][:, :, None, :].contiguous(),
            "vs": sv[..., 0][:, :, None, :].contiguous()}


def repeat_prefix_cache(prefix_cache: Cache, repeats: int) -> Cache:
    """Tile a [L, N, ...] prefix cache to [L, N*R, ...]: image n's entry
    repeated R times in a row on axis 1 (the unified-cache layout)."""
    return {k: torch.repeat_interleave(v, repeats, dim=1)
            for k, v in prefix_cache.items()}


def init_gen_cache_rowmajor(cfg: GPT2Config, batch: int, max_new: int,
                            dtype: Optional[torch.dtype] = None,
                            device=None, width: Optional[int] = None
                            ) -> Cache:
    """Row-major generated cache [B, L, E, D]: each beam row's K/V over
    all layers is one contiguous block, so a fork copy moves whole
    (row, layer) slot ranges."""
    dtype = dtype or cfg.compute_dtype
    shape = (batch, cfg.n_layer, max_new, width or cfg.n_embd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_gen_cache_rowmajor_int8(cfg: GPT2Config, batch: int, max_new: int,
                                 device=None, width: Optional[int] = None
                                 ) -> Cache:
    """Row-major int8 generated cache: levels k/v int8 [B, L, E, D] plus
    per-slot absmax scales ks/vs f32 [B, L, 1, E] (value = level * scale).
    Written by cache_reorder.write_gen_slot_chunk_q, read by
    decode_attention.beam_decode_attention_rowmajor_q: half the bytes of
    the bf16 cache."""
    shape = (batch, cfg.n_layer, max_new, width or cfg.n_embd)
    sshape = (batch, cfg.n_layer, 1, max_new)
    return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "ks": torch.zeros(sshape, dtype=torch.float32, device=device),
            "vs": torch.zeros(sshape, dtype=torch.float32, device=device)}


def _decode_routes(prefix_cache: Cache, gen_cache: Cache, *, rowmajor: bool,
                   fused_attention: bool, chunk_slot_write: bool,
                   slot_write_kernel: bool, fused_slot_chunks: int,
                   e_cap: Optional[int], anc_rows: Optional[torch.Tensor]):
    """(attend, attention keywords, write) of one decode_step: which
    kernel wrapper, or which plain version, each part runs."""
    da, cr = decode_attention, cache_reorder
    int8 = "ks" in gen_cache
    if "ks" in prefix_cache and not (rowmajor and int8 and fused_slot_chunks):
        raise ValueError("int8 prefix cache requires the chunked fused "
                         "kernel (fused_slot_chunks > 0)")
    if anc_rows is not None and (int8 or fused_attention):
        raise ValueError("ancestry attention runs the plain attention math "
                         "over a float cache (fused_attention=False)")
    if not rowmajor or anc_rows is not None:
        # Seq-major [L, B, E, D], or ancestry: attention is the plain
        # PyTorch math, the counterpart of the JAX XLA path, which has no
        # Pallas kernel; an int8 cache quantises its slot in plain
        # PyTorch, as XLA does.
        attend = (da.beam_decode_attention_rowmajor_q_plain if int8
                  else da.beam_decode_attention_rowmajor_plain)
        kw = {"e_cap": e_cap if rowmajor else None}
        if anc_rows is not None:
            kw["anc_rows"] = anc_rows
        if not rowmajor:
            if int8:
                write = cr.write_gen_slot_chunk_q_plain
            else:
                write = (cr.write_gen_slot_chunk_seqmajor if chunk_slot_write
                         else cr.write_gen_slot_chunk_seqmajor_plain)
            return attend, kw, write
    elif fused_slot_chunks:  # v3: K8, or K9 over int8 caches
        kw = {"chunk": fused_slot_chunks}
        if int8:
            attend = (da.beam_decode_attention_chunked_q if fused_attention
                      else da.beam_decode_attention_chunked_q_plain)
            kw.update(pks=prefix_cache.get("ks"), pvs=prefix_cache.get("vs"))
        else:
            attend = (da.beam_decode_attention_chunked if fused_attention
                      else da.beam_decode_attention_chunked_plain)
    else:  # v2: K2, or K6 over an int8 cache
        kw = {"e_cap": e_cap}
        if int8:
            attend = (da.beam_decode_attention_rowmajor_q if fused_attention
                      else da.beam_decode_attention_rowmajor_q_plain)
        else:
            attend = (da.beam_decode_attention_rowmajor if fused_attention
                      else da.beam_decode_attention_rowmajor_plain)
    # the JAX engine's precedence (gpt2.py:773-799): the chunked write,
    # then the slot-write kernel, then the plain write; int8 quantises
    if int8:
        write = (cr.write_gen_slot_chunk_q if chunk_slot_write
                 else cr.write_gen_slot_chunk_q_plain)
    elif chunk_slot_write:
        write = cr.write_gen_slot_chunk
    elif slot_write_kernel:
        write = cr.write_gen_slot
    else:
        write = cr.write_gen_slot_chunk_plain
    return attend, kw, write


def _w(layer: Conv1D, cdt: torch.dtype) -> torch.Tensor:
    """A product's weight in the compute dtype (as cast for decode)."""
    w = layer.weight
    return w if w.dtype == cdt else w.to(cdt)


def _f32(p: torch.Tensor) -> torch.Tensor:
    return p if p.dtype == torch.float32 else p.float()


def _ln_args(ln: nn.LayerNorm):
    return _f32(ln.weight), _f32(ln.bias), ln.eps


def _proj_residual_layernorm(x: torch.Tensor, h: torch.Tensor,
                             inp: torch.Tensor, layer: Conv1D,
                             ln: nn.LayerNorm, cdt: torch.dtype, tp) -> None:
    """x += the c_proj `layer` of `inp` and h = ln(x), in place. One
    epilogue (bias_residual_layernorm); on a tp rank the chain, whose
    bias is added in float32 after the tp sum, which the epilogue, adding
    it to a product rounded to the compute dtype, cannot do."""
    if tp is None:
        epilogue.bias_residual_layernorm(
            x, torch.mm(inp, _w(layer, cdt)), _f32(layer.bias),
            *_ln_args(ln), out=(x, h))
        return
    x.add_(_dense_out(inp, layer, cdt, tp).to(x.dtype))
    h.copy_(_layer_norm(x, ln))


def _decode_block(x: torch.Tensor, h: torch.Tensor,
                  a: Optional[torch.Tensor], blk: Block,
                  next_ln: nn.LayerNorm, cdt: torch.dtype, attention,
                  layer: int):
    """One block of a decode step through the fused epilogues
    (ops/epilogue.py). x [B, D] is the residual stream and h its ln_1,
    both in the compute dtype, and `a` the step's GELU buffer (None: a
    new one); `attention(q, k, v, layer)` the step's attention. Updates x
    and h in place: x to the block's output and h to its layernorm by
    `next_ln` (the next block's ln_1, or ln_f after the last block), each
    read by the products before it is written again on the one stream.
    Returns the GELU buffer and the layer's k/v views of its qkv output,
    which the slot write reads after the last block. Each epilogue rounds
    where `_block`'s chain rounds, so the values are `_block`'s; the
    decode path's own function, so that `_block` (training, prefill)
    keeps its autograd graph."""
    ep, mm, tp = epilogue, torch.mm, blk.tp  # 2-D: torch.matmul's product
    attn, mlp = blk.attn, blk.mlp
    hin = h if tp is None else tp.copy_in(h)
    qkv = ep.bias_cast(mm(hin, _w(attn.c_attn, cdt)), _f32(attn.c_attn.bias))
    # q, k and v: views of qkv's thirds (rows 3W apart, as a split gives)
    q, k_new, v_new = qkv.view(qkv.shape[0], 3, -1).unbind(1)
    out = attention(q, k_new, v_new, layer).to(cdt)
    _proj_residual_layernorm(x, h, out, attn.c_proj, blk.ln_2, cdt, tp)
    hin = h if tp is None else tp.copy_in(h)
    a = ep.bias_gelu_cast(mm(hin, _w(mlp.c_fc, cdt)), _f32(mlp.c_fc.bias),
                          out=a)
    _proj_residual_layernorm(x, h, a, mlp.c_proj, next_ln, cdt, tp)
    return a, k_new, v_new


def _decode_blocks(t: Transformer, cdt: torch.dtype,
                   token_embed: torch.Tensor, position: int, attention):
    """The blocks of a decode step by `_decode_block`, from the entry (the
    token embeddings plus wpe[position], and block 0's ln_1, in one
    epilogue, into the step's new x and h) to ln_f. Returns (the ln_f'd
    hidden state [B, D] in the compute dtype, the layers' k views, their
    v views)."""
    blocks = list(t.h)
    x, h = epilogue.embed_layernorm(token_embed, t.wpe.weight[position],
                                    *_ln_args(blocks[0].ln_1), cdt)
    next_lns = [blk.ln_1 for blk in blocks[1:]] + [t.ln_f]
    a, ks, vs = None, [], []
    for layer, (blk, next_ln) in enumerate(zip(blocks, next_lns)):
        a, k_new, v_new = _decode_block(x, h, a, blk, next_ln, cdt,
                                        attention, layer)
        ks.append(k_new)
        vs.append(v_new)
    return h, ks, vs


@torch.no_grad()
def decode_step(model: GPT2LMHeadModel, cfg: GPT2Config,
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
    """One decode step over split caches.

    token_embed: [B, D] embeddings of the tokens decoded at generated
    position `step` (B = N * R beams; prefix_cache holds N image rows).
    Attends over the prefix, generated slots < step and the current
    token, and writes the step's K/V into slot `step` of `gen_cache` IN
    PLACE. Returns the ln_f'd hidden state [B, D] in the compute dtype,
    the input of the fused LM-head kernel (ops/lm_head.py), or with
    `return_hidden=False` the f32 logits [B, V].

    The generated cache is row-major [B, L, E, D] (`rowmajor`, the beam
    engine's) or seq-major [L, B, E, D] (greedy/top-p); an int8 cache
    carries per-slot scales "ks"/"vs", and an int8 prefix cache
    (quantize_prefix_cache) carries "ks"/"vs" too. Row-major routes:
    `fused_slot_chunks` > 0 takes the slot-bounded kernels, K8 (K9 over
    int8 caches), else K2 (K6), read up to `e_cap` (the caller guarantees
    step < e_cap; the chunked kernels are bounded by `step` alone); the
    slot write is K3 (`chunk_slot_write`; K5 over int8), else K14
    (`slot_write_kernel`), else the plain write. Seq-major: the plain
    attention math, and the slot write K13 (int8: a quantising write in
    plain PyTorch). K3, K13 and K14 read each layer's K/V where the layer
    left it; the int8 writes take the layers' K/V stacked.
    `fused_attention` / `chunk_slot_write` / `slot_write_kernel` choose the
    kernel wrappers (True) or their plain PyTorch versions (False).

    `anc_rows` [B, E] int64 (ancestry attention, either layout): row b's
    slot e lives in cache row anc_rows[b, e]; the cache never moves, and
    the attention is the plain math with that gather
    (decode_attention._attention_plain).

    `fused_epilogues` runs each block by `_decode_block`, whose bias adds,
    casts, GELU, residual sums and layernorms are the kernels of
    ops/epilogue.py (their plain versions on the CPU; on the card they
    raise for a width or dtype they do not take), but for a tp rank's
    c_projs, whose bias follows the tp sum; False runs `_block`'s op
    chain (`plain_ops`).
    """
    B = token_embed.shape[0]
    L, N, K, _ = prefix_cache["k"].shape
    R = B // N
    cdt = cfg.compute_dtype
    t = model.transformer
    attend, kw, write = _decode_routes(
        prefix_cache, gen_cache, rowmajor=rowmajor,
        fused_attention=fused_attention, chunk_slot_write=chunk_slot_write,
        slot_write_kernel=slot_write_kernel,
        fused_slot_chunks=fused_slot_chunks, e_cap=e_cap, anc_rows=anc_rows)
    gk, gv = gen_cache["k"], gen_cache["v"]
    scales = (gen_cache["ks"], gen_cache["vs"]) if "ks" in gen_cache else ()
    # the attention reads [B, L, ...] layouts; seq-major caches as views
    att_caches = (gk, gv, *scales) if rowmajor else \
        tuple(c.transpose(0, 1) for c in (gk, gv, *scales))
    pk, pv = prefix_cache["k"], prefix_cache["v"]

    def attention(q, k_new, v_new, layer):
        return attend(q, k_new, v_new, pk, pv, *att_caches, step, layer,
                      beams_per_image=R, head_dim=cfg.head_dim, **kw)

    if fused_epilogues:
        h, ks, vs = _decode_blocks(t, cdt, token_embed, K + step, attention)
    else:
        x = (token_embed + t.wpe.weight[K + step]).to(cdt)
        ks, vs = [], []
        for layer, blk in enumerate(t.h):
            h = _layer_norm(x, blk.ln_1)
            qkv = _dense_in(h, blk.attn.c_attn, cdt, blk.tp).to(cdt)
            q, k_new, v_new = qkv.split(qkv.shape[-1] // 3, dim=-1)
            out = attention(q, k_new, v_new, layer)
            out = _dense_out(out.to(cdt), blk.attn.c_proj, cdt, blk.tp)
            x = _block_mlp(x + out.to(x.dtype), blk, cdt)
            ks.append(k_new)
            vs.append(v_new)
    if scales:  # int8: K5 (or the plain write) quantises them stacked
        axis = 1 if rowmajor else 0  # [B, L, D] or [L, B, D]
        write(gk, gv, *scales, torch.stack(ks, dim=axis),
              torch.stack(vs, dim=axis), step)
    else:
        # K3, K13 and K14 read the per-layer views where they lie: no
        # stacking copy (the plain versions stack them themselves)
        write(gk, gv, ks, vs, step)
    if fused_epilogues:  # h is ln_f's output already
        return h if return_hidden else torch.matmul(
            h, t.wte.weight.to(cdt).t()).float()
    if return_hidden:
        return final_hidden(model, cfg, x)
    return final_logits(model, cfg, x)


# ---------------------------------------------------------------------------
# Weight loading
# ---------------------------------------------------------------------------


def config_from_torch_state_dict(state_dict: Dict[str, Any],
                                 prefix: str = "",
                                 compute_dtype: torch.dtype = torch.float32
                                 ) -> GPT2Config:
    """Infer the decoder architecture from checkpoint shapes alone. Every
    released GPT-2 size uses head_dim 64, so n_head = n_embd // 64."""
    def shape(name):
        return tuple(state_dict[prefix + name].shape)

    vocab_size, n_embd = shape("transformer.wte.weight")
    seg = (prefix + "transformer.h.").count(".")
    n_layer = len({k.split(".")[seg] for k in state_dict
                   if k.startswith(prefix + "transformer.h.")})
    return GPT2Config(vocab_size=vocab_size,
                      n_positions=shape("transformer.wpe.weight")[0],
                      n_embd=n_embd, n_layer=n_layer,
                      n_head=max(1, n_embd // 64),
                      compute_dtype=compute_dtype)


def params_from_torch_state_dict(state_dict: Dict[str, Any],
                                 cfg: GPT2Config, prefix: str = "",
                                 device=None) -> GPT2LMHeadModel:
    """Build the model from a HF GPT2LMHeadModel state_dict (keys under
    `prefix`, e.g. `gpt.` in CapDec checkpoints), strictly."""
    sd = {k[len(prefix):]: torch.as_tensor(v) for k, v in state_dict.items()
          if k.startswith(prefix)}
    if "lm_head.weight" not in sd:
        sd["lm_head.weight"] = sd["transformer.wte.weight"]
    model = GPT2LMHeadModel(cfg, device=device)
    model.load_state_dict(sd, strict=True)
    return model


def params_to_torch_state_dict(model: GPT2LMHeadModel, prefix: str = ""
                               ) -> Dict[str, torch.Tensor]:
    """HF key layout (under `prefix`) of the model's weights as float32
    CPU tensors, the tied `lm_head.weight` included: the inverse of
    `params_from_torch_state_dict`."""
    return {prefix + k: v.detach().to("cpu", torch.float32)
            for k, v in model.state_dict().items()}


def state_dict_from_jax_numpy(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """HF key layout of a JAX-package parameter pytree given as numpy
    arrays (stacked blocks on a leading layer axis)."""
    out = {"transformer.wte.weight": tree["wte"],
           "transformer.wpe.weight": tree["wpe"],
           "transformer.ln_f.weight": tree["ln_f"]["scale"],
           "transformer.ln_f.bias": tree["ln_f"]["bias"],
           "lm_head.weight": tree["wte"]}
    b = tree["blocks"]
    names = {"ln_1.weight": b["ln_1"]["scale"], "ln_1.bias": b["ln_1"]["bias"],
             "ln_2.weight": b["ln_2"]["scale"], "ln_2.bias": b["ln_2"]["bias"],
             "attn.c_attn.weight": b["attn"]["c_attn_w"],
             "attn.c_attn.bias": b["attn"]["c_attn_b"],
             "attn.c_proj.weight": b["attn"]["c_proj_w"],
             "attn.c_proj.bias": b["attn"]["c_proj_b"],
             "mlp.c_fc.weight": b["mlp"]["c_fc_w"],
             "mlp.c_fc.bias": b["mlp"]["c_fc_b"],
             "mlp.c_proj.weight": b["mlp"]["c_proj_w"],
             "mlp.c_proj.bias": b["mlp"]["c_proj_b"]}
    for name, stacked in names.items():
        for i in range(np.shape(stacked)[0]):
            out[f"transformer.h.{i}.{name}"] = stacked[i]
    return {k: np.ascontiguousarray(v, dtype=np.float32)
            for k, v in out.items()}


def params_from_jax_numpy(tree: Dict[str, Any], cfg: GPT2Config,
                          device=None) -> GPT2LMHeadModel:
    """Load the port's GPT-2 from the JAX package's parameter pytree
    (numpy leaves, blocks stacked on a leading layer axis)."""
    sd = {k: torch.from_numpy(v)
          for k, v in state_dict_from_jax_numpy(tree).items()}
    return params_from_torch_state_dict(sd, cfg, device=device)

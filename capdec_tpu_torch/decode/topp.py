"""Top-p (nucleus) filtered decoding, greedy by default (port of
capdec_tpu/decode/topp.py).

The reference (gpt2_prefix_eval.py:118-198) nucleus-filters at top_p=0.8
and then takes the argmax (its multinomial draw is commented out), so its
generate2 is greedy decoding: the filter never removes the argmax token.
That is the default (`sample=False`); `sample=True` draws from the
filtered distribution with an explicit `torch.Generator`.

Stop rule: the stop token '.' (13) or 764 (' .'), the stop token kept in
the output; a row's length grows only while it is alive; entry_length
caps the decode.

The engine decodes in stages over a generated cache that grows between
them (`staging.stage_buckets`, `staging.grow_cache`) and stops growing
once every row has stopped. Routes of the decode step:
  * default (`fused_attention=False`): a seq-major cache [L, B, E, D].
    Its attention is plain PyTorch math, the counterpart of the JAX XLA
    path, which has no Pallas kernel; the slot write is plain, or kernel
    K13 with `chunk_slot_write`. With `kv_cache_int8` the cache holds int8
    levels and scales, quantised in plain PyTorch as XLA does.
  * `fused_attention=True`: the beam engine's row-major cache and kernels
    with one beam per image: K2 (v2) or, with `fused_slot_chunks`, K8,
    and the slot write K3; with `kv_cache_int8`, K9 (and an int8 prefix
    cache) and the quantising slot write K5.
The next token comes from the fused LM head with top-1 (kernel K1) unless
`sample` or a temperature other than 1 asks for the logits.
`plain_ops` runs every chosen op's plain PyTorch version (the card's
reference path). The JAX engine's `fused_block_beams` (a TPU block size)
and `fused_interpret` have no counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from . import staging
from .beam import SLOT_ALIGN, cast_params_for_decode
from ..models import gpt2
from ..ops import lm_head
from ..utils.tokenizer import GPT2_DOT_TOKEN, GPT2_SPACE_DOT_TOKEN


@dataclasses.dataclass(frozen=True)
class ToppConfig:
    entry_length: int = 67
    top_p: float = 0.8
    temperature: float = 1.0
    stop_token: int = GPT2_DOT_TOKEN
    extra_stop_token: int = GPT2_SPACE_DOT_TOKEN
    sample: bool = False
    # Op knobs, with the JAX engine's meaning; None = auto (`resolve_config`).
    # Fused attention over a row-major cache (K2, or K8/K9 with chunks).
    fused_attention: Optional[bool] = None
    # Slot-bounded reads in tiles of this many slots (K8; K9 over int8);
    # only meaningful with fused_attention.
    fused_slot_chunks: int = 0
    # Kernel slot write: K13 on the seq-major cache, K3 on the row-major.
    chunk_slot_write: Optional[bool] = None
    cache_stages: int = 8
    # int8 KV cache: plain seq-major math, or the fused route (which needs
    # fused_slot_chunks).
    kv_cache_int8: bool = False
    # int8 prefix cache on the fused chunked int8 route; None = auto.
    int8_prefix: Optional[bool] = None
    # Fused LM head + top-1 (K1); needs sample=False and temperature 1.
    fused_lm_head: Optional[bool] = None
    # Run every chosen op's plain PyTorch version instead of its kernel.
    plain_ops: bool = False

    def plain(self) -> "ToppConfig":
        """This configuration with every op's plain PyTorch version."""
        return dataclasses.replace(self, plain_ops=True)


def nucleus_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Mask logits outside the smallest set with cumulative probability
    > top_p (reference :166-175): sort descending, cumsum of the softmax,
    the removal mask shifted right by one so the top token survives."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    remove = cum > top_p
    remove = torch.cat([torch.zeros_like(remove[..., :1]), remove[..., :-1]],
                       dim=-1)
    # the threshold of each row: its smallest kept finite logit
    kept = torch.where(remove, -torch.inf, sorted_logits)
    threshold = torch.where(torch.isfinite(kept), kept,
                            torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(logits < threshold, -torch.inf, logits)


def _pick(logits: torch.Tensor, tc: ToppConfig,
          generator: torch.Generator) -> torch.Tensor:
    if tc.temperature > 0 and tc.temperature != 1.0:
        logits = logits / tc.temperature
    if tc.sample:
        filtered = nucleus_filter(logits.float(), tc.top_p)
        return torch.multinomial(torch.softmax(filtered, dim=-1), 1,
                                 generator=generator)[:, 0]
    # the argmax of the nucleus-filtered logits is the plain argmax
    return torch.argmax(logits, dim=-1)


@torch.no_grad()
def _greedy_impl(model: gpt2.GPT2LMHeadModel, cfg: gpt2.GPT2Config,
                 tc: ToppConfig, prefix_embeds: torch.Tensor,
                 generator: torch.Generator
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    N = prefix_embeds.shape[0]
    E = tc.entry_length
    dev = prefix_embeds.device
    kernels = not tc.plain_ops
    fused = bool(tc.fused_attention)
    # the JAX engine's refusals (capdec_tpu/decode/topp.py:138-142)
    if tc.kv_cache_int8 and fused and not tc.fused_slot_chunks:
        raise ValueError("fused int8 greedy requires fused_slot_chunks")
    if tc.kv_cache_int8 and tc.chunk_slot_write and not fused:
        raise ValueError("kv_cache_int8 on the XLA path is not combinable "
                         "with chunk_slot_write")
    model = cast_params_for_decode(model, cfg)
    wte = model.transformer.wte.weight
    logits0, prefix_cache = gpt2.prefill(model, cfg, prefix_embeds)
    if tc.kv_cache_int8 and fused and tc.int8_prefix:
        prefix_cache = gpt2.quantize_prefix_cache(prefix_cache)
    tok0 = _pick(logits0, tc, generator)
    tokens = torch.zeros(N, E, dtype=torch.int64, device=dev)
    tokens[:, 0] = tok0
    stopped = (tok0 == tc.stop_token) | (tok0 == tc.extra_stop_token)
    lengths = torch.ones(N, dtype=torch.int64, device=dev)

    if fused:
        init_cache = (gpt2.init_gen_cache_rowmajor_int8 if tc.kv_cache_int8
                      else gpt2.init_gen_cache_rowmajor)
    else:
        init_cache = (gpt2.init_gen_cache_int8 if tc.kv_cache_int8
                      else gpt2.init_gen_cache)
    E_pad = -(-E // SLOT_ALIGN) * SLOT_ALIGN
    buckets = staging.stage_buckets(E_pad, tc.cache_stages, SLOT_ALIGN)
    chunks = tc.fused_slot_chunks if fused else 0
    staging.check_chunks(buckets, chunks)
    gen_cache = init_cache(cfg, N, buckets[0], device=dev)
    cur = gpt2.embed_tokens(model, tok0)
    topk = lm_head.lm_head_topk if kernels else lm_head.lm_head_topk_plain

    i = 1
    for cap in buckets:
        if i >= E or bool(stopped.all()):
            break  # done: later stages neither run nor grow the cache
        if gen_cache["k"].shape[2] < cap:
            gen_cache = staging.grow_cache(
                gen_cache, init_cache(cfg, N, cap, device=dev))
        while i < E and i <= cap and not bool(stopped.all()):
            out = gpt2.decode_step(
                model, cfg, cur, prefix_cache, gen_cache, i - 1,
                rowmajor=fused, fused_attention=fused and kernels,
                chunk_slot_write=bool(tc.chunk_slot_write) and kernels,
                fused_slot_chunks=chunks,
                return_hidden=bool(tc.fused_lm_head))
            if tc.fused_lm_head:
                nxt = topk(out, wte, 1)[1][:, 0]
            else:
                nxt = _pick(out, tc, generator)
            alive = ~stopped
            tokens[:, i] = torch.where(alive, nxt, 0)
            lengths += alive.long()
            stopped = stopped | (alive & ((nxt == tc.stop_token)
                                          | (nxt == tc.extra_stop_token)))
            cur = gpt2.embed_tokens(model, nxt)
            i += 1
    return tokens, lengths


def resolve_config(tc: ToppConfig) -> ToppConfig:
    """Resolve every None (auto) knob as the JAX engine does on the TPU
    (capdec_tpu/decode/topp.py:217-249)."""
    if tc.fused_attention is None:
        tc = dataclasses.replace(tc, fused_attention=False)
    if tc.chunk_slot_write is None:
        tc = dataclasses.replace(tc,
                                 chunk_slot_write=bool(tc.fused_attention))
    if tc.int8_prefix is None:
        tc = dataclasses.replace(
            tc, int8_prefix=tc.kv_cache_int8 and bool(tc.fused_attention)
            and bool(tc.fused_slot_chunks))
    scaled = tc.temperature > 0 and tc.temperature != 1.0
    if tc.fused_lm_head is None:
        tc = dataclasses.replace(tc, fused_lm_head=not tc.sample
                                 and not scaled)
    if tc.fused_lm_head and (tc.sample or scaled):
        raise ValueError("fused_lm_head requires sample=False and "
                         "temperature == 1")
    return tc


def greedy_topp_search(model: gpt2.GPT2LMHeadModel, cfg: gpt2.GPT2Config,
                       prefix_embeds: torch.Tensor,
                       tc: ToppConfig = ToppConfig(),
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode a batch of prefixes [N, K, D] on their device -> (tokens
    [N, E] int64, lengths [N] int64). `generator` drives `sample=True`
    (default: seed 0 on the prefixes' device)."""
    if generator is None:
        generator = torch.Generator(device=prefix_embeds.device)
        generator.manual_seed(0)
    return _greedy_impl(model, cfg, resolve_config(tc), prefix_embeds,
                        generator)


def topp_texts(tokenizer, tokens, lengths) -> List[str]:
    """Host-side finalization: each row's tokens up to its length."""
    tokens = torch.as_tensor(tokens).cpu().numpy()
    lengths = torch.as_tensor(lengths).cpu().numpy()
    return [tokenizer.decode(tokens[n, :int(lengths[n])])
            for n in range(tokens.shape[0])]

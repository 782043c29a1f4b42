"""Batched, KV-cached beam search (port of capdec_tpu/decode/beam.py).

The reference beam semantics (gpt2_prefix_eval.py:50-115), as the JAX
engine implements them:
  * log-softmax scores; length-normalised top-R over beam x candidates,
    with (source beam, token) recovered by integer div/mod
  * stopped beams pinned: every candidate -inf except token 0 at logp 0,
    so a stopped beam survives with frozen score and length
  * seq_lengths grow only for alive beams; the selected average is
    multiplied back by the gathered length (`scores = avg * len`)
  * stop token '.' (id 13 in GPT-2), entry_length cap, final ranking by
    scores / seq_lengths descending; the loop ends when all beams stop.

This is the lane-mode path of the JAX engine (`_beam_search_impl`,
beam.py:271-553):
  * Each image's R beams live in R cache lanes. A winner that descends
    from a lane without an earlier-ranked sibling stays in that lane;
    the others take the lanes no one claimed (`_assign_lanes`). Only
    forked lanes copy cache rows, lazily at the start of the next step:
    slots < i - 1 (kernel K4, `copy_forked_rows_bounded`) or whole rows
    (kernel K7, `copy_forked_rows`).
  * The cache runs in stages (`staging.stage_buckets`). With `full_alloc`
    it is allocated once at entry_length rounded up to 8 slots and each
    stage's bucket bounds the attention reads (`e_cap`); otherwise it is
    allocated at the first bucket and grows between stages
    (`staging.grow_cache`).
  * The generated cache is bf16/f32, or int8 levels with per-slot scales
    (`kv_cache_int8`), whose scales follow the fork copy by indexing.
    With `int8_prefix` the prefix cache is quantised once after prefill.
  * Each step: decode_step (kernels K2 and K3, or K6 and K5 over int8;
    with `fused_slot_chunks` the slot-bounded K8, or K9 over int8), then
    the fused LM head with top-R and logsumexp (kernel K1), then the
    selection on the R*R-candidate shortlist. A final rank permutation
    restores the reference's beam order.
The JAX engine's one-hot contractions (TPU gather workarounds) are plain
indexing here; the loop is a Python loop.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional, Tuple

import torch

from . import staging
from ..models import gpt2
from ..ops import cache_reorder, lm_head
from ..utils.tokenizer import GPT2_DOT_TOKEN

NEG = -1e30
# Slot alignment of the cache and its stage buckets, as in the JAX engine.
SLOT_ALIGN = 8


@dataclasses.dataclass(frozen=True)
class BeamConfig:
    beam_size: int = 5
    entry_length: int = 67
    stop_token: int = GPT2_DOT_TOKEN
    # Op knobs, with the JAX engine's meaning (which op runs); None = auto
    # (`resolve_config`).
    fused_attention: Optional[bool] = None      # K2 (K6 over int8)
    chunk_slot_write: Optional[bool] = None     # K3 (int8 always takes K5)
    fused_lm_head: Optional[bool] = None        # K1
    # True: fork copies move slots < step (K4); False: whole rows (K7).
    bounded_fork_copy: Optional[bool] = None
    # True: one full-size cache, stage-bounded reads (e_cap); False:
    # staged cache growth between the stages.
    full_alloc: Optional[bool] = None
    cache_stages: int = 8
    # int8 generated KV cache (opt-in serving mode; not token-identical to
    # the bf16 path). Requires fused_attention.
    kv_cache_int8: bool = False
    # Slot-bounded ("v3") attention: the generated cache is read in tiles
    # of this many slots below the step (K8; K9 over int8 caches), and the
    # cache keeps staged growth. 0 = the v2 kernels (K2/K6); None = auto
    # (0, as on the TPU). Must divide the 8-aligned stage buckets.
    fused_slot_chunks: Optional[int] = None
    # int8 PREFIX cache (with kv_cache_int8 and fused_slot_chunks): the
    # prefill K/V quantised once (gpt2.quantize_prefix_cache), read by K9.
    # None = auto (on when kv_cache_int8 and fused_slot_chunks are).
    int8_prefix: Optional[bool] = None
    # Run every chosen op's plain PyTorch version instead of its kernel
    # wrapper: the card's reference path (counterpart of the JAX engine's
    # fused_interpret).
    plain_ops: bool = False

    def plain(self) -> "BeamConfig":
        """This configuration with every op's plain PyTorch version."""
        return dataclasses.replace(self, plain_ops=True)


def _auto(bc: BeamConfig, knob: str, value) -> BeamConfig:
    """`bc` with `knob` set to `value` where it is None (auto)."""
    if getattr(bc, knob) is not None:
        return bc
    return dataclasses.replace(bc, **{knob: value})


def resolve_config(bc: BeamConfig) -> BeamConfig:
    """Resolve every None (auto) knob as the JAX engine does on the TPU
    (capdec_tpu/decode/beam.py:584-643)."""
    bc = _auto(bc, "fused_attention", True)
    bc = _auto(bc, "chunk_slot_write", bool(bc.fused_attention))
    bc = _auto(bc, "fused_lm_head", True)
    bc = _auto(bc, "fused_slot_chunks", 0)
    # A full-size cache with stage-bounded reads on the v2 path only: v3
    # keeps its own staging, and int8 keeps staged growth (the JAX engine
    # measured it faster there).
    bc = _auto(bc, "full_alloc",
               bool(bc.fused_attention) and not bc.fused_slot_chunks
               and not bc.kv_cache_int8)
    bc = _auto(bc, "bounded_fork_copy",
               bool(bc.fused_slot_chunks or bc.full_alloc))
    bc = _auto(bc, "int8_prefix",
               bc.kv_cache_int8 and bool(bc.fused_slot_chunks))
    if bc.kv_cache_int8 and not bc.fused_attention:
        raise ValueError("kv_cache_int8 requires the fused-attention "
                         "row-major lane-beams path (fused_attention)")
    return bc


def cast_params_for_decode(model: gpt2.GPT2LMHeadModel,
                           cfg: gpt2.GPT2Config) -> gpt2.GPT2LMHeadModel:
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


def _assign_lanes(src: torch.Tensor, R: int) -> torch.Tensor:
    """Assign the R ranked winners of each image to physical cache lanes.

    The first (best-ranked) winner descending from each source lane stays
    IN that lane (its cache row needs no movement); the remaining winners
    take the lanes no primary claimed, in rank order. A lane is overwritten
    only if its own beam produced no primary (nobody reads it), so fork
    copies are hazard-free in place.

    src: [N, R] source lane of each ranked winner. Returns lane_of_rank
    [N, R], a permutation of 0..R-1 per image."""
    oh = torch.nn.functional.one_hot(src, R)                   # [N, W, S]
    claims_before = oh.cumsum(1) - oh
    is_primary = (oh * claims_before).sum(2) == 0               # [N, W]
    claimed = (oh * is_primary[..., None]).sum(1)               # [N, S]
    free = 1 - claimed
    free_idx = free.cumsum(1) - free
    nonprim = (~is_primary).long()
    nonprim_idx = nonprim.cumsum(1) - nonprim
    free_oh = free[:, None, :] * (free_idx[:, None, :]
                                  == nonprim_idx[:, :, None])
    lane_oh = torch.where(is_primary[..., None], oh, free_oh)
    return lane_oh.argmax(2)


def _to_lane(x_w: torch.Tensor, lane_of_rank: torch.Tensor) -> torch.Tensor:
    """Scatter per-winner data [N, W, ...] to the winners' lanes."""
    idx = lane_of_rank.reshape(*lane_of_rank.shape,
                               *([1] * (x_w.dim() - 2))).expand_as(x_w)
    return torch.empty_like(x_w).scatter_(1, idx, x_w)


def _take_rows(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """x[n, rows[n, w], ...] for each image n: [N, S, ...] -> [N, W, ...]."""
    idx = rows.reshape(*rows.shape, *([1] * (x.dim() - 2))).expand(
        *rows.shape, *x.shape[2:])
    return x.gather(1, idx)


def _fork_copy(bc: BeamConfig):
    """The fork fix-up of the configuration: fork(cache, src, count)
    updates the generated cache in place (count = live slots)."""
    kernels = not bc.plain_ops
    cr = cache_reorder
    if bc.bounded_fork_copy:
        rows = (cr.copy_forked_rows_bounded if kernels
                else cr.copy_forked_rows_bounded_plain)
    else:
        whole = cr.copy_forked_rows if kernels else cr.copy_forked_rows_plain
        rows = lambda k, v, src, count: whole(k, v, src)

    def fork(cache, src, count):
        rows(cache["k"], cache["v"], src, count)
        if "ks" in cache:  # int8 scales: tiny, plain indexing
            cache["ks"] = cache["ks"][src]
            cache["vs"] = cache["vs"][src]
    return fork


@torch.no_grad()
def _beam_search_impl(model: gpt2.GPT2LMHeadModel, cfg: gpt2.GPT2Config,
                      bc: BeamConfig, prefix_embeds: torch.Tensor):
    N, K, D = prefix_embeds.shape
    R, E = bc.beam_size, bc.entry_length
    dev = prefix_embeds.device
    kernels = not bc.plain_ops
    model = cast_params_for_decode(model, cfg)
    wte = model.transformer.wte.weight
    logits0, prefix_cache = gpt2.prefill(model, cfg, prefix_embeds)
    if bc.kv_cache_int8 and bc.int8_prefix:
        prefix_cache = gpt2.quantize_prefix_cache(prefix_cache)
    logp0 = torch.log_softmax(logits0.float(), dim=-1)

    # Step 0 (reference "scores is None" branch): per-image top-R.
    scores, toks0 = lm_head._top_k(logp0, R)                 # [N, R]
    tokens = torch.zeros(N, R, E, dtype=torch.int64, device=dev)
    tokens[:, :, 0] = toks0
    seq_lengths = torch.ones(N, R, dtype=torch.float32, device=dev)
    is_stopped = toks0 == bc.stop_token

    E_pad = -(-E // SLOT_ALIGN) * SLOT_ALIGN
    buckets = staging.stage_buckets(E_pad, bc.cache_stages, SLOT_ALIGN)
    # the slot-bounded kernels tile each stage's cache by whole chunks
    chunks = int(bc.fused_slot_chunks or 0) if bc.fused_attention else 0
    staging.check_chunks(buckets, chunks)
    init_cache = (gpt2.init_gen_cache_rowmajor_int8 if bc.kv_cache_int8
                  else gpt2.init_gen_cache_rowmajor)
    gen_cache = init_cache(cfg, N * R,
                           buckets[-1] if bc.full_alloc else buckets[0],
                           device=dev)
    cur = gpt2.embed_tokens(model, toks0.reshape(N * R))      # [B, D]
    fork_copy = _fork_copy(bc)
    topk = lm_head.lm_head_topk if bc.fused_lm_head and kernels \
        else lm_head.lm_head_topk_plain
    # rank -> lane map of the latest selection (identity at step 0, where
    # ranks ARE lanes); restores rank order at the end.
    lane_of_rank = torch.arange(R, device=dev).expand(N, R)
    # Fork copy of the previous selection, applied at the start of the
    # next step (identity at step 1: nothing moves).
    pending_src = torch.arange(N * R, device=dev)
    image_base = torch.arange(N, device=dev)[:, None] * R

    i = 1
    for cap in buckets:
        if i >= E or bool(is_stopped.all()):
            break  # done: later stages neither run nor grow the cache
        if gen_cache["k"].shape[2] < cap:
            gen_cache = staging.grow_cache(
                gen_cache, init_cache(cfg, N * R, cap, device=dev))
        while i < E and i <= cap and not bool(is_stopped.all()):
            # slots 0..i-2 are live history; decode_step writes slot i-1
            fork_copy(gen_cache, pending_src, i - 1)
            hidden = gpt2.decode_step(
                model, cfg, cur, prefix_cache, gen_cache, i - 1, e_cap=cap,
                fused_attention=bool(bc.fused_attention) and kernels,
                chunk_slot_write=kernels and (bool(bc.chunk_slot_write)
                                              or bc.kv_cache_int8),
                fused_slot_chunks=chunks)
            # Per-beam shortlist: adding the beam's score and dividing by
            # its length are monotonic within a beam, so the flat top-R
            # over beam x vocab picks only from each beam's own top-R.
            cand_val, cand_tok, lse = topk(hidden, wte, R)
            cand_logp = (cand_val - lse[:, None]).reshape(N, R, R)
            cand_tok = cand_tok.reshape(N, R, R)
            stopped = is_stopped[:, :, None]
            cand_logp = torch.where(stopped, NEG, cand_logp)
            cand_logp[:, :, 0] = torch.where(is_stopped, 0.0,
                                             cand_logp[:, :, 0])
            cand_tok = torch.where(stopped, 0, cand_tok)
            scores_sum = scores[:, :, None] + cand_logp        # [N, R, R]
            seq_lengths = seq_lengths + (~is_stopped).float()
            avg = scores_sum / seq_lengths[:, :, None]
            top_avg, flat_idx = lm_head._top_k(avg.reshape(N, R * R), R)
            src = flat_idx // R                                # [N, W]
            lane_of_rank = _assign_lanes(src, R)
            nxt = _to_lane(cand_tok.reshape(N, R * R).gather(1, flat_idx),
                           lane_of_rank)
            seq_lengths = _to_lane(seq_lengths.gather(1, src), lane_of_rank)
            is_stopped = _to_lane(is_stopped.gather(1, src), lane_of_rank)
            tokens = _to_lane(_take_rows(tokens, src), lane_of_rank)
            scores = _to_lane(top_avg, lane_of_rank) * seq_lengths
            pending_src = (image_base
                           + _to_lane(src, lane_of_rank)).reshape(-1)
            tokens[:, :, i] = nxt
            is_stopped = is_stopped | (nxt == bc.stop_token)
            cur = gpt2.embed_tokens(model, nxt.reshape(N * R))
            i += 1

    # restore the reference's rank ordering of the returned beams
    tokens = _take_rows(tokens, lane_of_rank)
    seq_lengths = seq_lengths.gather(1, lane_of_rank)
    scores = scores.gather(1, lane_of_rank)
    final_scores = scores / seq_lengths
    order = torch.argsort(-final_scores, dim=1, stable=True)
    return tokens, seq_lengths, final_scores, order


def beam_search(model: gpt2.GPT2LMHeadModel, cfg: gpt2.GPT2Config,
                prefix_embeds: torch.Tensor, bc: BeamConfig = BeamConfig()
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """Decode a batch of prefix embeddings [N, K, D] on their device.

    Returns (tokens [N,R,E] int64, seq_lengths [N,R], scores [N,R],
    order [N,R]) where `order` ranks beams by length-normalised score
    descending."""
    return _beam_search_impl(model, cfg, resolve_config(bc), prefix_embeds)


def beam_texts(tokenizer, tokens, seq_lengths, order) -> List[List[str]]:
    """Host-side finalization: decode each image's beams in ranked order
    (reference gpt2_prefix_eval.py:110-115)."""
    tokens, seq_lengths, order = (t.cpu().numpy() for t in
                                  (tokens, seq_lengths, order))
    out = []
    for n in range(tokens.shape[0]):
        texts = [tokenizer.decode(tokens[n, r, :int(seq_lengths[n, r])])
                 for r in range(tokens.shape[1])]
        out.append([texts[r] for r in order[n]])
    return out


def beam_top_select(tokens: torch.Tensor, seq_lengths: torch.Tensor,
                    order: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank-0 beam per image, selected on the device: tokens [N,R,E] ->
    [N,E], seq_lengths [N,R] -> [N], so only 1/R of the beams cross to
    the host."""
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    top = order[:, 0]
    return tokens[rows, top], seq_lengths[rows, top]


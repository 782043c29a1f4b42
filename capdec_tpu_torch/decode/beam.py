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

This is the lane-mode, full-allocation path of the JAX engine
(`_beam_search_impl`, beam.py:271-553):
  * Each image's R beams live in R cache lanes. A winner that descends
    from a lane without an earlier-ranked sibling stays in that lane;
    the others take the lanes no one claimed (`_assign_lanes`). Only
    forked lanes copy cache rows, lazily at the start of the next step
    (kernel K4, `copy_forked_rows_bounded`, slots < i - 1).
  * The generated cache is allocated once at entry_length rounded up to
    8 slots; the stage buckets bound each stage's attention reads
    (`e_cap`).
  * Each step: decode_step (kernels K2 and K3), then the fused LM head
    with top-R and logsumexp (kernel K1), then the selection on the
    R*R-candidate shortlist. A final rank permutation restores the
    reference's beam order.
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
# Stage count of the full-size cache's read bounds (e_cap buckets) and the
# slot alignment of the cache, as in the JAX engine's defaults.
CACHE_STAGES = 8
SLOT_ALIGN = 8


@dataclasses.dataclass(frozen=True)
class BeamConfig:
    beam_size: int = 5
    entry_length: int = 67
    stop_token: int = GPT2_DOT_TOKEN
    # Kernel knobs: True runs the op's kernel wrapper (the hand-written
    # kernel on CUDA tensors, its plain version on CPU tensors); False runs
    # the op's plain PyTorch version everywhere. None = auto (True).
    fused_attention: Optional[bool] = None      # K2
    chunk_slot_write: Optional[bool] = None     # K3
    fused_lm_head: Optional[bool] = None        # K1
    bounded_fork_copy: Optional[bool] = None    # K4
    # Full-size allocation with stage-bounded reads; the JAX engine's
    # staged cache growth (False) is not ported.
    full_alloc: Optional[bool] = None

    def plain(self) -> "BeamConfig":
        """This configuration with every op's plain PyTorch version."""
        return dataclasses.replace(
            self, fused_attention=False, chunk_slot_write=False,
            fused_lm_head=False, bounded_fork_copy=False)


def resolve_config(bc: BeamConfig) -> BeamConfig:
    """Resolve every None (auto) knob: the kernels and full_alloc on."""
    for knob in ("fused_attention", "chunk_slot_write", "fused_lm_head",
                 "bounded_fork_copy", "full_alloc"):
        if getattr(bc, knob) is None:
            bc = dataclasses.replace(bc, **{knob: True})
    if not bc.full_alloc:
        raise NotImplementedError(
            "staged cache growth (full_alloc=False) is not ported "
            "(ROADMAP.md Queue 1, item 4: beam engine)")
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


@torch.no_grad()
def _beam_search_impl(model: gpt2.GPT2LMHeadModel, cfg: gpt2.GPT2Config,
                      bc: BeamConfig, prefix_embeds: torch.Tensor):
    N, K, D = prefix_embeds.shape
    R, E = bc.beam_size, bc.entry_length
    dev = prefix_embeds.device
    model = cast_params_for_decode(model, cfg)
    wte = model.transformer.wte.weight
    logits0, prefix_cache = gpt2.prefill(model, cfg, prefix_embeds)
    logp0 = torch.log_softmax(logits0.float(), dim=-1)

    # Step 0 (reference "scores is None" branch): per-image top-R.
    scores, toks0 = lm_head._top_k(logp0, R)                 # [N, R]
    tokens = torch.zeros(N, R, E, dtype=torch.int64, device=dev)
    tokens[:, :, 0] = toks0
    seq_lengths = torch.ones(N, R, dtype=torch.float32, device=dev)
    is_stopped = toks0 == bc.stop_token

    E_pad = -(-E // SLOT_ALIGN) * SLOT_ALIGN
    buckets = staging.stage_buckets(E_pad, CACHE_STAGES, SLOT_ALIGN)
    gen_cache = gpt2.init_gen_cache_rowmajor(cfg, N * R, buckets[-1],
                                             device=dev)
    cur = gpt2.embed_tokens(model, toks0.reshape(N * R))      # [B, D]
    fork_copy = (cache_reorder.copy_forked_rows_bounded
                 if bc.bounded_fork_copy
                 else cache_reorder.copy_forked_rows_bounded_plain)
    topk = lm_head.lm_head_topk if bc.fused_lm_head \
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
        while i < E and i <= cap and not bool(is_stopped.all()):
            # slots 0..i-2 are live history; decode_step writes slot i-1
            fork_copy(gen_cache["k"], gen_cache["v"], pending_src, i - 1)
            hidden = gpt2.decode_step(
                model, cfg, cur, prefix_cache, gen_cache, i - 1, e_cap=cap,
                fused_attention=bc.fused_attention,
                chunk_slot_write=bc.chunk_slot_write)
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


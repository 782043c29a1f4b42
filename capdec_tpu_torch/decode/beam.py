"""Batched, KV-cached beam search (port of capdec_tpu/decode/beam.py).

The reference beam semantics (gpt2_prefix_eval.py:50-115), as the JAX
engine implements them:
  * log-softmax scores (of the logits over `temperature`, where it is
    neither <= 0 nor 1); length-normalised top-R over beam x candidates,
    with (source beam, token) recovered by integer div/mod
  * stopped beams pinned: every candidate -inf except token 0 at logp 0,
    so a stopped beam survives with frozen score and length
  * seq_lengths grow only for alive beams; the selected average is
    multiplied back by the gathered length (`scores = avg * len`)
  * stop token '.' (id 13 in GPT-2), entry_length cap, final ranking by
    scores / seq_lengths descending; the loop ends when all beams stop.

Every path of the JAX engine (`_beam_search_impl`, beam.py:271-553):
  * Lane mode (`lane_beams`, the default): each image's R beams live in R
    cache lanes. A winner that descends from a lane without an
    earlier-ranked sibling stays in that lane; the others take the lanes
    no one claimed (`_assign_lanes`). The previous selection's moves are
    applied at the start of the next step: on the row-major cache only
    forked lanes copy rows, slots < i - 1 (kernel K4,
    `copy_forked_rows_bounded`) or whole rows (K7, `copy_forked_rows`);
    the seq-major cache (`rowmajor_cache=False`) is gathered whole by the
    lanes' sources (K11, `reorder_cache_rows`). A final rank permutation
    restores the reference's beam order.
  * Non-lane mode (`lane_beams=False`): beams stay in rank order and the
    whole cache is gathered by the winners' sources after each selection
    (K10 `reorder_rows_leading` on the row-major cache, K11 on the
    seq-major one).
  * Ancestry (`ancestry=True`, non-lane): the cache never moves; a table
    of the cache row that holds each beam's slot follows the selections
    and the attention reads through it (the plain attention math).
  * The cache runs in stages (`staging.stage_buckets`, lane mode only).
    With `full_alloc` it is allocated once at entry_length rounded up to
    8 slots and each stage's bucket bounds the attention reads (`e_cap`);
    otherwise it is allocated at the first bucket and grows between
    stages (`staging.grow_cache`).
  * The generated cache is bf16/f32, or int8 levels with per-slot scales
    (`kv_cache_int8`, row-major lane mode), whose scales follow the row
    moves by indexing. With `int8_prefix` the prefix cache is quantised
    once after prefill.
  * The decoder is GPT-2 or the MLA-MoE decoder, by the type of `cfg`
    (models/decoders.py); the latter decodes on the lane-mode row-major
    path only (K16 on its latent cache, K3/K4 moving the latent as one
    tensor) and refuses the others.
  * Each step: decode_step (row-major: kernels K2 and the slot write K3
    or K14, or K6 and K5 over int8; with `fused_slot_chunks` the
    slot-bounded K8, or K9 over int8; seq-major and ancestry: the plain
    attention math), then the fused LM head with top-R and logsumexp
    (kernel K1), or under a temperature the logits, scaled, with their
    logsumexp and top-R; then the selection on the R*R-candidate
    shortlist, and the read of the stop flag. Each step is the span
    `decode.step` (its `step`), from its first launch to the end of that
    read (`decode.stop_flag`, utils/profiling.py).
The JAX engine's one-hot contractions (TPU gather workarounds) are plain
indexing here; the loop is a Python loop. The out-of-place gathers
(K10, K11) take a fresh output cache from PyTorch's caching allocator
each step and the input is freed when the cache is rebound, so two
cache buffers alternate.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import staging
from ..models import decoders, gpt2
from ..ops import _build, cache_reorder, lm_head
from ..utils import profiling
from ..utils.tokenizer import GPT2_DOT_TOKEN

NEG = -1e30
# Slot alignment of the cache and its stage buckets, as in the JAX engine.
SLOT_ALIGN = 8


@dataclasses.dataclass(frozen=True)
class BeamConfig:
    beam_size: int = 5
    entry_length: int = 67
    # Logits are divided by it where it is neither <= 0 nor 1 (the
    # reference default is 1); then the LM head runs unfused.
    temperature: float = 1.0
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
    # Lane-assigned beams with fork copies (True), or beams in rank order
    # with the whole cache gathered after each selection (False).
    lane_beams: bool = True
    # Row-major [B, L, E, D] generated cache (True), or seq-major
    # [L, B, E, D] (False: plain attention, whole-cache gathers).
    rowmajor_cache: bool = True
    # Ancestry attention: the cache never moves; each beam reads its slots
    # from the rows that hold them (non-lane; plain attention).
    ancestry: bool = False
    # The cache gathers' kernels, K10/K11 (True), or their plain versions
    # (False); also the default of the other kernel knobs, as in JAX.
    # None = auto (True: the card).
    pallas_reorder: Optional[bool] = None
    # The row-major slot write by K14 where chunk_slot_write is off (the
    # same one-slot update as K3). None = auto (False, as in JAX).
    pallas_slot_write: Optional[bool] = None
    # Run every chosen op's plain PyTorch version instead of its kernel
    # (the engine runs inside `_build.plain_ops`): the card's reference
    # path (counterpart of the JAX engine's fused_interpret).
    plain_ops: bool = False

    def plain(self) -> "BeamConfig":
        """This configuration with every op's plain PyTorch version."""
        return dataclasses.replace(self, plain_ops=True)


def _auto(bc: BeamConfig, knob: str, value) -> BeamConfig:
    """`bc` with `knob` set to `value` where it is None (auto)."""
    if getattr(bc, knob) is not None:
        return bc
    return dataclasses.replace(bc, **{knob: value})


def _scaled(temperature: float) -> bool:
    """Whether the logits are divided by the temperature."""
    return temperature > 0 and temperature != 1.0


def resolve_config(bc: BeamConfig) -> BeamConfig:
    """Resolve every None (auto) knob as the JAX engine does on the TPU
    (capdec_tpu/decode/beam.py:584-643, with `pallas_reorder` on, as its
    autodetect finds there), and refuse what it refuses."""
    bc = _auto(bc, "pallas_reorder", True)
    bc = _auto(bc, "pallas_slot_write", False)
    bc = _auto(bc, "fused_attention",
               bool(bc.pallas_reorder) and bc.rowmajor_cache)
    bc = _auto(bc, "chunk_slot_write", bool(bc.fused_attention))
    bc = _auto(bc, "fused_slot_chunks", 0)
    # A full-size cache with stage-bounded reads on the v2 row-major lane
    # path only: v3 keeps its own staging, and int8 keeps staged growth
    # (the JAX engine measured it faster there).
    bc = _auto(bc, "full_alloc",
               bool(bc.fused_attention) and not bc.fused_slot_chunks
               and bc.lane_beams and bc.rowmajor_cache and not bc.ancestry
               and not bc.kv_cache_int8)
    bc = _auto(bc, "bounded_fork_copy",
               bool(bc.fused_slot_chunks or bc.full_alloc)
               and bool(bc.pallas_reorder) and bc.rowmajor_cache)
    bc = _auto(bc, "int8_prefix",
               bc.kv_cache_int8 and bool(bc.fused_slot_chunks))
    bc = _auto(bc, "fused_lm_head",
               bool(bc.pallas_reorder) and not _scaled(bc.temperature))
    if bc.fused_lm_head and _scaled(bc.temperature):
        raise ValueError("fused_lm_head requires temperature == 1")
    if bc.kv_cache_int8 and not (bc.rowmajor_cache and _use_lanes(bc)
                                 and bc.fused_attention):
        raise ValueError(
            "kv_cache_int8 requires the fused-attention row-major "
            "lane-beams path (rowmajor_cache + lane_beams + "
            "fused_attention)")
    return bc


def cast_params_for_decode(model, cfg):
    """The decoder cast once for decode, by its own rule
    (models/decoders.py): GPT-2's matrices in the compute dtype and its
    biases and layernorms in float32; the MLA-MoE decoder's matrices as
    they are when already in the compute dtype."""
    return decoders.of(cfg).cast_params_for_decode(model, cfg)


def _check_decoder(dec, bc: BeamConfig) -> None:
    """Refuse the paths a decoder other than GPT-2 does not take: it
    runs the lane-mode row-major path with bounded fork copies only."""
    if dec is gpt2:
        return
    if bc.kv_cache_int8 or not bc.rowmajor_cache or not _use_lanes(bc) \
            or bc.fused_slot_chunks or not bc.bounded_fork_copy:
        raise NotImplementedError(
            f"{dec.__name__} decodes on the lane-mode row-major path with "
            "bounded fork copies only (no int8 cache, seq-major cache, "
            "non-lane beams, ancestry or slot-bounded kernels)")


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


def _use_lanes(bc: BeamConfig) -> bool:
    """Lane mode: lane-assigned beams, never under ancestry (JAX
    beam.py:307)."""
    return bc.lane_beams and not bc.ancestry


def _inv_temperature(temperature: float) -> Optional[float]:
    """1 / temperature rounded to float32 where it scales the logits, else
    None. Jitted JAX multiplies by that reciprocal (XLA rewrites a
    division by a constant), so the port does too, bit for bit."""
    if not _scaled(temperature):
        return None
    return float(np.float32(1.0) / np.float32(temperature))


def _fork_copy(bc: BeamConfig):
    """The fork fix-up of the row-major lane path: fork(cache, src, count)
    updates the generated cache in place (count = live slots) and returns
    it."""
    cr = cache_reorder

    def fork(cache, src, count):
        # a cache of one tensor (the MLA latent) has no "v"
        k, v = cache["k"], cache.get("v")
        if bc.bounded_fork_copy:
            cr.copy_forked_rows_bounded(k, v, src, count)
        else:
            cr.copy_forked_rows(k, v, src)
        if "ks" in cache:  # int8 scales: tiny, plain indexing
            cache["ks"] = cache["ks"][src]
            cache["vs"] = cache["vs"][src]
        return cache
    return fork


def _gather(bc: BeamConfig):
    """The whole-cache gather of the configuration (JAX
    `_reorder_gen_cache`, beam.py:53-77): gather(cache, src) returns a new
    cache whose row b is row src[b]. K10 on the row-major cache, K11 on
    the seq-major one, or their plain versions (`pallas_reorder=False`)."""
    cr = cache_reorder
    if bc.rowmajor_cache:
        rows = cr.reorder_rows_leading if bc.pallas_reorder \
            else cr.reorder_rows_leading_plain
    else:
        rows = cr.reorder_cache_rows if bc.pallas_reorder \
            else cr.reorder_cache_rows_plain

    def gather(cache, src):
        out = rows(cache["k"], cache["v"], src)
        if "ks" in cache:  # int8 scales: tiny, plain indexing
            out.update(ks=cache["ks"][src], vs=cache["vs"][src])
        return out
    return gather


def _lane_fixup(bc: BeamConfig):
    """The lane path's deferred move of the previous selection (JAX
    beam.py:368-392): fixup(cache, src, count) -> cache. Fork copies in
    place on the row-major cache with the kernels' route
    (`pallas_reorder`), else the whole-cache gather."""
    if bc.rowmajor_cache and bc.pallas_reorder:
        return _fork_copy(bc)
    gather = _gather(bc)
    return lambda cache, src, count: gather(cache, src)


@torch.no_grad()
def _beam_search_impl(model, cfg, bc: BeamConfig,
                      prefix_embeds: torch.Tensor, counters=None):
    N, K, D = prefix_embeds.shape
    dec = decoders.of(cfg)
    _check_decoder(dec, bc)
    R, E = bc.beam_size, bc.entry_length
    dev = prefix_embeds.device
    use_lanes = _use_lanes(bc)
    # the fused row-major route (JAX beam.py:284-285); the seq-major cache
    # and ancestry attention run the plain attention math
    fused_path = (bool(bc.fused_attention) and bc.rowmajor_cache
                  and not bc.ancestry)
    model = cast_params_for_decode(model, cfg)
    wte = dec.lm_head_weight(model)
    logits0, prefix_cache = dec.prefill(model, cfg, prefix_embeds)
    if counters is not None:
        counters.update({n: prefix_cache[n] for n in dec.DECODE_COUNTERS})
    if bc.kv_cache_int8 and bc.int8_prefix:
        prefix_cache = gpt2.quantize_prefix_cache(prefix_cache)
    inv_t = _inv_temperature(bc.temperature)
    if inv_t is not None:
        logits0 = logits0 * inv_t
    logp0 = torch.log_softmax(logits0.float(), dim=-1)

    # Step 0 (reference "scores is None" branch): per-image top-R.
    scores, toks0 = lm_head._top_k(logp0, R)                 # [N, R]
    tokens = torch.zeros(N, R, E, dtype=torch.int64, device=dev)
    tokens[:, :, 0] = toks0
    seq_lengths = torch.ones(N, R, dtype=torch.float32, device=dev)
    is_stopped = toks0 == bc.stop_token

    E_pad = -(-E // SLOT_ALIGN) * SLOT_ALIGN
    buckets = staging.stage_buckets(
        E_pad, bc.cache_stages if use_lanes else 1, SLOT_ALIGN)
    # the slot-bounded kernels tile each stage's cache by whole chunks
    chunks = int(bc.fused_slot_chunks or 0) if fused_path else 0
    staging.check_chunks(buckets, chunks)
    if bc.kv_cache_int8:
        init_cache = gpt2.init_gen_cache_rowmajor_int8
    elif bc.rowmajor_cache:
        init_cache = dec.init_gen_cache_rowmajor
    else:
        init_cache = gpt2.init_gen_cache
    # a tp rank's blocks hold n_head / tp heads: its cache is that wide
    init_cache = functools.partial(init_cache, width=dec.kv_width(model))
    gen_cache = init_cache(cfg, N * R,
                           buckets[-1] if bc.full_alloc else buckets[0],
                           device=dev)
    cur = dec.embed_tokens(model, toks0.reshape(N * R))       # [B, D]
    lane_fixup = _lane_fixup(bc)
    gather = _gather(bc)
    step_kw = dict(
        rowmajor=bc.rowmajor_cache, fused_attention=fused_path,
        chunk_slot_write=(bool(bc.chunk_slot_write) and bc.rowmajor_cache)
        or bc.kv_cache_int8,
        slot_write_kernel=bool(bc.pallas_slot_write) and bc.rowmajor_cache,
        fused_slot_chunks=chunks, return_hidden=bool(bc.fused_lm_head))
    # rank -> lane map of the latest selection (identity at step 0, where
    # ranks ARE lanes, and outside lane mode); restores rank order at the
    # end.
    lane_of_rank = torch.arange(R, device=dev).expand(N, R)
    # Lane moves of the previous selection, applied at the start of the
    # next step (identity at step 1: nothing moves).
    pending_src = torch.arange(N * R, device=dev)
    image_base = torch.arange(N, device=dev)[:, None] * R
    # Ancestry: anc[n, q, e] is the row of image n (0..R-1) whose cache
    # holds beam q's slot e (the JAX engine's one-hot [N, R, R, E] table
    # as indices). A slot is written row-identically, then the table
    # follows each selection's sources.
    anc = (torch.zeros(N, R, E_pad, dtype=torch.int64, device=dev)
           if bc.ancestry else None)

    i = 1
    for cap in buckets:
        if i >= E or staging.all_stopped(is_stopped):
            break  # done: later stages neither run nor grow the cache
        if gen_cache["k"].shape[2] < cap:
            gen_cache = staging.grow_cache(
                gen_cache, init_cache(cfg, N * R, cap, device=dev))
        more = i < E and i <= cap and not staging.all_stopped(is_stopped)
        while more:
            with profiling.span("decode.step", step=i):
                if use_lanes:
                    # slots 0..i-2 are live history; decode_step writes i-1
                    gen_cache = lane_fixup(gen_cache, pending_src, i - 1)
                anc_rows = None if anc is None else \
                    (image_base[:, :, None] + anc).reshape(N * R, E_pad)
                out = dec.decode_step(model, cfg, cur, prefix_cache,
                                      gen_cache, i - 1, e_cap=cap,
                                      anc_rows=anc_rows, **step_kw)
                # Per-beam shortlist: adding the beam's score and dividing by
                # its length are monotonic within a beam, so the flat top-R
                # over beam x vocab picks only from each beam's own top-R.
                if bc.fused_lm_head:
                    cand_val, cand_tok, lse = lm_head.lm_head_topk(
                        out, wte, R)
                else:  # `out` is the f32 logits
                    logits = out if inv_t is None else out * inv_t
                    lse = torch.logsumexp(logits, dim=-1)
                    cand_val, cand_tok = lm_head._top_k(logits, R)
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
                nxt = cand_tok.reshape(N, R * R).gather(1, flat_idx)
                seq_lengths = seq_lengths.gather(1, src)
                is_stopped = is_stopped.gather(1, src)
                tokens = _take_rows(tokens, src)
                if use_lanes:
                    lane_of_rank = _assign_lanes(src, R)
                    nxt, seq_lengths, is_stopped, tokens, top_avg = (
                        _to_lane(x, lane_of_rank) for x in
                        (nxt, seq_lengths, is_stopped, tokens, top_avg))
                    pending_src = (image_base
                                   + _to_lane(src, lane_of_rank)).reshape(-1)
                elif anc is not None:
                    # no cache movement: slot i-1 was written row-identically
                    anc[:, :, i - 1] = torch.arange(R, device=dev)
                    anc = _take_rows(anc, src)
                else:
                    gen_cache = gather(gen_cache,
                                       (image_base + src).reshape(-1))
                scores = top_avg * seq_lengths
                tokens[:, :, i] = nxt
                is_stopped = is_stopped | (nxt == bc.stop_token)
                cur = dec.embed_tokens(model, nxt.reshape(N * R))
                i += 1
                more = i < E and i <= cap and \
                    not staging.all_stopped(is_stopped)

    staging.add_steps(i - 1)
    # restore the reference's rank ordering of the returned beams
    tokens = _take_rows(tokens, lane_of_rank)
    seq_lengths = seq_lengths.gather(1, lane_of_rank)
    scores = scores.gather(1, lane_of_rank)
    final_scores = scores / seq_lengths
    order = torch.argsort(-final_scores, dim=1, stable=True)
    return tokens, seq_lengths, final_scores, order


def beam_search(model, cfg, prefix_embeds: torch.Tensor,
                bc: BeamConfig = BeamConfig(), counters=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """Decode a batch of prefix embeddings [N, K, D] on their device with
    the decoder `cfg` names (models/decoders.py: GPT-2's model and
    GPT2Config, or the MLA-MoE decoder's).

    Returns (tokens [N,R,E] int64, seq_lengths [N,R], scores [N,R],
    order [N,R]) where `order` ranks beams by length-normalised score
    descending. `counters` (a dict), when given, takes the batch's device
    counters by name (the decoder's DECODE_COUNTERS, filled as the steps
    run; none for GPT-2). With `bc.plain_ops` the whole search runs
    inside `_build.plain_ops`."""
    with _build.plain_ops(bc.plain_ops):
        return _beam_search_impl(model, cfg, resolve_config(bc),
                                 prefix_embeds, counters)


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


def beam_top_texts(tokenizer, tokens: torch.Tensor, seq_lengths: torch.Tensor,
                   order: torch.Tensor) -> List[str]:
    """Best caption per image: `[t[0] for t in beam_texts(...)]`, with
    only the ranked-first beams copied to the host and detokenized."""
    top_toks, top_lens = beam_top_select(tokens, seq_lengths, order)
    t, ln = top_toks.cpu().numpy(), top_lens.cpu().numpy()
    return [tokenizer.decode(t[n, :int(ln[n])]) for n in range(t.shape[0])]

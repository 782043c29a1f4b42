"""The decoder behind the mapper, chosen by the type of its configuration.

A decoder is a module with the functions the beam engine
(decode/beam.py) and the server (serve.py) call, so that neither names
one decoder:

  prefill(model, cfg, prefix_embeds) -> (last-position logits [N, V] f32,
                                         prefix cache)
  init_gen_cache_rowmajor(cfg, batch, max_new, dtype=, device=, width=)
  embed_tokens(model, tokens) -> [B, D]
  decode_step(model, cfg, token_embed, prefix_cache, gen_cache, step, **kw)
  lm_head_weight(model) -> [V, D], K1's weights
  kv_width(model) -> the width of a cache row
  cast_params_for_decode(model, cfg) -> the model cast once for decode
  DECODE_COUNTERS      names of the prefix cache's device counters that
                       decode_step adds to (CaptionServer.stats)

`models/gpt2.py` (GPT2Config; every path of the engines) and
`models/mla_moe.py` (MLAMoEConfig; the lane-mode row-major beam path).
"""
from __future__ import annotations

from . import gpt2, mla_moe


def of(cfg):
    """The decoder module of a decoder configuration: the MLA-MoE decoder
    for an MLAMoEConfig, GPT-2 for any other (a GPT2Config, or what tests
    put in its place)."""
    return mla_moe if isinstance(cfg, mla_moe.MLAMoEConfig) else gpt2

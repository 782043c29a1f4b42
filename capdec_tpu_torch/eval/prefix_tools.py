"""Prefix-interpretation tools (port of capdec_tpu/eval/prefix_tools.py;
reference gpt2_prefix_eval.py:201-292).

Qualitative utilities for poking at learned prefixes:
  * nearest-vocab-token readout of prefix embeddings (cosine vs wte)
  * prefix editing: insert a text span's embeddings at a position, delete
    positions, try-all-insertion-points
  * a qualitative inspection loop over chosen image ids
Prefixes are [1, P, D] tensors on the model's device.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..decode import BeamConfig, ToppConfig, beam_search, beam_texts, \
    greedy_topp_search, topp_texts
from ..models import caption_model, gpt2


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


@torch.no_grad()
def get_prefix_tokens(model: caption_model.ClipCaptionModel,
                      prefix_embed: torch.Tensor, tokenizer) -> str:
    """Decode each prefix slot to its nearest vocab token (reference
    :247-251): cosine similarity of the normalized prefix against the
    normalized embedding table, argmax, detokenize."""
    wte = model.gpt.transformer.wte.weight
    sim = _unit(prefix_embed[0].float()) @ _unit(wte.float()).T
    return tokenizer.decode(sim.argmax(-1).cpu().numpy())


@torch.no_grad()
def add_embedding_from_text(model: caption_model.ClipCaptionModel, text: str,
                            prefix_embed: torch.Tensor, tokenizer,
                            where: int) -> torch.Tensor:
    """Insert the wte embeddings of `text` into the prefix at `where`
    (reference :201-212; -1 or len appends)."""
    ids = torch.as_tensor(tokenizer.encode(text), device=prefix_embed.device)
    tok_embed = gpt2.embed_tokens(model.gpt, ids)[None].to(prefix_embed.dtype)
    P = prefix_embed.shape[1]
    if where == -1 or where == P:
        parts = (prefix_embed, tok_embed)
    elif where == 0:
        parts = (tok_embed, prefix_embed)
    else:
        parts = (prefix_embed[:, :where], tok_embed, prefix_embed[:, where:])
    return torch.cat(parts, dim=1)


def remove_positions(prefix_embed: torch.Tensor,
                     where: Sequence[int]) -> torch.Tensor:
    """Drop prefix slots (reference :229-237)."""
    drop = set(where)
    keep = [i for i in range(prefix_embed.shape[1]) if i not in drop]
    return prefix_embed[:, keep]


def generate_text(model: caption_model.ClipCaptionModel,
                  cfg: caption_model.CaptionModelConfig,
                  prefix_embed: torch.Tensor, tokenizer,
                  use_beam: bool = True) -> str:
    if use_beam:
        toks, lens, _, order = beam_search(model.gpt, cfg.gpt2, prefix_embed,
                                           BeamConfig())
        return beam_texts(tokenizer, toks, lens, order)[0][0]
    toks, lens = greedy_topp_search(model.gpt, cfg.gpt2, prefix_embed,
                                    ToppConfig())
    return topp_texts(tokenizer, toks, lens)[0]


def re_caption(model, cfg, add_in: str, prefix_embed, tokenizer,
               where: int, use_beam: bool = True) -> str:
    new_prefix = add_embedding_from_text(model, add_in, prefix_embed,
                                         tokenizer, where)
    return generate_text(model, cfg, new_prefix, tokenizer, use_beam)


def try_all_places(model, cfg, add_in: str, prefix_embed, tokenizer,
                   use_beam: bool = True) -> List[str]:
    return [re_caption(model, cfg, add_in, prefix_embed, tokenizer, i,
                       use_beam)
            for i in range(prefix_embed.shape[1])]


def inspect_samples(model: caption_model.ClipCaptionModel,
                    cfg: caption_model.CaptionModelConfig,
                    dataset, tokenizer, image_ids: Sequence,
                    use_beam: bool = True,
                    max_items: Optional[int] = None) -> List[dict]:
    """Qualitative loop (reference :254-292): for each matching sample,
    print GT caption, prefix readout, and the generated caption."""
    wanted = {str(i) for i in image_ids}
    device = next(model.parameters()).device
    out = []
    for idx in range(len(dataset)):
        if str(dataset.image_ids[idx]) not in wanted:
            continue
        prefix = torch.as_tensor(dataset.batch_prefixes(np.asarray([idx])),
                                 device=device)
        prefix_embed = caption_model.map_prefix(model, cfg, prefix)
        readout = get_prefix_tokens(model, prefix_embed, tokenizer)
        text = generate_text(model, cfg, prefix_embed, tokenizer, use_beam)
        rec = {"image_id": dataset.image_ids[idx],
               "gt": dataset.captions[idx],
               "prefix_tokens": readout, "generated": text}
        print(f"-=({idx})=-\nCaption:\n{rec['gt']}\n>>>>> Generate from "
              f"prefix\n{text}", flush=True)
        out.append(rec)
        if max_items and len(out) >= max_items:
            break
    return out

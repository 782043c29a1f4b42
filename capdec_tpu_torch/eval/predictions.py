"""Predictions runner: CLIP embeddings -> generated captions JSON (port of
capdec_tpu/eval/predictions.py).

The reference eval CLI (predictions_runner.py:153-342) encodes and
beam-decodes one image at a time; this runner batches: an embedding
source gives a batch of CLIP embeddings, the mapper projects it, and the
batched beam engine (or greedy/top-p) decodes all of them, on the card
unless it is given `device="cpu"`, where the kernels' plain versions run.

Reference-parity behaviours:
  * `dont_normalize_prefix`, the inference modality offset
    (`offset_to_add_in_inference`), the modality-bridger hook,
    text-autoencoder mode (dataset_mode 5 / `--text_autoencoder`: encode
    the *caption* text instead of the image, predictions_runner.py:215-218)
  * output JSON `[{"caption": ..., "image_id": ...}]`, lowercased
    captions, a flush every `flush_every // batch_size` batches
  * per-batch latency stats (replacing the CUDA-event Timer)

Embedding sources: image files or caption text through the port's CLIP
towers, or a precomputed pickle. Multi-device eval waits for parallelism
(ROADMAP.md Queue 1) and raises.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from ..decode import (BeamConfig, ToppConfig, beam_search, beam_top_texts,
                      greedy_topp_search, topp_texts)
from ..decode.beam import cast_params_for_decode
from ..models import caption_model
from ..utils.meter import Timer
from ..utils.torch_setup import resolve_device


@dataclasses.dataclass
class PredictConfig:
    beam: bool = True
    batch_size: int = 32
    dont_normalize_prefix: bool = False
    add_modality_offset: bool = False
    modality_offset: Optional[np.ndarray] = None   # [1, D] inference offset
    text_autoencoder: bool = False
    beam_config: BeamConfig = dataclasses.field(default_factory=BeamConfig)
    topp_config: ToppConfig = dataclasses.field(default_factory=ToppConfig)
    flush_every: int = 99
    # paraphrase-distance ablation (reference --ablation_dist, needs ~5
    # captions per image_id) and image<->text gap stat (--ablation_image_dist)
    ablation_dist: bool = False
    ablation_dist_ready_at: int = 900
    ablation_image_dist: bool = False
    text_embed_fn: Optional[Callable] = None  # for ablation_image_dist
    # multi-device eval is not ported yet; must stay None
    mesh: Optional[Any] = None
    # Drop records failing this predicate (e.g. missing image files: the
    # reference skips them entirely, predictions_runner.py:206-209).
    record_filter: Optional[Callable[[dict], bool]] = None


def _l2norm(x, axis=-1):
    return x / np.maximum(np.linalg.norm(x, axis=axis, keepdims=True), 1e-12)


def run_predictions(records: List[dict],
                    embed_batch_fn: Callable[[List[dict]], np.ndarray],
                    model: caption_model.ClipCaptionModel,
                    model_cfg: caption_model.CaptionModelConfig,
                    tokenizer, cfg: PredictConfig,
                    out_path: Optional[str] = None,
                    bridger_fn: Optional[Callable] = None,
                    device=None) -> List[dict]:
    """Generate captions for `records`.

    `embed_batch_fn(records) -> [B, D] raw CLIP embeddings` abstracts the
    encode side (image files, caption text, or precomputed embeddings), so
    the runner is testable without CLIP weights. Steps per batch: the L2 norm, the offset, the
    bridger hook, `map_prefix`, then beam search (the rank-0 beam) or
    greedy/top-p."""
    from . import ablation

    if cfg.mesh is not None:
        raise NotImplementedError(
            "mesh-sharded eval is not ported yet (ROADMAP.md Queue 1, "
            "parallelism)")
    device = resolve_device(device)
    model = model.to(device).eval()
    # the decoder's weights in the compute dtype, cast once
    gpt = cast_params_for_decode(model.gpt, model_cfg.gpt2)
    results: List[dict] = []
    timer = Timer(sync=torch.cuda.synchronize if device.type == "cuda"
                  else None)
    paraphrase_embeds: dict = {}
    gap = ablation.ImageTextGapTracker()
    B = cfg.batch_size
    if cfg.record_filter is not None:
        # once, before batching: every batch but the last stays full-size
        kept = [d for d in records if cfg.record_filter(d)]
        if len(kept) < len(records):
            print(f"skips= {len(records) - len(kept)} "
                  f"(records dropped by filter)", flush=True)
        records = kept
    for start in range(0, len(records), B):
        chunk = records[start:start + B]
        with timer:
            prefix = np.asarray(embed_batch_fn(chunk), np.float32)
            if not cfg.dont_normalize_prefix:
                prefix = _l2norm(prefix)
            if cfg.add_modality_offset and cfg.modality_offset is not None:
                prefix = prefix + cfg.modality_offset
            if bridger_fn is not None:
                prefix = np.asarray(bridger_fn(prefix), np.float32)
            prefix_embeds = caption_model.map_prefix(
                model, model_cfg, torch.from_numpy(prefix).to(device))
            if cfg.beam:
                toks, lens, _, order = beam_search(
                    gpt, model_cfg.gpt2, prefix_embeds, cfg.beam_config)
                # rank-0 beam only (reference takes generate_beam(...)[0],
                # predictions_runner.py:229-232), selected on the device
                texts = beam_top_texts(tokenizer, toks, lens, order)
            else:
                toks, lens = greedy_topp_search(
                    gpt, model_cfg.gpt2, prefix_embeds, cfg.topp_config)
                texts = topp_texts(tokenizer, toks, lens)
        if cfg.ablation_dist:
            pe = prefix_embeds.float().cpu().numpy()
            for j, d in enumerate(chunk):
                paraphrase_embeds.setdefault(d["image_id"], []).append(
                    (pe[j].reshape(-1), prefix[j].reshape(-1)))
            if ablation.count_ready(paraphrase_embeds) >= \
                    cfg.ablation_dist_ready_at:
                ablation.calc_distances(paraphrase_embeds)
                cfg = dataclasses.replace(cfg, ablation_dist=False)
        if cfg.ablation_image_dist and cfg.text_embed_fn is not None:
            txt = _l2norm(np.asarray(cfg.text_embed_fn(chunk), np.float32))
            for j in range(len(chunk)):
                gap.update(prefix[j], txt[j])
        for d, text in zip(chunk, texts):
            results.append({"caption": text.lower(), "image_id": d["image_id"]})
        if out_path and (start // B) % max(1, cfg.flush_every // B) == 0:
            with open(out_path, "w") as f:
                json.dump(results, f)
            print(f"[{len(results)}/{len(records)}] {timer} "
                  f"({B / (timer.timings[-1] / 1000.0):.1f} captions/s)",
                  flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(results, f)
    if cfg.ablation_dist and paraphrase_embeds:
        ablation.calc_distances(paraphrase_embeds, out_file=None)
    if cfg.ablation_image_dist and gap.counter:
        gap.report()
    print(f"final: {timer}", flush=True)
    return results


# ---------------------------------------------------------------------------
# Embedding sources
# ---------------------------------------------------------------------------


def make_image_embed_fn(clip_model, clip_cfg, image_path_fn: Callable,
                        device=None):
    """Batched image encoder on the card (unless `device` names another);
    missing files get zero embeddings and are reported (the reference
    skips them, predictions_runner.py:206-209)."""
    from ..data.embeddings import image_encoder
    from ..data.image_ops import load_and_preprocess

    device = resolve_device(device)
    n_px = clip_cfg.vision.image_resolution
    encode = image_encoder(clip_model.to(device).eval(), device)
    skips = [0]

    def fn(records):
        imgs = []
        for d in records:
            path = image_path_fn(d)
            if os.path.isfile(path):
                imgs.append(load_and_preprocess(path, n_px))
            else:
                skips[0] += 1
                print(f"skips= {skips[0]}  filename= {path}", flush=True)
                imgs.append(np.zeros((n_px, n_px, 3), np.float32))
        return encode(np.stack(imgs))

    return fn


def make_text_embed_fn(clip_model, clip_cfg, clip_tokenizer, device=None):
    """Caption-text encoder for the text-autoencoder mode, on the card
    unless `device` names another."""
    from ..data.embeddings import text_encoder
    from ..utils.clip_tokenizer import tokenize_with_truncation

    device = resolve_device(device)
    encode = text_encoder(clip_model.to(device).eval(), device)

    def fn(records):
        rows = [tokenize_with_truncation(clip_tokenizer, d["caption"])[0][0]
                for d in records]
        return encode(np.stack(rows))

    return fn


def make_pickle_embed_fn(prefixes: np.ndarray):
    """Precomputed-embedding source (tests; offline eval)."""

    def fn(records):
        idx = [d["clip_embedding"] for d in records]
        return prefixes[idx]

    return fn

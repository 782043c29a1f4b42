"""Embedding extraction: annotation JSON -> CLIP-embedding pickle (port of
capdec_tpu/data/embeddings.py).

Where the reference encodes ONE caption per step (batch size 1,
SURVEY.md §3.1), this pipeline tokenizes on the host, encodes batches
with the port's CLIP towers on the card (or on the CPU when asked), and
writes the reference pickle schema with numpy arrays, so that pickles
from either package feed either package's trainer:

    {"clip_embedding": [N, D] image embeds (empty when text-only),
     "captions": [{..., "clip_embedding": i}],
     "clip_embedding_text_dave": [N, D] text embeds}

Embeddings are intentionally NOT normalized at this stage (reference
comment at embeddings_generator.py:87) so the choice happens at train time.
"""
from __future__ import annotations

import json
import os
import pickle
from typing import Callable, List, Optional

import numpy as np
import torch

from ..utils.torch_setup import resolve_device
from .parsers import caption_has_gender_term, change_gender_randomly


def text_encoder(model, device) -> Callable[[np.ndarray], np.ndarray]:
    """tokens [B, T] int (numpy) -> float32 [B, D] numpy, through
    `model.encode_text` on `device`."""
    def fn(tokens):
        t = torch.as_tensor(np.asarray(tokens), device=device)
        return model.encode_text(t).cpu().numpy()
    return fn


def image_encoder(model, device) -> Callable[[np.ndarray], np.ndarray]:
    """images [B, H, W, 3] CLIP-normalised (numpy) -> float32 [B, D] numpy,
    through `model.encode_image` on `device`."""
    def fn(images):
        x = torch.as_tensor(np.asarray(images, np.float32), device=device)
        return model.encode_image(x).cpu().numpy()
    return fn


def encode_texts_batched(records: List[dict], clip_tokenizer,
                         encode_fn: Callable, batch_size: int = 256,
                         fix_gender_imbalance: int = 0,
                         rng=None, long_cap_chars: int = 100,
                         progress: bool = True) -> np.ndarray:
    """Encode all captions; returns [N, D] float32.

    `encode_fn(tokens_i32 [B, 77]) -> [B, D]` is the text encoder.
    Gender debiasing (reference modes: 0 off, 1 both, 2 men, 3 women) and
    the >77-token truncation guard are applied host-side.
    """
    if rng is None:
        rng = np.random.default_rng(0)
    long_caps = 0
    token_rows = []
    for d in records:
        caption = d["caption"]
        if fix_gender_imbalance:
            if caption_has_gender_term(caption, fix_gender_imbalance - 1):
                caption = change_gender_randomly(caption, rng)
                d["caption"] = caption
        try:
            row = clip_tokenizer.tokenize(caption)[0]
        except RuntimeError:
            row = clip_tokenizer.tokenize(caption[:long_cap_chars])[0]
            long_caps += 1
        token_rows.append(row)
    if progress and long_caps:
        print(f"long captions truncated: {long_caps}", flush=True)

    chunks = []
    for start in range(0, len(token_rows), batch_size):
        chunk = np.stack(token_rows[start:start + batch_size])
        chunks.append(np.asarray(encode_fn(chunk), np.float32))
        if progress and (start // batch_size) % 20 == 0:
            print(f"encoded {start + len(chunk)}/{len(token_rows)}",
                  flush=True)
    return (np.concatenate(chunks, axis=0) if chunks
            else np.zeros((0, 0), np.float32))


def encode_images_batched(records: List[dict], image_path_fn: Callable,
                          encode_fn: Callable, n_px: int,
                          batch_size: int = 64,
                          progress: bool = True):
    """Encode images; returns ([M, D] embeds, kept_records, not_found)."""
    from .image_ops import load_and_preprocess

    kept, chunks, buf = [], [], []
    not_found = 0

    def flush():
        chunks.append(np.asarray(encode_fn(np.stack(buf)), np.float32))
        buf.clear()

    for d in records:
        path = image_path_fn(d)
        if not os.path.isfile(path):
            not_found += 1
            continue
        buf.append(load_and_preprocess(path, n_px))
        kept.append(d)
        if len(buf) == batch_size:
            flush()
            if progress:
                print(f"encoded {sum(c.shape[0] for c in chunks)} images",
                      flush=True)
    if buf:
        flush()
    embeds = (np.concatenate(chunks, axis=0) if chunks
              else np.zeros((0, 0), np.float32))
    return embeds, kept, not_found


def write_embedding_pickle(out_path: str, captions: List[dict],
                           text_embeds: Optional[np.ndarray],
                           image_embeds: Optional[np.ndarray]) -> None:
    """Write the reference pickle schema; row index recorded per record."""
    for i, d in enumerate(captions):
        d["clip_embedding"] = i
    data = {
        "clip_embedding": (image_embeds if image_embeds is not None
                           else np.zeros((0, 0), np.float32)),
        "captions": captions,
        "clip_embedding_text_dave": (text_embeds if text_embeds is not None
                                     else 0),
    }
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "wb") as f:
        pickle.dump(data, f)


def generate_embeddings(annotations_path: str, out_path: str,
                        clip_model, clip_cfg, clip_tokenizer,
                        add_text_embedding: bool = True,
                        images_path: str = "NoImgs",
                        image_path_fn: Optional[Callable] = None,
                        fix_gender_imbalance: int = 0,
                        batch_size: int = 256,
                        checkpoint_every: int = 10000,
                        device=None) -> dict:
    """End-to-end: annotations JSON -> embedding pickle (reference `main`,
    embeddings_generator.py:48-108, batched), on the card unless `device`
    names another. A crash-resilient partial pickle is written every
    `checkpoint_every` records (reference :96-98 dumps every 10k); each
    part's gender edits restart their generator at seed 0, as the JAX
    package's do."""
    device = resolve_device(device)
    clip_model = clip_model.to(device).eval()
    with open(annotations_path) as f:
        records = json.load(f)
    print(f"{len(records)} captions loaded from json", flush=True)

    text_embeds = image_embeds = None
    if add_text_embedding:
        encode = text_encoder(clip_model, device)
        done: list = []
        for start in range(0, len(records), checkpoint_every):
            part = records[start:start + checkpoint_every]
            done.append(encode_texts_batched(
                part, clip_tokenizer, encode,
                batch_size=batch_size,
                fix_gender_imbalance=fix_gender_imbalance))
            if start + checkpoint_every < len(records):
                write_embedding_pickle(out_path, records[:start + len(part)],
                                       np.concatenate(done, axis=0), None)
                print(f"partial pickle written at {start + len(part)}",
                      flush=True)
        text_embeds = np.concatenate(done, axis=0) if done else None
    elif images_path != "NoImgs":
        encode = image_encoder(clip_model, device)
        n_px = clip_cfg.vision.image_resolution
        fn = image_path_fn or (lambda d: os.path.join(images_path,
                                                      d["filename"]))
        image_embeds, records, not_found = encode_images_batched(
            records, fn, encode, n_px, batch_size=min(batch_size, 64))
        print(f"not found images = {not_found}", flush=True)

    write_embedding_pickle(out_path, records, text_embeds, image_embeds)
    print(f"{len(records)} embeddings saved to {out_path}", flush=True)
    return {"num_records": len(records)}

"""Caption-embedding dataset: reference-pickle reader + fixed-shape batching.

The port's own copy of capdec_tpu/data/dataset.py (numpy only), so the
port imports nothing of the JAX package; `iterate_batches(seed, epoch)`
gives the same batch order as the JAX package's.

Reads the reference embedding-pickle schema (embeddings_generator.py:98):
    {"clip_embedding":            float tensor [N, D]  (image embeds),
     "captions":                  list of dicts with "caption", "image_id",
                                  and "clip_embedding" = row index,
     "clip_embedding_text_dave":  float tensor [N, D]  (text embeds)}

Reference-parity behaviors (train.py:47-103, gpt2_prefix.py:21-108):
  * text vs image embedding switch (`use_image_embedding_as_clipcap`)
  * tokenize-once cache at `{data_path[:-4]}_tokens.pkl`
  * max_seq_len = min(int(mean + 10*std), max) over token lengths
    (or a fixed override, the old stack hardcoded 40)
  * pad semantics: tokens padded with 0, mask 0 at padded slots, and
    `prefix_length` ones prepended to the mask
  * optional L2-normalized prefix; optional trailing-period append
    (old stack, gpt2_prefix.py:53-62)

A batched iterator replaces `__getitem__`-style per-sample fetch: it
yields fixed-shape numpy arrays (tokens [B,T] i32, mask [B,K+T] f32,
prefix [B,D] f32), and the host never loops per token.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Iterator, List, Optional, Tuple

import numpy as np


def _to_numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):  # torch tensor from the reference pickle
        x = x.detach().cpu().float().numpy()
    return np.asarray(x)


def add_period(caption: str) -> str:
    """Old-stack caption normalization (gpt2_prefix.py:53-62)."""
    caption = caption.strip()
    if not caption:
        return "."
    if caption[-1] != ".":
        return caption + "."
    if len(caption) >= 2 and caption[-2] == " ":
        return caption[:-2] + "."
    return caption


@dataclasses.dataclass
class CaptionDataset:
    tokens: np.ndarray          # [N, T] int32, 0-padded
    mask: np.ndarray            # [N, K+T] float32 (K prefix ones + token mask)
    prefixes: np.ndarray        # [M, D] float32 CLIP embeddings
    caption_to_embedding: np.ndarray  # [N] int32 row index into prefixes
    image_ids: List
    captions: List[str]
    prefix_length: int
    max_seq_len: int

    def __len__(self) -> int:
        return self.tokens.shape[0]

    @property
    def dim_clip(self) -> int:
        return int(self.prefixes.shape[1])

    def batch_prefixes(self, idx: np.ndarray) -> np.ndarray:
        return self.prefixes[self.caption_to_embedding[idx]]


def compute_max_seq_len(lengths: np.ndarray,
                        override: Optional[int] = None) -> int:
    """Reference heuristic (train.py:103): min(int(mean + 10*std), max)."""
    if override is not None:
        return int(override)
    lengths = lengths.astype(np.float64)
    # torch.Tensor.std is the sample std (ddof=1).
    std = lengths.std(ddof=1) if len(lengths) > 1 else 0.0
    return int(min(int(lengths.mean() + std * 10), int(lengths.max())))


def _tokenize_all(captions: List[str], tokenizer,
                  cache_path: Optional[str]) -> Tuple[List[np.ndarray], int]:
    if cache_path and os.path.isfile(cache_path):
        with open(cache_path, "rb") as f:
            toks, _c2e, max_len = pickle.load(f)
        return [_to_numpy(t).astype(np.int32) for t in toks], int(max_len)
    toks = [np.asarray(tokenizer.encode(c), dtype=np.int32) for c in captions]
    max_len = max((len(t) for t in toks), default=0)
    if cache_path:
        with open(cache_path, "wb") as f:
            pickle.dump([toks, list(range(len(toks))), max_len], f)
    return toks, max_len


def load_caption_dataset(data_path: str, prefix_length: int, tokenizer,
                         normalize_prefix: bool = False,
                         use_image_embedding: bool = False,
                         append_period: bool = False,
                         max_seq_len_override: Optional[int] = None
                         ) -> CaptionDataset:
    with open(data_path, "rb") as f:
        all_data = pickle.load(f)
    key = "clip_embedding" if use_image_embedding else "clip_embedding_text_dave"
    prefixes = _to_numpy(all_data[key]).astype(np.float32)
    captions_raw = all_data["captions"]
    if append_period:
        for item in captions_raw:
            item["caption"] = add_period(item["caption"])
    captions = [c["caption"] for c in captions_raw]
    image_ids = [c["image_id"] for c in captions_raw]
    c2e = np.asarray([c["clip_embedding"] for c in captions_raw], dtype=np.int32)

    cache_path = f"{data_path[:-4]}_tokens.pkl" if data_path.endswith(".pkl") else None
    token_lists, _ = _tokenize_all(captions, tokenizer, cache_path)
    lengths = np.asarray([len(t) for t in token_lists], dtype=np.int64)
    T = compute_max_seq_len(lengths, max_seq_len_override)

    N = len(token_lists)
    tokens = np.zeros((N, T), dtype=np.int32)
    tok_mask = np.zeros((N, T), dtype=np.float32)
    for i, t in enumerate(token_lists):
        L = min(len(t), T)
        tokens[i, :L] = t[:L]
        tok_mask[i, :L] = 1.0
    mask = np.concatenate(
        [np.ones((N, prefix_length), np.float32), tok_mask], axis=1)

    if normalize_prefix:
        norms = np.linalg.norm(prefixes, axis=-1, keepdims=True)
        prefixes = prefixes / np.maximum(norms, 1e-12)

    return CaptionDataset(tokens=tokens, mask=mask, prefixes=prefixes,
                          caption_to_embedding=c2e, image_ids=image_ids,
                          captions=captions, prefix_length=prefix_length,
                          max_seq_len=T)


def iterate_batches(ds: CaptionDataset, batch_size: int, *, shuffle: bool = True,
                    drop_last: bool = True, seed: int = 0,
                    epoch: int = 0) -> Iterator[dict]:
    """Yield fixed-shape numpy batches {tokens, mask, prefix}."""
    n = len(ds)
    order = np.arange(n)
    if shuffle:
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        rng.shuffle(order)
    end = (n // batch_size) * batch_size if drop_last else n
    for start in range(0, end, batch_size):
        idx = order[start:start + batch_size]
        if len(idx) < batch_size and drop_last:
            break
        yield {
            "tokens": ds.tokens[idx],
            "mask": ds.mask[idx],
            "prefix": ds.batch_prefixes(idx),
        }


def steps_per_epoch(ds: CaptionDataset, batch_size: int,
                    drop_last: bool = True) -> int:
    n = len(ds)
    return n // batch_size if drop_last else -(-n // batch_size)


def subsample_pickle(data_path: str, num_samples: int, out_path: str,
                     seed: int = 0) -> None:
    """Few-shot subsetter (reference `create_few`, gpt2_prefix.py:264-275):
    random subset, reindexed `clip_embedding`, new pickle."""
    with open(data_path, "rb") as f:
        all_data = pickle.load(f)
    emb = _to_numpy(all_data["clip_embedding"])
    captions = all_data["captions"]
    rng = np.random.default_rng(seed)
    select = rng.permutation(len(captions))[:num_samples]
    new_captions = []
    for i, s in enumerate(select):
        c = dict(captions[int(s)])
        c["clip_embedding"] = i
        new_captions.append(c)
    out = {"captions": new_captions,
           "clip_embedding": emb[[captions[int(s)]["clip_embedding"] for s in select]]}
    if "clip_embedding_text_dave" in all_data and not np.isscalar(
            all_data["clip_embedding_text_dave"]):
        txt = _to_numpy(all_data["clip_embedding_text_dave"])
        out["clip_embedding_text_dave"] = txt[
            [captions[int(s)]["clip_embedding"] for s in select]]
    with open(out_path, "wb") as f:
        pickle.dump(out, f)

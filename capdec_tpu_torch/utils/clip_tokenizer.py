"""CLIP byte-level BPE tokenizer (the port's own copy of
capdec_tpu/utils/clip_tokenizer.py; the port imports nothing of the JAX
package).

The reference calls `clip.tokenize` (embeddings_generator.py:81,
predictions_runner.py:217). CLIP's BPE differs from GPT-2's: text is
lowercased and whitespace-collapsed, words carry an explicit end-of-word
marker `</w>`, and sequences are wrapped in <|startoftext|>/<|endoftext|>
inside a fixed 77-token context.

The merge table ships with CLIP as `bpe_simple_vocab_16e6.txt.gz`; supply
it via CAPDEC_CLIP_BPE_PATH or a constructor argument (zero-egress
environment — we cannot fetch it).
"""
from __future__ import annotations

import gzip
import html
import os
from typing import Dict, Iterable, List, Optional, Tuple

from .tokenizer import _bytes_to_unicode

CONTEXT_LENGTH = 77

_CLIP_SPLIT_PATTERN = (
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
    r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
)


def _basic_clean(text: str) -> str:
    try:
        import ftfy  # optional: repairs mojibake where it is installed
    except ImportError:
        ftfy = None
    if ftfy is not None:
        text = ftfy.fix_text(text)
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    import regex
    return regex.sub(r"\s+", " ", text).strip()


class CLIPTokenizer:
    def __init__(self, bpe_path: Optional[str] = None):
        import regex
        bpe_path = bpe_path or os.environ.get("CAPDEC_CLIP_BPE_PATH")
        if not bpe_path or not os.path.isfile(bpe_path):
            raise FileNotFoundError(
                "CLIP BPE vocab not found; set CAPDEC_CLIP_BPE_PATH to "
                "bpe_simple_vocab_16e6.txt.gz")
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges_lines = f.read().split("\n")
        merges_lines = merges_lines[1: 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges_lines if m.strip()]
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder: Dict[str, int] = {t: i for i, t in enumerate(vocab)}
        self.decoder = {i: t for t, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self._pat = regex.compile(_CLIP_SPLIT_PATTERN, regex.IGNORECASE)
        self._cache: Dict[str, str] = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>"}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self.vocab_size = len(vocab)

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        if not pairs:
            return token + "</w>"
        while True:
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode_text(self, text: str) -> List[int]:
        ids: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for tok in self._pat.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[p] for p in self._bpe(mapped).split(" "))
        return ids

    def tokenize(self, texts, context_length: int = CONTEXT_LENGTH):
        """`clip.tokenize` contract: [B, 77] int32, sot/eot wrapped; raises
        if a caption exceeds the context (the reference catches this and
        retries with the caption truncated to 100 chars,
        embeddings_generator.py:80-85)."""
        import numpy as np
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode_text(t) + [self.eot]
            if len(ids) > context_length:
                raise RuntimeError(
                    f"Input {t} is too long for context length {context_length}")
            out[i, :len(ids)] = ids
        return out

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        data = bytearray(self.byte_decoder[c] for c in text
                         if c in self.byte_decoder)
        return data.decode("utf-8", errors="replace").replace("</w>", " ")


def tokenize_with_truncation(tokenizer: CLIPTokenizer, caption: str,
                             max_chars: int = 100):
    """Reference long-caption guard (embeddings_generator.py:80-85)."""
    try:
        return tokenizer.tokenize(caption), False
    except RuntimeError:
        return tokenizer.tokenize(caption[:max_chars]), True

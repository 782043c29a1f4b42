"""GPT-2 byte-level BPE tokenizer, implemented from scratch.

The port's own copy of `capdec_tpu/utils/tokenizer.py` (the port imports
nothing of the JAX package). Tokenization stays host-side: the standard
`vocab.json` + `merges.txt` pair loads from a local path, an env var
(`CAPDEC_GPT2_VOCAB_DIR`), or the HF cache if present. Device code never
sees the tokenizer — the decode engine runs on token-id tensors.

A `ByteTokenizer` fallback (ids = raw bytes) keeps the full pipeline,
tests, and benchmarks runnable with no vocab files; it is NOT
vocabulary-compatible with GPT-2 checkpoints and says so loudly.

Known GPT-2 vocab constants used across the decode engines:
  '.'  -> 13     (beam stop token, reference gpt2_prefix_eval.py:54)
  ' .' -> 764    (extra top-p stop, reference gpt2_prefix_eval.py:187)
  '<|endoftext|>' -> 50256
"""
from __future__ import annotations

import functools
import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

GPT2_DOT_TOKEN = 13
GPT2_SPACE_DOT_TOKEN = 764
GPT2_EOT_TOKEN = 50256
GPT2_VOCAB_SIZE = 50257

# GPT-2's pre-tokenization pattern (requires the `regex` module for \p).
_GPT2_SPLIT_PATTERN = (
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)


@functools.lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte→unicode map (printable stand-ins for bytes)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class GPT2Tokenizer:
    """Byte-level BPE with GPT-2's merge table."""

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]]):
        import regex
        self.encoder = vocab
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._pat = regex.compile(_GPT2_SPLIT_PATTERN)
        self._bpe_cache: Dict[str, str] = {}
        self.vocab_size = len(vocab)
        self.eos_token_id = vocab.get("<|endoftext|>", GPT2_EOT_TOKEN)

    # -- construction ------------------------------------------------------

    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str) -> "GPT2Tokenizer":
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(merges_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        return cls(vocab, merges)

    @classmethod
    def from_dir(cls, path: str) -> "GPT2Tokenizer":
        return cls.from_files(os.path.join(path, "vocab.json"),
                              os.path.join(path, "merges.txt"))

    # -- BPE ---------------------------------------------------------------

    def _bpe(self, token: str) -> str:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word: Tuple[str, ...] = tuple(token)
        pairs = _get_pairs(word)
        if not pairs:
            return token
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
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._bpe_cache[token] = out
        return out

    # -- public API --------------------------------------------------------

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in self._pat.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[piece] for piece in self._bpe(mapped).split(" "))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        data = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return data.decode("utf-8", errors="replace")

    @property
    def stop_token_ids(self) -> Tuple[int, int]:
        return (self.encoder.get(".", GPT2_DOT_TOKEN),
                self.encoder.get("Ġ.", GPT2_SPACE_DOT_TOKEN))


class ByteTokenizer:
    """Fallback: one id per UTF-8 byte. For tests/benches without vocab files."""

    vocab_size = 256
    eos_token_id = 0

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Iterable[int]) -> str:
        return bytes(int(i) % 256 for i in ids).decode("utf-8", errors="replace")

    @property
    def stop_token_ids(self) -> Tuple[int, int]:
        return ord("."), ord(".")


def find_gpt2_vocab_dir() -> Optional[str]:
    """Locate vocab.json+merges.txt: env var, CWD assets, HF cache."""
    candidates = []
    env = os.environ.get("CAPDEC_GPT2_VOCAB_DIR")
    if env:
        candidates.append(env)
    candidates += ["./assets/gpt2", "./gpt2_vocab"]
    hf = os.path.expanduser("~/.cache/huggingface/hub/models--gpt2/snapshots")
    if os.path.isdir(hf):
        candidates += [os.path.join(hf, d) for d in sorted(os.listdir(hf))]
    for c in candidates:
        if (os.path.isfile(os.path.join(c, "vocab.json"))
                and os.path.isfile(os.path.join(c, "merges.txt"))):
            return c
    return None


def load_tokenizer(path: Optional[str] = None):
    """Best-effort GPT-2 BPE; ByteTokenizer fallback with a warning."""
    d = path or find_gpt2_vocab_dir()
    if d:
        return GPT2Tokenizer.from_dir(d)
    import warnings
    warnings.warn(
        "GPT-2 vocab files not found (set CAPDEC_GPT2_VOCAB_DIR); falling "
        "back to ByteTokenizer — NOT compatible with GPT-2 checkpoints.")
    return ByteTokenizer()

"""Native-accelerated GPT-2 tokenizer: Python pre-tokenization (exact
Unicode regex semantics) + C++ BPE merge loop (native/bpe.cpp, built at
first use into the git-ignored _build/). The port's own copy of
capdec_tpu/utils/native_bpe.py.

Drop-in replacement for `GPT2Tokenizer.encode`; falls back to the pure-
Python merge loop, with a note on stderr, when no C++ toolchain is
available. This is host code: the tokenizer never runs on the device.
"""
from __future__ import annotations

import ctypes
from typing import List

import numpy as np

from . import tokenizer as tok_lib


class NativeGPT2Tokenizer(tok_lib.GPT2Tokenizer):
    def __init__(self, vocab, merges):
        super().__init__(vocab, merges)
        from ..native import try_load
        self._lib = try_load("libcapdec_bpe", ["bpe.cpp"])
        self._handle = None
        if self._lib is not None:
            self._lib.bpe_create.restype = ctypes.c_void_p
            self._lib.bpe_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
            self._lib.bpe_destroy.restype = None
            self._lib.bpe_destroy.argtypes = [ctypes.c_void_p]
            self._lib.bpe_encode_batch.restype = ctypes.c_long
            self._lib.bpe_encode_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_long,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_long]
            merges_blob = "\n".join(f"{a} {b}" for a, b in merges)
            vocab_blob = "\n".join(f"{t}\t{i}" for t, i in vocab.items())
            self._handle = self._lib.bpe_create(
                merges_blob.encode("utf-8"), vocab_blob.encode("utf-8"))

    def __del__(self):
        if getattr(self, "_handle", None) and getattr(self, "_lib", None):
            self._lib.bpe_destroy(self._handle)

    def encode(self, text: str) -> List[int]:
        if self._handle is None:
            return super().encode(text)
        pretokens = [
            "".join(self.byte_encoder[b] for b in t.encode("utf-8"))
            for t in self._pat.findall(text)]
        if not pretokens:
            return []
        return self._encode_pretokens(pretokens)

    def _encode_pretokens(self, pretokens: List[str]) -> List[int]:
        blob = "\n".join(pretokens).encode("utf-8")
        cap = max(64, len(blob) * 2)
        out = np.empty(cap, np.int32)
        lengths = np.empty(len(pretokens), np.int32)
        n = self._lib.bpe_encode_batch(
            self._handle, blob,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(pretokens))
        if n < 0:
            return self.encode_pretokens_fallback(pretokens)
        return out[:n].tolist()

    def encode_pretokens_fallback(self, pretokens: List[str]) -> List[int]:
        ids: List[int] = []
        for mapped in pretokens:
            ids.extend(self.encoder[p] for p in self._bpe(mapped).split(" "))
        return ids

    def encode_batch(self, texts: List[str]) -> List[List[int]]:
        """Batched corpus tokenization (the data-pipeline entry point)."""
        if self._handle is None:
            return [super(NativeGPT2Tokenizer, self).encode(t) for t in texts]
        all_pre: List[str] = []
        counts: List[int] = []
        for text in texts:
            pre = ["".join(self.byte_encoder[b] for b in t.encode("utf-8"))
                   for t in self._pat.findall(text)]
            all_pre.extend(pre)
            counts.append(len(pre))
        if not all_pre:
            return [[] for _ in texts]
        blob = "\n".join(all_pre).encode("utf-8")
        cap = max(64, len(blob) * 2)
        out = np.empty(cap, np.int32)
        lengths = np.empty(len(all_pre), np.int32)
        n = self._lib.bpe_encode_batch(
            self._handle, blob,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(all_pre))
        if n < 0:
            return [self.encode(t) for t in texts]
        results: List[List[int]] = []
        tok_pos = 0
        pre_pos = 0
        for c in counts:
            cnt = int(lengths[pre_pos:pre_pos + c].sum())
            results.append(out[tok_pos:tok_pos + cnt].tolist())
            tok_pos += cnt
            pre_pos += c
        return results

    @classmethod
    def from_files(cls, vocab_path, merges_path):
        import json
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(merges_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        return cls(vocab, merges)

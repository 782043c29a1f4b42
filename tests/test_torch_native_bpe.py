"""The port's native BPE (capdec_tpu_torch/utils/native_bpe.py with its own
copy of native/bpe.cpp) against the Python merge loop and the JAX
package's tokenizers.

  * The cases of tests/test_native_bpe.py, bar the timing one, run on the
    port's classes; they skip when the library did not load, so here the
    library must load: g++ is present, and a broken build may not hide
    behind the Python fallback.
  * The library is built from the port's bpe.cpp into the git-ignored
    capdec_tpu_torch/_build/, named by a hash of the source, never the
    JAX package's prebuilt one.
  * Single and batch encodes equal the JAX package's native and Python
    tokenizers; without a toolchain the fallback notes it on stderr and
    encodes the same.
"""
import hashlib
import pathlib

import pytest

import test_native_bpe as cases
from capdec_tpu.utils import tokenizer as jax_tok
from capdec_tpu.utils.native_bpe import NativeGPT2Tokenizer as JaxNative
from capdec_tpu_torch import native
from capdec_tpu_torch.utils import tokenizer as tok
from capdec_tpu_torch.utils.native_bpe import NativeGPT2Tokenizer
from test_native_bpe import SAMPLES, vocab_files  # noqa: F401 (fixture)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def port_native(vocab_files):
    t = NativeGPT2Tokenizer.from_files(str(vocab_files / "vocab.json"),
                                       str(vocab_files / "merges.txt"))
    assert t._handle is not None, "the native BPE library did not load"
    return t


@pytest.mark.parametrize("case", ["test_native_matches_python",
                                  "test_native_batch"])
def test_port_passes_the_jax_cases(vocab_files, monkeypatch, case):
    port_native(vocab_files)
    monkeypatch.setattr(cases, "NativeGPT2Tokenizer", NativeGPT2Tokenizer)
    monkeypatch.setattr(cases, "tok", tok)
    getattr(cases, case)(vocab_files)


def test_library_is_built_from_the_ports_source(vocab_files):
    t = port_native(vocab_files)
    src = ROOT / "capdec_tpu_torch" / "native" / "bpe.cpp"
    assert src.read_bytes() == (ROOT / "capdec_tpu" / "native" /
                                "bpe.cpp").read_bytes()
    path = pathlib.Path(t._lib._name)
    assert path.parent == ROOT / "capdec_tpu_torch" / "_build"
    h = hashlib.sha256(" ".join(native.CXX_FLAGS).encode())
    h.update(src.read_bytes())
    assert path.name == f"libcapdec_bpe-{h.hexdigest()[:12]}.so"
    assert native.build_library("libcapdec_bpe", ["bpe.cpp"]) == str(path)


def test_encodes_equal_the_jax_tokenizers(vocab_files):
    t = port_native(vocab_files)
    vocab, merges = str(vocab_files / "vocab.json"), str(vocab_files /
                                                         "merges.txt")
    jn = JaxNative.from_files(vocab, merges)
    jp = jax_tok.GPT2Tokenizer.from_dir(str(vocab_files))
    texts = SAMPLES + ["a cat sat on the mat . " * 20]
    for text in texts:
        assert t.encode(text) == jp.encode(text) == jn.encode(text), text
    assert t.encode_batch(texts) == jn.encode_batch(texts) == \
        [jp.encode(x) for x in texts]
    assert t.decode(t.encode(texts[2])) == texts[2]


def test_without_a_toolchain_the_fallback_encodes_the_same(
        vocab_files, monkeypatch, capsys):
    def no_compiler(name, sources):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(native, "build_library", no_compiler)
    t = NativeGPT2Tokenizer.from_files(str(vocab_files / "vocab.json"),
                                       str(vocab_files / "merges.txt"))
    assert t._handle is None
    assert "libcapdec_bpe unavailable" in capsys.readouterr().err
    py = tok.GPT2Tokenizer.from_dir(str(vocab_files))
    assert t.encode_batch(SAMPLES) == [py.encode(x) for x in SAMPLES]

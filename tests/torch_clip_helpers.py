"""Helpers shared by the port's CLIP tests (tests/test_torch_clip_data.py,
tests/test_torch_predict.py, tests/test_torch_predict_clip.py): the
synthetic BPE file, the dry-run fixtures, a text checkpoint and the F2
fixture. It imports no test module, so that a test module which skips
itself at import (tests/test_clip_tokenizer.py and tests/test_clip.py
without `transformers`) takes none of these modules' tests with it.
"""
import gzip
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

from capdec_tpu.models import clip as jc

ROOT = pathlib.Path(__file__).resolve().parent.parent

# tests/test_clip_tokenizer.py's MERGES (tests/test_torch_clip_data.py
# holds the two lists equal)
MERGES = [
    ("t", "h"), ("th", "e</w>"), ("a", "</w>"), ("c", "a"), ("ca", "t</w>"),
    ("s", "a"), ("sa", "t</w>"), ("o", "n</w>"), ("m", "a"), ("ma", "n</w>"),
    ("r", "i"), ("ri", "d"), ("rid", "e"), ("ride", "s</w>"),
    ("w", "a"), ("wa", "v"), ("wav", "e</w>"),
]


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def write_bpe(path) -> str:
    """A merge file in bpe_simple_vocab_16e6.txt.gz's format with
    MERGES."""
    body = "version\n" + "\n".join(f"{a} {b}" for a, b in MERGES) + "\n"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write(body)
    return str(path)


def zoo_fixtures():
    """scripts/make_zoo_dryrun_fixtures.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "make_zoo_dryrun_fixtures",
        ROOT / "scripts" / "make_zoo_dryrun_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def text_checkpoint(path, vocab_size) -> str:
    """The dry-run fixture's tiny CLIP (scripts/make_zoo_dryrun_fixtures.py
    tiny_clip_checkpoint) with a vocabulary of `vocab_size` tokens."""
    cfg = jc.CLIPConfig(
        "tiny-rn-text",
        jc.CLIPTextConfig(vocab_size=vocab_size, context_length=77, width=64,
                          heads=1, layers=2, embed_dim=64),
        jc.CLIPResNetConfig(layers=(1, 1, 1, 1), width=8,
                            image_resolution=64, embed_dim=64))
    params = jax.jit(lambda k0, k1: {
        "text": jc.init_text_params(k0, cfg.text),
        "visual": jc.init_resnet_params(k1, cfg.vision)})(
            jax.random.PRNGKey(0), jax.random.PRNGKey(1))
    sd = jc.params_to_openai_state_dict(jax.tree.map(np.asarray, params),
                                        cfg)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, path)
    return str(path)


@pytest.fixture
def jax_stem_as_openai(monkeypatch):
    """The JAX package's stride-2 stem conv padded 1 and 1, as OpenAI's and
    the port's are (F2, tests/test_torch_clip.py pins the difference), so
    that the ResNet image routes compare like for like. Only this test
    process's reference changes; the package does not."""
    real = jc._conv

    def conv(w, x, stride=1, padding="SAME"):
        return real(w, x, stride, ((1, 1), (1, 1)) if stride == 2
                    else padding)

    monkeypatch.setattr(jc, "_conv", conv)

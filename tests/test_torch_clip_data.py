"""The port's CLIP data path against the JAX package's, on the CPU in
float32: the own copies of `utils/clip_tokenizer.py`, `data/parsers.py`,
`cli/parse_corpus.py` and `data/image_ops.py`, and the ported
`data/embeddings.py` and `cli/embeddings_generator.py`.

  * The cases of tests/test_clip_tokenizer.py, tests/test_parsers.py and
    tests/test_embeddings_pipeline.py, tests/test_remaining_coverage.py's
    test_encode_images_batched_with_missing and tests/test_cli.py's
    parse_corpus and mode-table cases run on the port's copies (their
    module swapped in; the pipeline's end-to-end case on a port CLIP).
  * image_ops gives the JAX copy's bytes on PNG and JPEG files of odd
    sizes, grayscale and RGBA included.
  * generate_embeddings against the JAX package's, text (gender edits,
    truncated long captions, partial pickles) and image mode (a missing
    file): records equal, arrays within 1e-5 relative L2, the pickle's keys
    and dtypes equal; each package's dataset loader reads the other's
    pickle to equal arrays.
  * The embeddings_generator and parse_corpus CLIs of both packages on
    scripts/make_zoo_dryrun_fixtures.py's tiny CLIP checkpoint and images
    (image mode), the JAX package's stem padded as OpenAI's (F2) for the
    image routes. Its checkpoint has a 512-token vocabulary, below any CLIP
    BPE's (514 + merges), so text mode runs on a checkpoint made the same
    way with the synthetic BPE's vocabulary. Both packages' MODEL_CONFIGS
    name the tiny architecture "RN50x4", as tests/test_torch_predict.py
    shrinks GPT2Config, since the CLI takes only zoo names.
"""
import ast
import inspect
import json
import pickle
import shutil

import numpy as np
import pytest
import torch

import capdec_tpu.data as jax_data_pkg
import test_cli as jax_cli_cases
import test_embeddings_pipeline as jax_emb_cases
import test_parsers as jax_parser_cases
import test_remaining_coverage as jax_rest_cases
from capdec_tpu.cli import embeddings_generator as jax_eg
from capdec_tpu.cli import parse_corpus as jax_parse_corpus
from capdec_tpu.data import dataset as jax_dataset
from capdec_tpu.data import embeddings as jax_emb
from capdec_tpu.data import image_ops as jax_image_ops
from capdec_tpu.models import clip as jc
from capdec_tpu.utils import clip_tokenizer as jax_ct
from capdec_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer
from capdec_tpu_torch.cli import embeddings_generator as eg
from capdec_tpu_torch.cli import parse_corpus
from capdec_tpu_torch.data import dataset, embeddings, image_ops, parsers
from capdec_tpu_torch.models import clip
from capdec_tpu_torch.utils import clip_tokenizer
from capdec_tpu_torch.utils.tokenizer import ByteTokenizer
from torch_clip_helpers import (MERGES, ROOT, jax_stem_as_openai,  # noqa: F401
                                rel, text_checkpoint, write_bpe, zoo_fixtures)

torch.set_num_threads(2)

TOL = 1e-5


def call_case(module, name, **fixtures):
    fn = getattr(module, name)
    return fn(**{p: fixtures[p] for p in inspect.signature(fn).parameters})


# ---------------------------------------------------------------------------
# shared fixtures: the synthetic BPE file, the dry-run artifacts
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """The dry-run artifacts (tiny CLIP, caption checkpoint, Karpathy JSON,
    JPEGs), the synthetic BPE and a text checkpoint of its vocabulary."""
    d = tmp_path_factory.mktemp("zoo")
    fx = zoo_fixtures()
    fx.tiny_clip_checkpoint(str(d / "clip_tiny.pt"))
    fx.karpathy_and_images(str(d), n_test=4)
    bpe = write_bpe(d / "bpe_simple_vocab_16e6.txt.gz")
    vocab = clip_tokenizer.CLIPTokenizer(bpe).vocab_size
    return dict(dir=d, clip=str(d / "clip_tiny.pt"), bpe=bpe,
                text_clip=text_checkpoint(d / "clip_text.pt", vocab),
                images=d / "images" / "val2014")


CAPTIONS = ["A man rides a wave on his board.", "the boy and his dad eat",
            "a woman walks her dog", "two cats sleep on a sofa",
            "her brother and sister play ball", "cat " * 60,
            "it's the cat's toy!!", "The policeman talks to a lady."]


def caption_records(n=8):
    return [{"caption": CAPTIONS[i % len(CAPTIONS)], "image_id": 100 + i,
             "id": i} for i in range(n)]


# ---------------------------------------------------------------------------
# the JAX test modules' cases on the port's copies
# ---------------------------------------------------------------------------


def jax_tokenizer_cases():
    """tests/test_clip_tokenizer.py, imported when a test needs it: it
    skips itself without `transformers`, which the other cases here do
    not use."""
    import test_clip_tokenizer
    return test_clip_tokenizer


def jax_tokenizer_case_names():
    """The test functions of tests/test_clip_tokenizer.py, read from its
    source so that collecting this module does not import it."""
    tree = ast.parse((ROOT / "tests" / "test_clip_tokenizer.py").read_text())
    return sorted(n.name for n in tree.body if isinstance(n, ast.FunctionDef)
                  and n.name.startswith("test_"))


@pytest.fixture(scope="module")
def port_tokenizers(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    bpe = write_bpe(tmp_path_factory.mktemp("bpe") / "b.txt.gz")
    ours = clip_tokenizer.CLIPTokenizer(bpe)
    d = tmp_path_factory.mktemp("hfclip")
    (d / "vocab.json").write_text(json.dumps(ours.encoder), encoding="utf-8")
    (d / "merges.txt").write_text(
        "#version\n" + "\n".join(f"{a} {b}" for a, b in MERGES) + "\n",
        encoding="utf-8")
    theirs = transformers.CLIPTokenizer(str(d / "vocab.json"),
                                        str(d / "merges.txt"))
    return bpe, (ours, theirs)


def test_bpe_merges_are_the_jax_cases():
    jax_tok_cases = jax_tokenizer_cases()
    assert MERGES == jax_tok_cases.MERGES
    assert jax_tokenizer_case_names() == sorted(
        n for n in vars(jax_tok_cases) if n.startswith("test_"))


@pytest.mark.parametrize("case", jax_tokenizer_case_names())
def test_clip_tokenizer_copy_passes_the_jax_cases(monkeypatch,
                                                  port_tokenizers, case):
    jax_tok_cases = jax_tokenizer_cases()
    monkeypatch.setattr(jax_tok_cases, "ct", clip_tokenizer)
    bpe, toks = port_tokenizers
    call_case(jax_tok_cases, case, bpe_file=bpe, tokenizers=toks)


def test_clip_tokenizer_copy_gives_the_jax_tokens(port_tokenizers):
    bpe, (ours, _) = port_tokenizers
    theirs = jax_ct.CLIPTokenizer(bpe)
    texts = CAPTIONS + ["&amp; café naïve 42", "  spaced\tout \n"]
    for t in texts:
        assert ours.encode_text(t) == theirs.encode_text(t), t
        got = clip_tokenizer.tokenize_with_truncation(ours, t)
        want = jax_ct.tokenize_with_truncation(theirs, t)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])
    assert ours.decode(ours.encode_text(texts[0])) == \
        theirs.decode(theirs.encode_text(texts[0]))


@pytest.mark.parametrize("case", sorted(
    n for n in vars(jax_parser_cases) if n.startswith("test_")))
def test_parsers_copy_passes_the_jax_cases(monkeypatch, tmp_path, case):
    monkeypatch.setattr(jax_parser_cases, "parsers", parsers)
    call_case(jax_parser_cases, case, tmp_path=tmp_path)


def test_parse_corpus_copy_passes_the_jax_case(monkeypatch, tmp_path,
                                               capsys):
    monkeypatch.setattr(jax_parse_corpus, "main", parse_corpus.main)
    jax_cli_cases.test_parse_corpus_cli_all_modes(tmp_path, capsys)


def test_mode_table_equals_the_jax_one(monkeypatch):
    for args in [("/data", "RN50x4", True, 0), ("/d", "ViT-B_32", False, 2),
                 ("./data", "RN50", True, 3)]:
        assert eg.mode_table(*args) == jax_eg.mode_table(*args)
    monkeypatch.setattr(jax_eg, "mode_table", eg.mode_table)
    jax_cli_cases.test_embeddings_mode_table()


def test_encode_images_batched_with_missing_on_the_copy(monkeypatch,
                                                         tmp_path):
    monkeypatch.setattr(jax_data_pkg, "embeddings", embeddings)
    jax_rest_cases.test_encode_images_batched_with_missing(tmp_path)


@pytest.fixture(scope="module")
def port_text_encoder():
    """tests/test_embeddings_pipeline.py's text encoder (vocab 64, context
    16, width 16, 2 heads, 1 layer, embed 8) in the port."""
    cfg = clip.CLIPConfig("tiny", clip.CLIPTextConfig(
        vocab_size=64, context_length=16, width=16, heads=2, layers=1,
        embed_dim=8), clip.CLIPViTConfig(32, 16, 16, 1, 2, 8))
    model = clip.build_model(cfg, torch.Generator().manual_seed(0))
    return cfg, model, embeddings.text_encoder(model, torch.device("cpu"))


@pytest.mark.parametrize("case", ["test_encode_texts_batched_matches_single",
                                  "test_gender_fix_applied"])
def test_embeddings_copy_passes_the_jax_cases(monkeypatch, port_text_encoder,
                                              case):
    monkeypatch.setattr(jax_emb_cases, "emb_lib", embeddings)
    call_case(jax_emb_cases, case, text_encoder=port_text_encoder[2])


def test_generate_embeddings_end_to_end_on_the_port(tmp_path,
                                                    port_text_encoder):
    """tests/test_embeddings_pipeline.py's end-to-end case with the port's
    pipeline, CLIP model and dataset loader."""
    cfg, model, _ = port_text_encoder
    records = [{"caption": f"sentence {i}", "image_id": i, "id": i}
               for i in range(7)]
    ann = str(tmp_path / "ann.json")
    with open(ann, "w") as f:
        json.dump(records, f)
    out = str(tmp_path / "out.pkl")
    embeddings.generate_embeddings(
        ann, out, model, cfg, jax_emb_cases.StubClipTokenizer(),
        add_text_embedding=True, batch_size=4, checkpoint_every=4,
        device="cpu")
    with open(out, "rb") as f:
        data = pickle.load(f)
    assert data["clip_embedding_text_dave"].shape == (7, 8)
    assert [c["clip_embedding"] for c in data["captions"]] == list(range(7))
    ds = dataset.load_caption_dataset(out, 4, ByteTokenizer())
    assert len(ds) == 7 and ds.dim_clip == 8


# ---------------------------------------------------------------------------
# image_ops
# ---------------------------------------------------------------------------


def test_image_ops_give_the_jax_bytes(tmp_path):
    from PIL import Image
    rng = np.random.RandomState(0)
    files = []
    for name, mode, (w, h) in [("rgb.png", "RGB", (37, 53)),
                               ("rgb.jpg", "RGB", (61, 29)),
                               ("gray.png", "L", (45, 45)),
                               ("gray.jpg", "L", (23, 71)),
                               ("rgba.png", "RGBA", (33, 70))]:
        shape = (h, w) if mode == "L" else (h, w, len(mode))
        Image.fromarray(rng.randint(0, 256, shape, np.uint8), mode).save(
            tmp_path / name)
        files.append(str(tmp_path / name))
    for n_px in (24, 32, 64):
        for f in files:
            got = image_ops.load_and_preprocess(f, n_px)
            want = jax_image_ops.load_and_preprocess(f, n_px)
            assert got.dtype == want.dtype == np.float32
            assert got.shape == (n_px, n_px, 3)
            assert got.tobytes() == want.tobytes(), (f, n_px)
        assert image_ops.preprocess_batch(files, n_px).tobytes() == \
            jax_image_ops.preprocess_batch(files, n_px).tobytes()


# ---------------------------------------------------------------------------
# generate_embeddings and the CLIs against the JAX package's
# ---------------------------------------------------------------------------


def record_writes(monkeypatch, module):
    """Every write_embedding_pickle of `module`: (records, text rows,
    image rows)."""
    calls = []
    real = module.write_embedding_pickle

    def spy(out_path, captions, text_embeds, image_embeds):
        calls.append((len(captions), None if text_embeds is None else
                      text_embeds.shape, None if image_embeds is None else
                      image_embeds.shape))
        real(out_path, captions, text_embeds, image_embeds)

    monkeypatch.setattr(module, "write_embedding_pickle", spy)
    return calls


def assert_same_pickles(got_path, want_path):
    with open(got_path, "rb") as f, open(want_path, "rb") as g:
        got, want = pickle.load(f), pickle.load(g)
    assert list(got) == list(want)
    assert got["captions"] == want["captions"]
    for key in ("clip_embedding", "clip_embedding_text_dave"):
        a, b = got[key], want[key]
        assert type(a) is type(b), key
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            if b.size:
                assert rel(a, b) <= TOL, key
        else:
            assert a == b == 0
    return got


@pytest.mark.parametrize("mode", ["text", "image"])
def test_generate_embeddings_matches_jax(monkeypatch, tmp_path, zoo, mode,
                                        jax_stem_as_openai):
    if mode == "text":
        monkeypatch.setenv("CAPDEC_CLIP_BPE_PATH", zoo["bpe"])
        records, ckpt = caption_records(11), zoo["text_clip"]
        kw = dict(add_text_embedding=True, fix_gender_imbalance=1,
                  batch_size=3, checkpoint_every=4)
    else:
        records = [{"filename": p.name, "image_id": i, "caption": "x"}
                   for i, p in enumerate(sorted(zoo["images"].glob("*.jpg")))]
        records.insert(2, {"filename": "missing.jpg", "image_id": 99,
                           "caption": "y"})
        ckpt = zoo["clip"]
        kw = dict(add_text_embedding=False, images_path=str(zoo["images"]),
                  batch_size=4)
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps(records))
    calls = {}
    for name, emb_mod, clip_mod, extra in (
            ("jax", jax_emb, jc, {}), ("port", embeddings, clip,
                                       {"device": "cpu"})):
        calls[name] = record_writes(monkeypatch, emb_mod)
        model, cfg = clip_mod.load_openai_checkpoint(ckpt)
        tok = (clip_tokenizer if name == "port" else jax_ct).CLIPTokenizer() \
            if mode == "text" else None
        emb_mod.generate_embeddings(str(ann), str(tmp_path / f"{name}.pkl"),
                                    model, cfg, tok, **kw, **extra)
    assert calls["port"] == calls["jax"]
    assert len(calls["port"]) == (3 if mode == "text" else 1)
    got = assert_same_pickles(tmp_path / "port.pkl", tmp_path / "jax.pkl")
    if mode == "text":
        edited = [r["caption"] for r in got["captions"]]
        assert edited != [r["caption"] for r in records]  # gender flips
        # each package's loader reads the other's pickle (fresh copies, so
        # that neither reads the other's token cache)
        for reader, tok in (("port", ByteTokenizer()),
                            ("jax", JaxByteTokenizer())):
            lib = dataset if reader == "port" else jax_dataset
            d = tmp_path / f"read_by_{reader}"
            d.mkdir()
            loaded = []
            for writer in ("port", "jax"):
                shutil.copy(tmp_path / f"{writer}.pkl", d / f"{writer}.pkl")
                loaded.append(lib.load_caption_dataset(
                    str(d / f"{writer}.pkl"), 4, tok))
            a, b = loaded
            np.testing.assert_array_equal(a.tokens, b.tokens)
            np.testing.assert_array_equal(a.mask, b.mask)
            assert len(a) == 11 and rel(a.prefixes, b.prefixes) <= TOL
    else:
        assert [r["image_id"] for r in got["captions"]] == [0, 1, 2, 3, 4, 5]


def zoo_model_configs(monkeypatch, ckpt):
    """Both packages' MODEL_CONFIGS["RN50x4"] set to `ckpt`'s architecture."""
    sd = torch.load(ckpt, weights_only=True)
    for mod in (jc, clip):
        monkeypatch.setitem(mod.MODEL_CONFIGS, "RN50x4",
                            mod.config_from_openai_state_dict(sd, "RN50x4"))


@pytest.mark.parametrize("mode", ["text", "image"])
def test_embeddings_generator_cli_matches_jax(monkeypatch, tmp_path, zoo,
                                              mode, jax_stem_as_openai):
    monkeypatch.setenv("CAPDEC_JAX_CACHE", str(tmp_path / "jaxcache"))
    monkeypatch.setenv("CAPDEC_CLIP_BPE_PATH", zoo["bpe"])
    ann = tmp_path / "ann.json"
    if mode == "text":
        ckpt = zoo["text_clip"]
        ann.write_text(json.dumps(caption_records(9)))
        flags = ["--fix_gender_imbalance_mode", "1", "--batch_size", "4"]
    else:
        ckpt = zoo["clip"]
        records = [{"filename": f"COCO_val2014_{i:012d}.jpg", "image_id": i,
                    "caption": "c"} for i in range(1, 7)]
        ann.write_text(json.dumps(records))
        flags = ["--add_text_embedding", "0", "--images_path",
                 str(zoo["images"]), "--batch_size", "4"]
    zoo_model_configs(monkeypatch, ckpt)
    base = ["--clip_checkpoint", ckpt, "--clip_model_type", "RN50x4",
            "--annotations", str(ann), *flags]
    jax_eg.main(base + ["--out", str(tmp_path / "jax.pkl")])
    eg.main(base + ["--out", str(tmp_path / "port.pkl"), "--device", "cpu"])
    got = assert_same_pickles(tmp_path / "port.pkl", tmp_path / "jax.pkl")
    assert len(got["captions"]) == (9 if mode == "text" else 6)
    # the zoo names are refused for another architecture
    monkeypatch.undo()
    with pytest.raises(ValueError, match="does not match"):
        eg.main(base + ["--out", str(tmp_path / "x.pkl"), "--device", "cpu"])


def test_parse_corpus_cli_matches_jax(tmp_path, zoo, capsys):
    karpathy = str(zoo["dir"] / "karpathy" / "dataset_coco.json")
    text = tmp_path / "corpus.txt"
    text.write_text("Page 3\nHarry looked at the great hall with wonder. "
                    "Yes.\n\"Shall I compare thee, to a summer's day\"\n")
    outs = {}
    for name, main in (("jax", jax_parse_corpus.main),
                       ("port", parse_corpus.main)):
        d = tmp_path / name
        main(["karpathy", "--karpathy_json", karpathy, "--out_dir",
              str(d / "k")])
        main(["open_text", "--text", str(text), "--out", str(d / "o.json")])
        main(["lines", "--text", str(text), "--out", str(d / "l.json")])
        printed = capsys.readouterr().out.replace(str(d), "<dir>")
        files = {p.relative_to(d).as_posix(): p.read_bytes()
                 for p in sorted(d.rglob("*.json"))}
        outs[name] = (printed, files)
    assert outs["port"] == outs["jax"]
    assert len(outs["port"][1]) == 8

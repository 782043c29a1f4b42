"""The port's eval entry point against the JAX package's, on the CPU in
float32: `eval/predictions.run_predictions`, the predict CLI after the
train CLI, and `eval/prefix_tools` with its inspect CLI.

  * run_predictions (beam and greedy, the offset, record_filter) on a tiny
    GPT-2 with the JAX package's weights gives the JAX runner's captions
    and the same JSON file; the CLIP image and text sources give the JAX
    package's embeddings (the predict CLI's --clip_checkpoint routes:
    tests/test_torch_predict_clip.py).
  * tests/test_cli_main_e2e.py's train-then-predict through the port's
    CLIs with `--device cpu`: the JAX predict CLI and the port's, run on
    the same checkpoint, write the same predictions and scores (the
    default beam path, `--no_beam`, `--infer_model_config`, the modality
    offset and a bridger the port trained and saved); `--int8_kv` writes
    a caption per record. Both packages' GPT2Config is monkeypatched to a
    tiny one, as tests/test_torch_cli.py does.
  * prefix_tools: the readout, insertion and removal give the JAX tools'
    results; inspect_samples and the inspect CLI give the JAX ones'
    records.
"""
import dataclasses
import functools
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capdec_tpu.decode import BeamConfig as JaxBeamConfig
from capdec_tpu.decode import ToppConfig as JaxToppConfig
from capdec_tpu.eval import predictions as jax_pred
from capdec_tpu.eval import prefix_tools as jax_tools
from capdec_tpu.models import caption_model as jax_cm
from capdec_tpu.models import gpt2 as jax_gpt2
from capdec_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer
from capdec_tpu_torch.aux import bridger
from capdec_tpu_torch.decode import BeamConfig, ToppConfig
from capdec_tpu_torch.eval import predictions, prefix_tools
from capdec_tpu_torch.models import caption_model, gpt2
from capdec_tpu_torch.utils.tokenizer import ByteTokenizer
from torch_clip_helpers import jax_stem_as_openai  # noqa: F401 (fixture)

torch.set_num_threads(2)

TINY_GPT = dict(vocab_size=256, n_positions=96, n_embd=32, n_layer=2,
                n_head=4)
MODEL = dict(prefix_length=4, clip_length=4, prefix_size=16, num_layers=2,
             mapping_type="mlp")


def _models(seed):
    jcfg = jax_cm.CaptionModelConfig(gpt2=jax_gpt2.GPT2Config(**TINY_GPT),
                                     **MODEL)
    tcfg = caption_model.CaptionModelConfig(
        gpt2=gpt2.GPT2Config(**TINY_GPT), **MODEL)
    params = jax_cm.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, params, caption_model.params_from_jax_numpy(
        jax.tree.map(np.asarray, params), tcfg)


def _both(seed, records, prefixes, jax_kw, port_kw, tmp_path=None):
    """run_predictions of both packages on the same weights and records;
    returns (JAX results, port results) and, with tmp_path, checks that
    the two JSON files are equal."""
    jcfg, tcfg, params, model = _models(seed)
    outs = ((None, None) if tmp_path is None else
            (str(tmp_path / "jax.json"), str(tmp_path / "port.json")))
    want = jax_pred.run_predictions(
        records, jax_pred.make_pickle_embed_fn(prefixes), params, jcfg,
        JaxByteTokenizer(), jax_pred.PredictConfig(**jax_kw),
        out_path=outs[0])
    got = predictions.run_predictions(
        records, predictions.make_pickle_embed_fn(prefixes), model, tcfg,
        ByteTokenizer(), predictions.PredictConfig(**port_kw),
        out_path=outs[1], device="cpu")
    if tmp_path is not None:
        with open(outs[0]) as fa, open(outs[1]) as fb:
            assert json.load(fb) == json.load(fa) == got
    return want, got


@pytest.mark.parametrize("beam", [True, False])
def test_run_predictions_matches_jax(tmp_path, beam):
    records = [{"image_id": i, "clip_embedding": i} for i in range(6)]
    prefixes = np.random.RandomState(0).randn(6, 16).astype(np.float32)
    dot = ord(".")
    want, got = _both(
        0, records, prefixes,
        dict(beam=beam, batch_size=4,
             beam_config=JaxBeamConfig(beam_size=3, entry_length=8,
                                       stop_token=dot),
             topp_config=JaxToppConfig(entry_length=8, stop_token=dot,
                                       extra_stop_token=dot)),
        dict(beam=beam, batch_size=4,
             beam_config=BeamConfig(beam_size=3, entry_length=8,
                                    stop_token=dot),
             topp_config=ToppConfig(entry_length=8, stop_token=dot,
                                    extra_stop_token=dot)),
        tmp_path)
    assert len(got) == 6 and got == want
    assert all(set(r) == {"caption", "image_id"} for r in got)
    assert all(r["caption"] == r["caption"].lower() for r in got)


def test_offset_changes_output_as_in_jax():
    records = [{"image_id": 0, "clip_embedding": 0}]
    prefixes = np.random.RandomState(1).randn(1, 16).astype(np.float32)
    kw = dict(batch_size=1)
    jb = dict(beam_config=JaxBeamConfig(beam_size=2, entry_length=6,
                                        stop_token=-1))
    tb = dict(beam_config=BeamConfig(beam_size=2, entry_length=6,
                                     stop_token=-1))
    w1, g1 = _both(1, records, prefixes, {**kw, **jb}, {**kw, **tb})
    off = dict(add_modality_offset=True,
               modality_offset=np.full((1, 16), 1.5, np.float32))
    w2, g2 = _both(1, records, prefixes, {**kw, **jb, **off},
                   {**kw, **tb, **off})
    assert (g1, g2) == (w1, w2)
    assert g1[0]["caption"] != g2[0]["caption"]


def test_record_filter_drops_records_as_in_jax():
    records = [{"image_id": i, "clip_embedding": i} for i in range(6)]
    prefixes = np.random.RandomState(0).randn(6, 16).astype(np.float32)
    keep = dict(record_filter=lambda d: d["image_id"] % 3 != 0)
    dot = ord(".")
    want, got = _both(
        0, records, prefixes,
        dict(beam=False, batch_size=4, **keep,
             topp_config=JaxToppConfig(entry_length=8, stop_token=dot,
                                       extra_stop_token=dot)),
        dict(beam=False, batch_size=4, **keep,
             topp_config=ToppConfig(entry_length=8, stop_token=dot,
                                    extra_stop_token=dot)))
    assert got == want
    assert sorted(r["image_id"] for r in got) == [1, 2, 4, 5]


def test_run_predictions_refuses_a_mesh_and_clip_sources(tmp_path,
                                                         jax_stem_as_openai):
    """A world-1 mesh gives the captions of no mesh (a mesh of several
    ranks: tests/test_torch_parallel_decode.py); the CLIP sources run:
    make_image_embed_fn
    (a missing file is encoded as a zero image) and make_text_embed_fn against the
    JAX package's on one tiny CLIP, within 1e-5 relative L2 (the JAX stem
    padded as OpenAI's, F2)."""
    from PIL import Image

    from capdec_tpu.models import clip as jc
    from capdec_tpu.utils import clip_tokenizer as jax_ct
    from capdec_tpu_torch.models import clip
    from capdec_tpu_torch.parallel import mesh as mesh_lib
    from capdec_tpu_torch.utils import clip_tokenizer
    from torch_clip_helpers import rel, text_checkpoint, write_bpe

    _, tcfg, _, model = _models(0)
    records = [{"image_id": i, "clip_embedding": i} for i in range(3)]
    embed = predictions.make_pickle_embed_fn(
        np.random.RandomState(0).randn(3, 16).astype(np.float32))
    bc = BeamConfig(beam_size=3, entry_length=6)
    run = lambda mesh: predictions.run_predictions(
        records, embed, model, tcfg, ByteTokenizer(),
        predictions.PredictConfig(batch_size=2, beam_config=bc, mesh=mesh),
        device="cpu")
    want = run(None)
    try:
        got = run(mesh_lib.make_mesh(dp=1, device="cpu"))
    finally:
        torch.distributed.destroy_process_group()
    assert got == want and len(want) == 3
    bpe = write_bpe(tmp_path / "bpe.txt.gz")
    vocab = clip_tokenizer.CLIPTokenizer(bpe).vocab_size
    ckpt = text_checkpoint(tmp_path / "clip.pt", vocab)
    params, jcfg = jc.load_openai_checkpoint(ckpt)
    clip_model, cfg = clip.load_openai_checkpoint(ckpt)
    rng = np.random.RandomState(0)
    for i, (w, h) in enumerate([(70, 50), (40, 90), (64, 64)]):
        Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(
            tmp_path / f"{i}.jpg")
    records = [{"image_id": i, "caption": c} for i, c in enumerate(
        ["a man on a horse", "cat " * 40, "missing image", "two dogs"])]
    path_fn = lambda d: str(tmp_path / f"{min(d['image_id'], 9)}.jpg")
    records[2]["image_id"] = 9
    got = predictions.make_image_embed_fn(clip_model, cfg, path_fn,
                                          device="cpu")(records)
    want = jax_pred.make_image_embed_fn(params, jcfg, path_fn)(records)
    assert got.shape == (4, 64) and rel(got, want) <= 1e-5
    zero = clip_model.encode_image(torch.zeros(1, 64, 64, 3)).numpy()
    assert rel(got[2:3], zero) <= 1e-5
    got = predictions.make_text_embed_fn(
        clip_model, cfg, clip_tokenizer.CLIPTokenizer(bpe),
        device="cpu")(records)
    want = jax_pred.make_text_embed_fn(params, jcfg,
                                       jax_ct.CLIPTokenizer(bpe))(records)
    assert got.shape == (4, 64) and rel(got, want) <= 1e-5


# ---------------------------------------------------------------------------
# train then predict through the CLIs
# ---------------------------------------------------------------------------

CLI_GPT = dict(vocab_size=300, n_positions=96, n_embd=32, n_layer=2,
               n_head=4)


def _write_corpus(path, n=40, dim=640):
    """The corpus of tests/test_cli_main_e2e.py."""
    rng = np.random.RandomState(0)
    caps = [{"caption": f"a tiny caption {i % 4}.", "image_id": i, "id": i,
             "clip_embedding": i} for i in range(n)]
    data = {"clip_embedding": rng.randn(n, dim).astype(np.float32),
            "captions": caps,
            "clip_embedding_text_dave": rng.randn(n, dim).astype(np.float32)}
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return data


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The port's train CLI on the e2e corpus (mlp mapper, prefix 2, one
    epoch, tiny GPT-2), the dataset registry of dataset_mode 0 and a GT
    file for --score_gt."""
    from capdec_tpu_torch.cli import train as train_cli
    tmp = tmp_path_factory.mktemp("e2e")
    data = str(tmp / "train.pkl")
    corpus = _write_corpus(data)
    mp = pytest.MonkeyPatch()
    mp.setattr(gpt2, "GPT2Config",
               functools.partial(gpt2.GPT2Config, **CLI_GPT))
    try:
        train_cli.main([
            "--data", data, "--out_dir", str(tmp / "ckpt"), "--epochs", "1",
            "--bs", "8", "--noise_variance", "0.016", "--mapping_type",
            "mlp", "--only_prefix", "--prefix_length", "2",
            "--prefix_length_clip", "2", "--num_layers", "1", "--lr", "1e-4",
            "--prefix", "tiny", "--device", "cpu"])
    finally:
        mp.undo()
    root = tmp / "dataroot"
    (root / "coco" / "annotations").mkdir(parents=True)
    records = [{"image_id": i, "caption": f"a tiny caption {i % 4}.",
                "clip_embedding": i} for i in range(8)]
    (root / "coco" / "annotations" /
     "single_caption_per_sample_val.json").write_text(json.dumps(records))
    gt = {"images": [{"id": r["image_id"]} for r in records],
          "annotations": [{"image_id": r["image_id"], "caption": r["caption"],
                           "id": i} for i, r in enumerate(records)]}
    (tmp / "gt.json").write_text(json.dumps(gt))
    # the modality offset pickle both CLIs read
    off = {"offset_to_add_in_inference":
           np.full((1, 640), 0.05, np.float32)}
    with open(tmp / "centers.pkl", "wb") as f:
        pickle.dump(off, f)
    return tmp, data, corpus


def _predict(cli, tmp, data, flags, name):
    out = str(tmp / f"{name}.json")
    cli.main(["--checkpoint", str(tmp / "ckpt" / "tiny-000.pt"),
              "--embeddings_pickle", data, "--prefix_length", "2",
              "--prefix_length_clip", "2", "--num_layers", "1",
              "--mapping_type", "mlp", "--no_bf16", "--batch_size", "8",
              "--out", out, "--score_gt", str(tmp / "gt.json"),
              "--dataset_mode", "0", *flags])
    # the scores file is named after the checkpoint, as in the reference
    scores = "tiny-000" + ("add_modality_offset"
                           if "--add_modality_offset" in flags else "")
    with open(out) as f, open(tmp / f"{scores}_scores.json") as g:
        return json.load(f), json.load(g)


FLAGS = {"beam": [], "greedy": ["--no_beam"],
         "inferred": ["--infer_model_config"],
         "offset": ["--add_modality_offset", "--modality_offset_path",
                    "centers.pkl"],
         "bridger": ["--modality_bridger"]}


@pytest.mark.parametrize("run", sorted(FLAGS))
def test_predict_cli_gives_the_jax_clis_predictions(trained, monkeypatch,
                                                    run):
    from capdec_tpu.cli import predict as jax_cli
    from capdec_tpu_torch.cli import predict as cli
    tmp, data, corpus = trained
    monkeypatch.chdir(tmp)
    monkeypatch.setenv("CAPDEC_DATA_ROOT", str(tmp / "dataroot"))
    monkeypatch.setenv("CAPDEC_JAX_CACHE", str(tmp / "jaxcache"))
    monkeypatch.setattr(jax_gpt2, "GPT2Config",
                        functools.partial(jax_gpt2.GPT2Config, **CLI_GPT))
    monkeypatch.setattr(gpt2, "GPT2Config",
                        functools.partial(gpt2.GPT2Config, **CLI_GPT))
    if run == "bridger":
        # a bridger the port trained, where both CLIs look for it
        model = bridger.train_bridger(
            corpus["clip_embedding"], corpus["clip_embedding_text_dave"],
            dim=640, num_layers=2, epochs=2, batch_size=8, log_every=100)
        bridger.save_bridger(model, str(tmp / bridger.DEFAULT_WEIGHTS_PATH))
    want = _predict(jax_cli, tmp, data, FLAGS[run], f"jax_{run}")
    got = _predict(cli, tmp, data, FLAGS[run] + ["--device", "cpu"],
                   f"port_{run}")
    assert got == want
    preds, scores = got
    assert len(preds) == 8
    assert all(set(p) == {"caption", "image_id"} for p in preds)
    assert scores["num_images"] == 8


def test_predict_cli_int8_kv_and_refusals(trained, monkeypatch):
    from capdec_tpu_torch.cli import predict as cli
    tmp, data, _ = trained
    monkeypatch.chdir(tmp)
    monkeypatch.setenv("CAPDEC_DATA_ROOT", str(tmp / "dataroot"))
    monkeypatch.setattr(gpt2, "GPT2Config",
                        functools.partial(gpt2.GPT2Config, **CLI_GPT))
    preds, scores = _predict(cli, tmp, data, ["--int8_kv", "--device", "cpu"],
                             "port_int8")
    assert len(preds) == 8 and scores["num_images"] == 8
    base = ["--checkpoint", str(tmp / "ckpt" / "tiny-000.pt"), "--device",
            "cpu"]
    # a mesh larger than the world (one process here) is refused
    with pytest.raises(ValueError, match="device count 1"):
        cli.main(base + ["--embeddings_pickle", data, "--mesh", "2"])
    # --clip_checkpoint runs: tests/test_torch_predict_clip.py


# ---------------------------------------------------------------------------
# prefix tools
# ---------------------------------------------------------------------------


def test_prefix_readout_and_editing_match_jax():
    jcfg, tcfg, params, model = _models(2)
    tok = ByteTokenizer()
    ids = [65, 66, 67]
    pe = gpt2.embed_tokens(model.gpt, torch.tensor(ids))[None]
    assert prefix_tools.get_prefix_tokens(model, pe, tok) == "ABC"
    x = np.random.RandomState(3).randn(1, 4, 32).astype(np.float32)
    assert prefix_tools.get_prefix_tokens(model, torch.from_numpy(x), tok) \
        == jax_tools.get_prefix_tokens(params, jnp.asarray(x),
                                       JaxByteTokenizer())
    for where in (-1, 0, 2, 4):
        got = prefix_tools.add_embedding_from_text(
            model, "hi", torch.from_numpy(x), tok, where)
        want = jax_tools.add_embedding_from_text(
            params, "hi", jnp.asarray(x), JaxByteTokenizer(), where)
        assert got.shape == (1, 6, 32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    removed = prefix_tools.remove_positions(got, [0, 5])
    np.testing.assert_array_equal(
        removed.numpy(), np.asarray(jax_tools.remove_positions(want, [0, 5])))


@pytest.mark.parametrize("use_beam", [False, True])
def test_inspect_samples_matches_jax(tmp_path, use_beam):
    from capdec_tpu.data import dataset as jax_data
    from capdec_tpu_torch.data import dataset as data_lib
    rng = np.random.RandomState(0)
    caps = [{"caption": f"cap {i}.", "image_id": 100 + i, "id": i,
             "clip_embedding": i} for i in range(6)]
    data = {"clip_embedding": rng.randn(6, 16).astype(np.float32),
            "captions": caps,
            "clip_embedding_text_dave": rng.randn(6, 16).astype(np.float32)}
    path = str(tmp_path / "d.pkl")
    with open(path, "wb") as f:
        pickle.dump(data, f)
    jcfg, tcfg, params, model = _models(4)
    jcfg = dataclasses.replace(jcfg, prefix_length=4)
    ds = data_lib.load_caption_dataset(path, 4, ByteTokenizer())
    jds = jax_data.load_caption_dataset(path, 4, JaxByteTokenizer())
    got = prefix_tools.inspect_samples(model, tcfg, ds, ByteTokenizer(),
                                       [101, 104], use_beam=use_beam)
    want = jax_tools.inspect_samples(params, jcfg, jds, JaxByteTokenizer(),
                                     [101, 104], use_beam=use_beam)
    assert got == want
    assert {r["image_id"] for r in got} == {101, 104}


def test_inspect_cli_matches_jax(trained, monkeypatch):
    """The inspect CLI of both packages on the e2e checkpoint (their
    caption-model configs monkeypatched to the tiny GPT-2)."""
    from capdec_tpu.cli import inspect_prefixes as jax_cli
    from capdec_tpu_torch.cli import inspect_prefixes as cli
    tmp, data, _ = trained
    monkeypatch.setenv("CAPDEC_JAX_CACHE", str(tmp / "jaxcache"))
    monkeypatch.setattr(jax_cm, "CaptionModelConfig", functools.partial(
        jax_cm.CaptionModelConfig, gpt2=jax_gpt2.GPT2Config(**CLI_GPT)))
    monkeypatch.setattr(caption_model, "CaptionModelConfig",
                        functools.partial(caption_model.CaptionModelConfig,
                                          gpt2=gpt2.GPT2Config(**CLI_GPT)))
    flags = ["--checkpoint", str(tmp / "ckpt" / "tiny-000.pt"), "--data",
             data, "--prefix_length", "2", "--prefix_length_clip", "2",
             "--num_layers", "1", "--image_ids", "1,2,3", "--no_beam"]
    got = cli.main(flags + ["--device", "cpu"])
    assert len(got) == 3
    # the JAX CLI returns nothing: rebuild its records from the same calls
    from capdec_tpu.data import dataset as jax_data
    from capdec_tpu.utils import checkpoint as jax_ckpt
    from capdec_tpu.utils.tokenizer import load_tokenizer
    jcfg = jax_cm.CaptionModelConfig(prefix_length=2, clip_length=2,
                                     prefix_size=640, num_layers=1,
                                     mapping_type="mlp")
    params = jax_ckpt.load_caption_checkpoint(
        str(tmp / "ckpt" / "tiny-000.pt"), jcfg)
    tok = load_tokenizer()
    want = jax_tools.inspect_samples(
        params, jcfg, jax_data.load_caption_dataset(data, 2, tok), tok,
        ["1", "2", "3"], use_beam=False, max_items=10)
    assert got == want
    jax_cli.main(flags)

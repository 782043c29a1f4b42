"""The port's probes against the JAX package's, on the CPU in float32 (the
kernels' plain versions; the JAX kernels in interpret mode):

  * scripts/torch_int8_quality_probe.py: the same corpus as the JAX
    probe's generator; given the same JAX-trained parameters carried
    across, its decode-and-score gives the JAX probe's captions of both
    decodes, the same flip count and the same scores (1e-6);
  * scripts/torch_train_packing_probe.py: `packed_loss_forward` equals the
    port's unpacked `loss_forward` over the same samples, and the JAX
    script's `packed_loss_forward` on the same weights (1e-5), with equal
    gradients; its CPU check passes;
  * the mains of scripts/torch_serve_throughput.py (beam, --int8,
    --no_beam, --sync), torch_train_scaling.py, torch_embed_throughput.py
    and torch_chip_roofline.py at tiny monkeypatched sizes with
    `--device cpu`: each prints its lines.
"""
import importlib.util
import pathlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capdec_tpu_torch.models import caption_model

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def script(name):
    """scripts/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def numpy_tree(params):
    return jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# int8 quality probe
# ---------------------------------------------------------------------------

PROBE_N, PROBE_EVAL = 160, 16


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    """The JAX probe's model trained by the JAX package on the corpus (2
    epochs of PROBE_N samples), its corpus, and the JAX probe's
    decode-and-score (scripts/int8_quality_probe.py:99-127 with the
    kernels in interpret mode, as it runs off the TPU)."""
    from capdec_tpu.data import dataset as jdata
    from capdec_tpu.decode import BeamConfig
    from capdec_tpu.eval import metrics as jmetrics
    from capdec_tpu.eval import predictions as jpred
    from capdec_tpu.models import caption_model as jcm
    from capdec_tpu.models import gpt2 as jgpt2
    from capdec_tpu.train import loop as jloop
    from capdec_tpu.train import step as jstep
    from capdec_tpu.utils.tokenizer import ByteTokenizer

    jax_probe = script("int8_quality_probe")
    port_probe = script("torch_int8_quality_probe")
    d = tmp_path_factory.mktemp("probe")
    jcfg = jcm.CaptionModelConfig(
        prefix_length=4, clip_length=4, prefix_size=16, num_layers=2,
        mapping_type="mlp",
        gpt2=jgpt2.GPT2Config(vocab_size=256, n_positions=64, n_embd=128,
                              n_layer=2, n_head=2))
    jax_path, port_path = str(d / "jax.pkl"), str(d / "port.pkl")
    jax_probe.make_hard_corpus(jax_path, n=PROBE_N, dim=jcfg.prefix_size)
    port_probe.make_hard_corpus(port_path, n=PROBE_N, dim=jcfg.prefix_size)
    with open(jax_path, "rb") as f:
        corpus = pickle.load(f)
    tok = ByteTokenizer()
    ds = jdata.load_caption_dataset(jax_path, jcfg.prefix_length, tok)
    result = jloop.train(jcfg, jloop.TrainLoopConfig(
        epochs=2, batch_size=32, lr=2e-3, warmup_steps=0, save_every=1000,
        out_dir=str(d / "run"), prefix="probe", log_every=10000,
        save_state=False), ds, jstep.NoiseConfig(variance=0.001))
    params = result["params"]

    records = [{"image_id": c["image_id"],
                "clip_embedding": c["clip_embedding"],
                "caption": c["caption"]}
               for c in corpus["captions"][:PROBE_EVAL]]
    embed_fn = jpred.make_pickle_embed_fn(corpus["clip_embedding"])
    gt = {"images": [{"id": r["image_id"]} for r in records],
          "annotations": [{"image_id": r["image_id"],
                           "caption": r["caption"], "id": i}
                          for i, r in enumerate(records)]}
    base = dict(beam_size=5, entry_length=18, stop_token=ord("."))
    kern = dict(fused_interpret=True, pallas_reorder=False)
    variants = {"exact": BeamConfig(**base, **kern),
                "int8": BeamConfig(**base, **kern, kv_cache_int8=True,
                                   fused_attention=True)}
    preds, scores = {}, {}
    for name, bc in variants.items():
        pcfg = jpred.PredictConfig(beam=True, batch_size=PROBE_EVAL,
                                   beam_config=bc)
        preds[name] = jpred.run_predictions(records, embed_fn, params, jcfg,
                                            tok, pcfg)
        scores[name] = jmetrics.score_predictions(preds[name], gt)
    flips = sum(a["caption"] != b["caption"]
                for a, b in zip(preds["exact"], preds["int8"]))
    return dict(port_probe=port_probe, corpus=corpus, port_path=port_path,
                params=numpy_tree(params), preds=preds, scores=scores,
                flips=flips, loss=result["loss_per_epoch"]["train"])


def test_probe_corpus_equals_the_jax_generators(probe):
    with open(probe["port_path"], "rb") as f:
        got = pickle.load(f)
    want = probe["corpus"]
    assert got["captions"] == want["captions"]
    for k in ("clip_embedding", "clip_embedding_text_dave"):
        assert np.array_equal(got[k], want[k])


def test_int8_probe_decode_and_score_equals_the_jax_probes(probe):
    from capdec_tpu_torch.utils.tokenizer import ByteTokenizer
    mod = probe["port_probe"]
    cfg = mod.model_config()
    model = caption_model.params_from_jax_numpy(probe["params"], cfg)
    out = mod.decode_and_score(model, cfg, probe["corpus"], PROBE_EVAL,
                               ByteTokenizer(), device="cpu")
    assert out["eval_n"] == PROBE_EVAL
    for name in ("exact", "int8"):
        assert out["preds"][name] == probe["preds"][name], name
        for k, want in probe["scores"][name].items():
            if isinstance(want, float):
                assert abs(out["scores"][name][k] - want) <= 1e-6, (name, k)
        # a soft model still ends captions at '.' before the cap
        assert out["stopped"][name] > 0
    assert out["flips"] == probe["flips"]
    assert probe["loss"][-1] < probe["loss"][0]  # it trained
    assert sorted(out["deltas"]) == list(mod.SCORE_LENGTHS)
    for d in out["deltas"].values():
        assert all(np.isfinite(v) and v >= 0 for v in d.values())
        assert d["rank0_max"] < 0.1 * d["mean_abs_cum_score"]


def test_int8_probe_main_trains_and_reports(capsys):
    mod = script("torch_int8_quality_probe")
    out = mod.main(["epochs=1", "n=64", "eval_n=8", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "caption flips:" in printed and "CIDEr" in printed
    assert "E=18:" in printed
    assert len(out["train_loss"]) == 1 and np.isfinite(out["train_loss"][0])
    assert set(out["preds"]) == {"exact", "int8"}
    assert all(len(p) == 8 for p in out["preds"].values())


# ---------------------------------------------------------------------------
# packing probe
# ---------------------------------------------------------------------------


def test_packed_loss_equals_unpacked_and_the_jax_scripts():
    from capdec_tpu.models import caption_model as jcm
    jax_mod = script("train_packing_probe")
    mod = script("torch_train_packing_probe")
    jcfg = jax_mod._tiny_cfg()
    cfg = mod._tiny_cfg()
    params = numpy_tree(jcm.init_params(jax.random.PRNGKey(0), jcfg))
    model = caption_model.params_from_jax_numpy(params, cfg)
    tokens, prefix, mask = mod.check_inputs(cfg)
    B, P, T = tokens.shape

    t, x, m = (torch.from_numpy(a) for a in (tokens, prefix, mask))
    packed = mod.packed_loss_forward(model, cfg, t, x, m)
    packed.backward()
    g_packed = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad()
    flat = caption_model.loss_forward(
        model, cfg, t.reshape(B * P, T).long(), x.reshape(B * P, -1),
        m.reshape(B * P, -1))
    flat.backward()
    packed, flat = float(packed.detach()), float(flat.detach())
    assert abs(packed - flat) <= 1e-5
    for n, p in model.named_parameters():
        assert torch.allclose(g_packed[n], p.grad, atol=1e-5, rtol=1e-4), n

    want = float(jax_mod.packed_loss_forward(
        params, jcfg, jnp.asarray(tokens), jnp.asarray(prefix),
        jnp.asarray(mask)))
    assert abs(packed - want) <= 1e-5


def test_packing_check_passes(capsys):
    mod = script("torch_train_packing_probe")
    packed, flat = mod.check_correctness()
    assert abs(packed - flat) < 1e-4
    assert "OK: packed == unpacked" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the throughput mains at tiny sizes
# ---------------------------------------------------------------------------

TINY_GPT = dict(vocab_size=300, n_positions=96, n_embd=64, n_layer=2,
                n_head=2)
SERVE_KEYS = {"serve_captions_per_sec", "served", "wall_s", "batches",
              "mode", "beam", "int8", "latency_p50_s", "latency_p99_s"}


def tiny_caption_config(**kw):
    from capdec_tpu_torch.models import gpt2
    return caption_model.CaptionModelConfig(
        prefix_length=4, clip_length=4, prefix_size=16, num_layers=1,
        gpt2=gpt2.GPT2Config(**TINY_GPT), **kw)


@pytest.mark.parametrize("flags", [[], ["--int8"], ["--no_beam"],
                                   ["--sync"]], ids=lambda f: f[0][2:]
                         if f else "beam")
def test_serve_throughput_main(flags, monkeypatch, capsys):
    import json
    mod = script("torch_serve_throughput")
    monkeypatch.setattr(mod, "model_config", tiny_caption_config)
    out = mod.main(["--n", "6", "--batch", "4", "--device", "cpu", *flags])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == SERVE_KEYS and line == out
    assert line["served"] == 6 and line["batches"] == 2
    assert line["serve_captions_per_sec"] > 0
    assert line["mode"] == ("sync" if "--sync" in flags else "pipelined")
    assert line["beam"] == ("--no_beam" not in flags)
    assert line["int8"] == ("--int8" in flags)
    if "--sync" not in flags:
        assert 0 < line["latency_p50_s"] <= line["latency_p99_s"]


def test_train_scaling_main(monkeypatch, capsys):
    mod = script("torch_train_scaling")
    monkeypatch.setattr(mod, "model_config",
                        lambda c: tiny_caption_config(ce_chunk_rows=c,
                                                      only_prefix=True))
    monkeypatch.setattr(mod, "T", 5)
    monkeypatch.setattr(mod, "K", 2)
    monkeypatch.setenv("CE_CHUNK", "3")
    rates = mod.main(["4", "6", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [x.split(":")[0] for x in lines] == ["bs=4 ce_chunk=3",
                                                "bs=6 ce_chunk=3"]
    assert all("samples/s" in x and "ms/step" in x for x in lines)
    assert sorted(rates) == [4, 6] and all(r > 0 for r in rates.values())


def test_embed_throughput_main(monkeypatch, capsys):
    from capdec_tpu_torch.models import clip
    mod = script("torch_embed_throughput")
    text = clip.CLIPTextConfig(width=32, heads=2, layers=1, embed_dim=16)
    tiny = {"ViT-B/32": clip.CLIPConfig(
                "ViT-B/32", text, clip.CLIPViTConfig(
                    image_resolution=32, patch_size=16, width=32, layers=1,
                    heads=2, embed_dim=16)),
            "RN50x4": clip.CLIPConfig(
                "RN50x4", text, clip.CLIPResNetConfig(
                    layers=(1, 1, 1, 1), width=8, image_resolution=64,
                    embed_dim=16))}
    monkeypatch.setattr(clip, "MODEL_CONFIGS", tiny)
    for name, n in (("TEXT_BATCH", 8), ("VIT_BATCH", 4), ("RN_BATCH", 2),
                    ("BATCH1_CALLS", 2)):
        monkeypatch.setattr(mod, name, n)
    rates = mod.main(["image=1", "--device", "cpu"])
    printed = capsys.readouterr().out
    for want in ("CLIP text encode:", "reference batch-1 structure:",
                 "CLIP ViT-B/32 image encode:", "CLIP RN50x4 image encode:"):
        assert want in printed
    assert sorted(rates) == ["RN50x4", "ViT-B/32", "text"]
    assert all(a > 0 and b > 0 for a, b in rates.values())
    # the text tower alone by default
    assert sorted(mod.main(["--device", "cpu"])) == ["text"]


def test_chip_roofline_main(monkeypatch, capsys):
    mod = script("torch_chip_roofline")
    monkeypatch.setattr(mod, "MATMULS", [(32, 16, 24, 2), (8, 64, 16, 2)])
    monkeypatch.setattr(mod, "COPY_ELEMENTS", 1 << 12)
    monkeypatch.setattr(mod, "LAUNCHES", 10)
    out = mod.main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert printed.count("TFLOP/s") == 2 and "GB/s" in printed
    assert "us/launch" in printed and "dispatch overhead" in printed
    assert sorted(out["matmul_tflops"]) == ["32x16x24", "8x64x16"]
    assert out["hbm_gb_per_s"] > 0 and out["dispatch_ms"] > 0

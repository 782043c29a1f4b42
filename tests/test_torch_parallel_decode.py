"""dp-sharded and tp-split decode of the port on gloo worlds: the
counterparts of tests/test_sharded_eval.py (:20, :46, :75, :126) and of
tests/test_serve.py's mesh case.

A spawned world of 2 (tests/torch_parallel_helpers.py) runs, on a dp-2
mesh, beam search over its rows (f32 and int8 KV), `run_predictions`
with a ragged last batch, `CaptionServer` with a follower rank and the
predict CLI with `--mesh 2`; then, on a (dp 1, tp 2) mesh, prefill,
beam and greedy over a tp-split GPT-2. The world-1 references run here:
the port for the dp checks (tokens, lengths and order identical, beam
scores within 1e-6 absolute: other batch sizes, other summation
blocking), the JAX package's unsharded decode for the tp checks (prefill
logits within 1e-4, tokens identical). The serve CLI also runs with
`--mesh 2` under torchrun (`python -m torch.distributed.run --standalone
--nproc_per_node 2`).
"""
import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capdec_tpu.decode import BeamConfig as JaxBeamConfig
from capdec_tpu.decode import ToppConfig as JaxToppConfig
from capdec_tpu.decode import beam_search as jax_beam_search
from capdec_tpu.decode import greedy_topp_search as jax_greedy
from capdec_tpu.models import caption_model as jax_cm
from capdec_tpu.models import gpt2 as jax_gpt2
from capdec_tpu_torch import serve
from capdec_tpu_torch.decode import BeamConfig, beam_search
from capdec_tpu_torch.eval import predictions
from capdec_tpu_torch.models import caption_model, gpt2
from capdec_tpu_torch.utils import checkpoint
from capdec_tpu_torch.utils.tokenizer import ByteTokenizer
from torch_parallel_helpers import ROOT, TESTS, run_world

torch.set_num_threads(2)

TINY = dict(vocab_size=128, n_positions=64, n_embd=32, n_layer=2, n_head=4)
SMALL = dict(vocab_size=128, n_positions=80, n_embd=32, n_layer=1, n_head=4)
CM = dict(prefix_length=4, clip_length=4, prefix_size=8, num_layers=1,
          mapping_type="mlp")
BEAMS = {"beam": dict(beam_size=4, entry_length=8, stop_token=-1),
         "int8": dict(beam_size=4, entry_length=12, stop_token=-1,
                      fused_attention=True, kv_cache_int8=True)}
PRED_BEAM = dict(beam_size=3, entry_length=6, stop_token=-1)


def tree(init, cfg, seed):
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), cfg))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("decode")
    gtree = tree(jax_gpt2.init_params, jax_gpt2.GPT2Config(**TINY), 2)
    prefixes = np.random.RandomState(2).randn(16, 6, 32).astype(
        np.float32) * 0.05
    ctree = tree(jax_cm.init_params, jax_cm.CaptionModelConfig(
        gpt2=jax_gpt2.GPT2Config(**SMALL), **CM), 3)
    records = [{"image_id": i, "clip_embedding": i} for i in range(11)]
    embeds = np.random.RandomState(0).randn(11, 8).astype(np.float32)
    serve_embeds = np.random.RandomState(4).randn(10, 8).astype(np.float32)
    ttree = tree(jax_gpt2.init_params, jax_gpt2.GPT2Config(**TINY), 1)
    tprefixes = np.random.RandomState(1).randn(8, 6, 32).astype(
        np.float32) * 0.05
    payload = {
        "gpt_only": {"gpt": TINY, "tree": gtree, "prefixes": prefixes,
                     "beams": BEAMS},
        "predict": {"cm": CM, "gpt": SMALL, "tree": ctree,
                    "records": records, "prefixes": embeds,
                    "beam": PRED_BEAM, "kw": {"batch_size": 4},
                    "out": str(tmp / "preds.json")},
        "serve": {"embeds": serve_embeds,
                  "kw": {"batch_size": 4, "max_wait_s": 0.01}},
        "tp": {"gpt": TINY, "tree": ttree, "prefixes": tprefixes,
               "beam": dict(beam_size=4, entry_length=8, stop_token=-1),
               "greedy": dict(entry_length=8, stop_token=-1,
                              extra_stop_token=-1)},
    }
    payload["cli"] = predict_cli_inputs(payload["predict"], tmp)
    got = run_world(2, "decode_world", payload, tmp / "world")
    return payload, got, tmp


def predict_cli_inputs(p, tmp):
    """A checkpoint, an embeddings pickle and the dataset_mode-0 registry
    for the predict CLI (`--infer_model_config`: no config flags)."""
    cfg, model = caption_model_of(p)
    checkpoint.save_caption_checkpoint(model, cfg, str(tmp / "m.pt"))
    with open(tmp / "emb.pkl", "wb") as f:
        pickle.dump({"clip_embedding": p["prefixes"], "captions": []}, f)
    ann = tmp / "dataroot" / "coco" / "annotations"
    ann.mkdir(parents=True)
    (ann / "single_caption_per_sample_val.json").write_text(json.dumps(
        [dict(r, caption="x") for r in p["records"]]))
    argv = ["--checkpoint", str(tmp / "m.pt"), "--embeddings_pickle",
            str(tmp / "emb.pkl"), "--infer_model_config", "--no_bf16",
            "--batch_size", "4", "--dataset_mode", "0", "--device", "cpu"]
    return {"data_root": str(tmp / "dataroot"),
            "argv": argv + ["--out", str(tmp / "cli_dp2.json"),
                            "--mesh", "2"],
            "world1": argv + ["--out", str(tmp / "cli_w1.json")]}


def caption_model_of(p):
    cfg = caption_model.CaptionModelConfig(gpt2=gpt2.GPT2Config(**p["gpt"]),
                                           **p["cm"])
    return cfg, caption_model.params_from_jax_numpy(p["tree"], cfg)


@pytest.mark.parametrize("name", sorted(BEAMS))
def test_dp_beam_equals_world_one(world, name):
    payload, got, _ = world
    g = payload["gpt_only"]
    cfg = gpt2.GPT2Config(**g["gpt"])
    model = gpt2.params_from_jax_numpy(g["tree"], cfg)
    want = beam_search(model, cfg, torch.from_numpy(g["prefixes"]),
                       BeamConfig(**BEAMS[name]))
    toks, lens, scores, order = got[name]
    np.testing.assert_array_equal(toks, want[0].numpy())
    np.testing.assert_array_equal(lens, want[1].numpy())
    np.testing.assert_array_equal(order, want[3].numpy())
    np.testing.assert_allclose(scores, want[2].numpy(), atol=1e-6, rtol=0)


def test_run_predictions_under_dp_with_a_ragged_batch(world):
    payload, got, tmp = world
    p = payload["predict"]
    cfg, model = caption_model_of(p)
    want = predictions.run_predictions(
        p["records"], predictions.make_pickle_embed_fn(p["prefixes"]),
        model, cfg, ByteTokenizer(),
        predictions.PredictConfig(batch_size=4,
                                  beam_config=BeamConfig(**PRED_BEAM)),
        device="cpu")
    assert got["predictions"] == want and len(want) == 11
    with open(p["out"]) as f:
        assert json.load(f) == want
    log = (tmp / "world" / "rank0.log").read_text()
    assert "[mesh] ragged batch of 3 not divisible by dp=2" in log
    assert "ragged" not in (tmp / "world" / "rank1.log").read_text()


def test_caption_server_under_dp_equals_unsharded(world):
    payload, got, _ = world
    p, s = payload["predict"], payload["serve"]
    cfg, model = caption_model_of(p)
    srv = serve.CaptionServer(
        model, cfg, ByteTokenizer(),
        serve.ServeConfig(beam_config=BeamConfig(**PRED_BEAM), **s["kw"]),
        device="cpu")
    want = dict(srv.serve((i, e) for i, e in enumerate(s["embeds"])))
    assert got["served"] == want and len(want) == 10
    with pytest.raises(ValueError, match="divisible by the mesh dp axis"):
        serve.CaptionServer(model, cfg, ByteTokenizer(), serve.ServeConfig(
            batch_size=3, mesh=_FakeMesh()), device="cpu")


class _FakeMesh:
    """What CaptionServer reads of a dp-2 mesh before it decodes."""
    shape = {"dp": 2, "tp": 1}
    device = torch.device("cpu")


def test_tp2_decode_matches_the_jax_unsharded_decode(world):
    payload, got, _ = world
    t = payload["tp"]
    jcfg = jax_gpt2.GPT2Config(**t["gpt"])
    jp = jax.tree.map(jnp.asarray, t["tree"])
    prefixes = jnp.asarray(t["prefixes"])
    np.testing.assert_allclose(
        got["tp"]["logits"],
        np.asarray(jax_gpt2.prefill(jp, jcfg, prefixes)[0]),
        atol=1e-4, rtol=1e-4)
    jbeam = jax_beam_search(jp, jcfg, prefixes, JaxBeamConfig(**t["beam"]))
    for i in (0, 1, 3):  # tokens, lengths, order
        np.testing.assert_array_equal(got["tp"]["beam"][i],
                                      np.asarray(jbeam[i]))
    jg = jax_greedy(jp, jcfg, prefixes, JaxToppConfig(**t["greedy"]))
    for i in (0, 1):
        np.testing.assert_array_equal(got["tp"]["greedy"][i],
                                      np.asarray(jg[i]))


def test_predict_cli_under_dp_equals_world_one(world, monkeypatch):
    from capdec_tpu_torch.cli import predict as cli

    payload, _, tmp = world
    monkeypatch.setenv("CAPDEC_DATA_ROOT", payload["cli"]["data_root"])
    cli.main(payload["cli"]["world1"])
    with open(tmp / "cli_w1.json") as f, open(tmp / "cli_dp2.json") as g:
        want, got = json.load(f), json.load(g)
    assert got == want and len(want) == 11


def test_serve_cli_under_torchrun_equals_world_one(world, tmp_path, capsys):
    from capdec_tpu_torch.cli import serve as cli

    payload, _, _ = world
    p = payload["predict"]
    cfg, model = caption_model_of(p)
    ckpt = str(tmp_path / "m.pt")
    checkpoint.save_caption_checkpoint(model, cfg, ckpt)
    pkl = str(tmp_path / "emb.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"clip_embedding": payload["serve"]["embeds"],
                     "captions": []}, f)
    flags = ["--checkpoint", ckpt, "--embeddings_pickle", pkl,
             "--batch_size", "4", "--no_bf16", "--prefix_dim", "8",
             "--prefix_length", "4", "--prefix_length_clip", "4",
             "--num_layers", "1", "--mapping_type", "mlp", "--beam_size",
             "3", "--entry_length", "6", "--device", "cpu"]

    def captions(out):
        lines = [json.loads(x) for x in out.strip().splitlines()
                 if x.startswith("{")]
        assert [x["served"] for x in lines if "served" in x] == [10]
        return {x["id"]: x["caption"] for x in lines if "caption" in x}

    cli.main(flags)
    want = captions(capsys.readouterr().out)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(TESTS), os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "capdec_tpu_torch.cli.serve",
         *flags, "--mesh", "2"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=180)
    assert run.returncode == 0, run.stderr[-3000:]
    assert captions(run.stdout) == want and len(want) == 10

"""The port's greedy/top-p caption server and serving CLI against the JAX
package, in float32 on the CPU.

`CaptionServer(beam=False, device="cpu")` and
`python -m capdec_tpu_torch.cli.serve --no_beam --device cpu` (kernel
wrappers -> plain versions on CPU tensors) give the captions of the JAX
`CaptionServer(beam=False)` and of the JAX serving CLI under `--no_beam`.
"""
import functools
import json
import pickle

import jax
import numpy as np
import pytest
import torch

from capdec_tpu import serve as jax_serve
from capdec_tpu.models import caption_model as jax_cm
from capdec_tpu.models import gpt2 as jax_gpt2
from capdec_tpu.utils import checkpoint as jax_ckpt
from capdec_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer
from capdec_tpu_torch import serve
from capdec_tpu_torch.models import caption_model, gpt2
from capdec_tpu_torch.utils.tokenizer import ByteTokenizer

torch.set_num_threads(2)

TINY_GPT = dict(vocab_size=300, n_positions=64, n_embd=128, n_layer=2,
                n_head=2)
K, E = 5, 20


@pytest.fixture(scope="module")
def models():
    jcfg = jax_cm.CaptionModelConfig(
        prefix_length=K, clip_length=K, prefix_size=32, num_layers=2,
        gpt2=jax_gpt2.GPT2Config(**TINY_GPT))
    params = jax_cm.init_params(jax.random.PRNGKey(9), jcfg)
    tcfg = caption_model.CaptionModelConfig(
        prefix_length=K, clip_length=K, prefix_size=32, num_layers=2,
        gpt2=gpt2.GPT2Config(**TINY_GPT))
    model = caption_model.params_from_jax_numpy(
        jax.tree.map(np.asarray, params), tcfg)
    return jcfg, params, tcfg, model


@pytest.fixture(scope="module")
def embeds():
    return np.random.RandomState(15).randn(7, 32).astype(np.float32)


def test_greedy_caption_server_matches_jax(models, embeds):
    jcfg, params, tcfg, model = models
    jsrv = jax_serve.CaptionServer(
        params, jcfg, JaxByteTokenizer(),
        jax_serve.ServeConfig(batch_size=4, beam=False,
                              topp_config=jax_serve.ToppConfig(
                                  entry_length=E)))
    want = jsrv.caption(embeds[:4]) + jsrv.caption(embeds[4:])
    tsrv = serve.CaptionServer(
        model, tcfg, ByteTokenizer(),
        serve.ServeConfig(batch_size=4, max_wait_s=0.01, beam=False,
                          topp_config=serve.ToppConfig(entry_length=E)),
        device="cpu")
    assert tsrv.caption(embeds[:4]) + tsrv.caption(embeds[4:]) == want
    # the continuous-batching loop answers every request with the same text
    got = dict(tsrv.serve(iter(enumerate(embeds))))
    assert [got[i] for i in range(len(embeds))] == want
    assert len(set(want)) > 1


def test_serve_cli_no_beam_prints_the_jax_clis_captions(models, embeds,
                                                        tmp_path, capsys,
                                                        monkeypatch):
    from capdec_tpu.cli import serve as jax_cli
    from capdec_tpu_torch.cli import serve as cli

    jcfg, params, _, _ = models
    path = str(tmp_path / "tiny.pt")
    jax_ckpt.save_caption_checkpoint(params, jcfg, path)
    pkl = str(tmp_path / "emb.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"clip_embedding": embeds, "captions": []}, f)
    flags = ["--checkpoint", path, "--embeddings_pickle", pkl,
             "--batch_size", "4", "--no_bf16", "--prefix_dim", "32",
             "--prefix_length", str(K), "--prefix_length_clip", str(K),
             "--num_layers", "2", "--mapping_type", "transformer",
             "--entry_length", str(E), "--no_beam"]

    def captions():
        lines = [json.loads(x) for x in
                 capsys.readouterr().out.strip().splitlines()]
        assert [x["served"] for x in lines if "captions_per_s" in x] == [7]
        return {x["id"]: x["caption"] for x in lines if "caption" in x}

    # the JAX CLI builds a full-size GPT-2 config; give it the tiny one
    monkeypatch.setenv("CAPDEC_JAX_CACHE", str(tmp_path / "jaxcache"))
    monkeypatch.setattr(jax_gpt2, "GPT2Config",
                        functools.partial(jax_gpt2.GPT2Config, **TINY_GPT))
    jax_cli.main(flags)
    want = captions()
    cli.main(flags + ["--device", "cpu"])
    assert captions() == want
    assert len(want) == 7

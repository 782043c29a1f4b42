"""The port's int8-KV caption server and serving CLI against the JAX
package, in float32 on the CPU.

`CaptionServer(device="cpu")` with `BeamConfig(kv_cache_int8=True)` and
`python -m capdec_tpu_torch.cli.serve --int8_kv --device cpu` (kernel
wrappers -> plain versions on CPU tensors) give the captions of the JAX
`CaptionServer` with `kv_cache_int8=True, fused_attention=True,
pallas_reorder=True, fused_interpret=True`. The JAX serving CLI itself
turns the Pallas kernels on without interpret mode under `--int8_kv`, so
it cannot run on the CPU; its server in the interpret configuration is
the reference.
"""
import json
import pickle

import jax
import numpy as np
import pytest
import torch

from capdec_tpu import serve as jax_serve
from capdec_tpu.decode import BeamConfig as JaxBeamConfig
from capdec_tpu.models import caption_model as jax_cm
from capdec_tpu.models import gpt2 as jax_gpt2
from capdec_tpu.utils import checkpoint as jax_ckpt
from capdec_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer
from capdec_tpu_torch import serve
from capdec_tpu_torch.decode import beam
from capdec_tpu_torch.models import caption_model, gpt2
from capdec_tpu_torch.utils.tokenizer import ByteTokenizer

torch.set_num_threads(2)

TINY_GPT = dict(vocab_size=300, n_positions=64, n_embd=128, n_layer=2,
                n_head=2)
K, R, E = 5, 4, 20
STOP = JaxBeamConfig().stop_token  # GPT-2's '.', the CLI's stop token


@pytest.fixture(scope="module")
def models():
    jcfg = jax_cm.CaptionModelConfig(
        prefix_length=K, clip_length=K, prefix_size=32, num_layers=2,
        gpt2=jax_gpt2.GPT2Config(**TINY_GPT))
    params = jax_cm.init_params(jax.random.PRNGKey(7), jcfg)
    tcfg = caption_model.CaptionModelConfig(
        prefix_length=K, clip_length=K, prefix_size=32, num_layers=2,
        gpt2=gpt2.GPT2Config(**TINY_GPT))
    model = caption_model.params_from_jax_numpy(
        jax.tree.map(np.asarray, params), tcfg)
    return jcfg, params, tcfg, model


@pytest.fixture(scope="module")
def embeds():
    return np.random.RandomState(5).randn(7, 32).astype(np.float32)


@pytest.fixture(scope="module")
def jax_captions(models, embeds):
    """The JAX int8 server's captions of `embeds` (batches of 4)."""
    jcfg, params, _, _ = models
    jsrv = jax_serve.CaptionServer(
        params, jcfg, JaxByteTokenizer(),
        jax_serve.ServeConfig(batch_size=4, beam_config=JaxBeamConfig(
            beam_size=R, entry_length=E, stop_token=STOP,
            kv_cache_int8=True, fused_attention=True, pallas_reorder=True,
            fused_interpret=True)))
    return jsrv.caption(embeds[:4]) + jsrv.caption(embeds[4:])


def test_int8_caption_server_matches_jax(models, embeds, jax_captions):
    _, _, tcfg, model = models
    tsrv = serve.CaptionServer(
        model, tcfg, ByteTokenizer(),
        serve.ServeConfig(batch_size=4, max_wait_s=0.01,
                          beam_config=beam.BeamConfig(
                              beam_size=R, entry_length=E, stop_token=STOP,
                              kv_cache_int8=True)),
        device="cpu")
    got = dict(tsrv.serve(iter(enumerate(embeds))))
    assert [got[i] for i in range(len(embeds))] == jax_captions


def test_serve_cli_int8_kv_matches_jax_server(models, embeds, jax_captions,
                                              tmp_path, capsys):
    from capdec_tpu_torch.cli import serve as cli

    jcfg, params, _, _ = models
    path = str(tmp_path / "tiny.pt")
    jax_ckpt.save_caption_checkpoint(params, jcfg, path)
    pkl = str(tmp_path / "emb.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"clip_embedding": embeds, "captions": []}, f)
    cli.main(["--checkpoint", path, "--embeddings_pickle", pkl,
              "--batch_size", "4", "--no_bf16", "--prefix_dim", "32",
              "--prefix_length", str(K), "--prefix_length_clip", str(K),
              "--num_layers", "2", "--mapping_type", "transformer",
              "--beam_size", str(R), "--entry_length", str(E), "--int8_kv",
              "--device", "cpu"])
    lines = [json.loads(x) for x in
             capsys.readouterr().out.strip().splitlines()]
    assert [x["served"] for x in lines if "captions_per_s" in x] == [7]
    got = {x["id"]: x["caption"] for x in lines if "caption" in x}
    assert [got[i] for i in range(len(embeds))] == jax_captions

"""Beams of more than 32 through the port's fused routes, against the JAX
package, in float32 on the CPU.

On the card a beam of more than 32 runs the attention kernel in three or
more row groups of 16 (tests/test_torch_cuda.py holds the kernels at R 33
and 48 against their plain versions). Here the port's default
`BeamConfig(beam_size=33)` resolves to the same fused route (K2, K1, K3,
K4 wrappers, on CPU tensors their plain versions) and must give the JAX
engine's tokens, lengths and beam order (scores within 1e-4) in the JAX
package's XLA configuration, its f32 reference on the CPU (its Pallas
attention takes bf16 products even for f32 inputs, so its interpret mode
is no f32 reference); the port's CaptionServer captions as the JAX server
does.
"""
import jax
import numpy as np
import pytest
import torch

from capdec_tpu import serve as jax_serve
from capdec_tpu.decode import BeamConfig as JaxBeamConfig
from capdec_tpu.decode import beam_search as jax_beam_search
from capdec_tpu.models import caption_model as jax_cm
from capdec_tpu.models import gpt2 as jax_gpt2
from capdec_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer
from capdec_tpu_torch import serve
from capdec_tpu_torch.decode import beam
from capdec_tpu_torch.models import caption_model, gpt2
from capdec_tpu_torch.utils.tokenizer import ByteTokenizer

torch.set_num_threads(2)

TINY_GPT = dict(vocab_size=300, n_positions=64, n_embd=128, n_layer=2,
                n_head=2)
N, K, E = 2, 5, 12


@pytest.fixture(scope="module")
def models():
    common = dict(prefix_length=K, clip_length=K, prefix_size=32,
                  num_layers=2)
    jcfg = jax_cm.CaptionModelConfig(gpt2=jax_gpt2.GPT2Config(**TINY_GPT),
                                     **common)
    params = jax_cm.init_params(jax.random.PRNGKey(5), jcfg)
    tcfg = caption_model.CaptionModelConfig(
        gpt2=gpt2.GPT2Config(**TINY_GPT), **common)
    model = caption_model.params_from_jax_numpy(
        jax.tree.map(np.asarray, params), tcfg)
    return jcfg, params, tcfg, model


@pytest.mark.parametrize("R", [33, 48])
def test_wide_beam_matches_jax(models, R):
    jcfg, params, tcfg, model = models
    prefixes = np.random.RandomState(R).randn(N, K, 128).astype(np.float32)
    bc = beam.BeamConfig(beam_size=R, entry_length=E, stop_token=-1)
    assert beam.resolve_config(bc).fused_attention
    got = [t.numpy() for t in beam.beam_search(
        model.gpt, tcfg.gpt2, torch.from_numpy(prefixes), bc)]
    want = [np.asarray(t) for t in jax_beam_search(
        params["gpt"], jcfg.gpt2, jax.numpy.asarray(prefixes),
        JaxBeamConfig(beam_size=R, entry_length=E, stop_token=-1))]
    for name, i in (("tokens", 0), ("lengths", 1), ("order", 3)):
        np.testing.assert_array_equal(got[i], want[i], err_msg=name)
    np.testing.assert_allclose(got[2], want[2], atol=1e-4, rtol=0)


def test_wide_beam_serves_as_jax(models):
    jcfg, params, tcfg, model = models
    embeds = np.random.RandomState(9).randn(3, 32).astype(np.float32)
    kw = dict(beam_size=33, entry_length=E, stop_token=-1)
    want = jax_serve.CaptionServer(
        params, jcfg, JaxByteTokenizer(), jax_serve.ServeConfig(
            batch_size=4, beam_config=jax_serve.BeamConfig(**kw))
    ).caption(embeds)
    got = serve.CaptionServer(
        model, tcfg, ByteTokenizer(),
        serve.ServeConfig(batch_size=4, beam_config=beam.BeamConfig(**kw)),
        device="cpu").caption(embeds)
    assert got == want and len(got) == 3

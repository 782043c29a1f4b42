"""The port's beam-serving slice against the JAX package, in float32 on
the CPU.

Port `beam_search` / `CaptionServer(device="cpu")` (kernel wrappers ->
plain versions on CPU tensors) against JAX `beam_search` /
`CaptionServer` in both of its configurations:
  * the XLA config (the JAX CPU default: un-fused attention, staged cache
    growth, XLA gathers), and
  * the production TPU config (fused attention, chunked slot write, fused
    LM head, bounded fork copies, full-size cache; Pallas kernels in
    interpret mode),
with stopping on and off. Tokens, lengths and beam order must be
identical; scores agree within 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capdec_tpu import serve as jax_serve
from capdec_tpu.decode import BeamConfig as JaxBeamConfig
from capdec_tpu.decode import beam_search as jax_beam_search
from capdec_tpu.decode import beam_texts as jax_beam_texts
from capdec_tpu.models import caption_model as jax_cm
from capdec_tpu.models import gpt2 as jax_gpt2
from capdec_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer
from capdec_tpu_torch import serve
from capdec_tpu_torch.decode import beam
from capdec_tpu_torch.models import caption_model, gpt2
from capdec_tpu_torch.utils import torch_setup
from capdec_tpu_torch.utils.tokenizer import ByteTokenizer

torch.set_num_threads(2)

TINY_GPT = dict(vocab_size=300, n_positions=64, n_embd=128, n_layer=2,
                n_head=2)
N, K, R, E = 3, 5, 4, 20
PROD = dict(pallas_reorder=True, fused_interpret=True)


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
def prefixes():
    return np.random.RandomState(11).randn(N, K, 128).astype(np.float32)


@pytest.fixture(scope="module")
def stop_token(models, prefixes):
    """A token whose stop ends some returned beams early (random weights
    rarely emit '.'): the most frequent emitted token that does."""
    _, _, tcfg, model = models
    toks = _port(models, prefixes, -1)[0]
    vals, counts = np.unique(toks[:, :, 1:], return_counts=True)
    for tok in vals[np.argsort(-counts, kind="stable")]:
        if (_port(models, prefixes, int(tok))[1] < E).any():
            return int(tok)
    raise AssertionError("no emitted token stops a returned beam")


def _port(models, prefixes, stop):
    _, _, tcfg, model = models
    bc = beam.BeamConfig(beam_size=R, entry_length=E, stop_token=stop)
    return [t.numpy() for t in beam.beam_search(
        model.gpt, tcfg.gpt2, torch.from_numpy(prefixes), bc)]


@pytest.mark.parametrize("config", ["xla", "production"])
@pytest.mark.parametrize("stopping", [False, True])
def test_beam_search_matches_jax(models, prefixes, stop_token, config,
                                 stopping):
    jcfg, params, _, _ = models
    stop = stop_token if stopping else -1
    extra = PROD if config == "production" else {}
    want = jax.tree.map(np.asarray, jax_beam_search(
        params["gpt"], jcfg.gpt2, jnp.asarray(prefixes),
        JaxBeamConfig(beam_size=R, entry_length=E, stop_token=stop,
                      **extra)))
    got = _port(models, prefixes, stop)
    np.testing.assert_array_equal(got[0], want[0])   # tokens
    np.testing.assert_array_equal(got[1], want[1])   # lengths
    np.testing.assert_allclose(got[2], want[2], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got[3], want[3])   # order
    assert (got[1] < E).any() == stopping
    texts = beam.beam_texts(ByteTokenizer(), *(torch.from_numpy(got[j])
                                               for j in (0, 1, 3)))
    assert texts == jax_beam_texts(JaxByteTokenizer(), want[0], want[1],
                                   want[3])


def test_plain_config_matches_kernel_wrappers(models, prefixes, stop_token):
    """BeamConfig.plain() (every chosen op's plain version, the card's
    reference path) changes only `plain_ops`, and agrees with the default
    config on the CPU, where both run the plain versions."""
    _, _, tcfg, model = models
    bc = beam.BeamConfig(beam_size=R, entry_length=E, stop_token=stop_token)
    assert bc.plain() == dataclasses.replace(bc, plain_ops=True)
    x = torch.from_numpy(prefixes)
    a = beam.beam_search(model.gpt, tcfg.gpt2, x, bc)
    b = beam.beam_search(model.gpt, tcfg.gpt2, x, bc.plain())
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_resolve_config_defaults_and_unported_knobs():
    bc = beam.resolve_config(beam.BeamConfig())
    assert (bc.fused_attention and bc.chunk_slot_write and bc.fused_lm_head
            and bc.full_alloc and bc.bounded_fork_copy)
    assert bc.fused_slot_chunks == 0 and not bc.int8_prefix
    # int8 KV keeps staged growth and whole-row fork copies, as in JAX
    i8 = beam.resolve_config(beam.BeamConfig(kv_cache_int8=True))
    assert i8.fused_attention and not i8.full_alloc
    assert not i8.bounded_fork_copy
    assert not beam.resolve_config(
        beam.BeamConfig(full_alloc=False)).bounded_fork_copy
    with pytest.raises(ValueError, match="fused"):
        beam.resolve_config(beam.BeamConfig(kv_cache_int8=True,
                                            fused_attention=False))
    # the slot-bounded v3 knobs, ported: they resolve as in JAX
    v3 = beam.resolve_config(beam.BeamConfig(fused_slot_chunks=8))
    assert v3.fused_slot_chunks == 8 and not v3.full_alloc
    assert v3.bounded_fork_copy and not v3.int8_prefix
    v3_8 = beam.resolve_config(beam.BeamConfig(kv_cache_int8=True,
                                               fused_slot_chunks=8))
    assert v3_8.int8_prefix and v3_8.bounded_fork_copy


def _servers(models, stop):
    jcfg, params, tcfg, model = models
    jsrv = jax_serve.CaptionServer(params, jcfg, JaxByteTokenizer(),
                                   jax_serve.ServeConfig(
                                       batch_size=4, max_wait_s=0.01,
                                       beam_config=JaxBeamConfig(
                                           beam_size=R, entry_length=E,
                                           stop_token=stop)))
    tsrv = serve.CaptionServer(model, tcfg, ByteTokenizer(),
                               serve.ServeConfig(
                                   batch_size=4, max_wait_s=0.01,
                                   beam_config=beam.BeamConfig(
                                       beam_size=R, entry_length=E,
                                       stop_token=stop)),
                               device="cpu")
    return jsrv, tsrv


def test_caption_server_matches_jax(models, stop_token):
    jsrv, tsrv = _servers(models, stop_token)
    embeds = np.random.RandomState(5).randn(7, 32).astype(np.float32)
    want = jsrv.caption(embeds[:4]) + jsrv.caption(embeds[4:])
    assert tsrv.caption(embeds[:4]) + tsrv.caption(embeds[4:]) == want
    # the continuous-batching loop answers every request with the same text
    got = dict(tsrv.serve(iter(enumerate(embeds))))
    assert [got[i] for i in range(7)] == want
    pct = tsrv.latency_percentiles()
    assert pct["n"] == 7 and 0 < pct["p50"] <= pct["p95"] <= pct["p99"]


def test_serve_keeps_running_past_exhaust_and_honors_shutdown(models):
    import threading
    import time

    _, tsrv = _servers(models, -1)
    e0, e1 = np.random.RandomState(6).randn(2, 32).astype(np.float32)
    results = []

    def run():
        for rid, text in tsrv.serve(iter([("early", e0)]),
                                    stop_on_exhaust=False):
            results.append(rid)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    deadline = time.monotonic() + 30
    while len(results) < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    tsrv.submit("late", e1)
    while len(results) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert results == ["early", "late"]
    tsrv.shutdown()
    t.join(timeout=30)
    assert not t.is_alive()


def test_server_refuses_unported_modes_and_a_missing_card(models,
                                                          monkeypatch):
    _, _, tcfg, model = models
    # greedy/top-p serving is ported; mesh-sharded serving is not
    greedy = serve.CaptionServer(
        model, tcfg, ByteTokenizer(),
        serve.ServeConfig(batch_size=2, beam=False,
                          topp_config=serve.ToppConfig(entry_length=E)),
        device="cpu")
    texts = greedy.caption(np.random.RandomState(3).randn(2, 32).astype(
        np.float32))
    assert len(texts) == 2 and all(isinstance(t, str) for t in texts)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve.CaptionServer(model, tcfg, ByteTokenizer(),
                            serve.ServeConfig(mesh=4), device="cpu")
    # no card and no explicit device: raise, never fall back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_setup.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.CaptionServer(model, tcfg, ByteTokenizer(),
                            dataclasses.replace(serve.ServeConfig()))

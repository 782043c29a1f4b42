"""The port's non-lane beam search and the K14 slot-write route against
the JAX package, in float32 on the CPU.

Port `beam_search` (kernel wrappers -> plain versions on CPU tensors)
against the JAX engine with the same knobs:
  * `lane_beams=False` (the whole row-major cache gathered after each
    selection, K10's route), with the v2 and the slot-bounded v3
    attention;
  * `chunk_slot_write=False, pallas_slot_write=True` (the lane path with
    K14 in place of K3).
The JAX kernel path runs its Pallas kernels in interpret mode and its
gathers and slot write through XLA (`_reorder_gen_cache` and the K14
route call their kernels without `interpret`): tokens, lengths and beam
order must be identical, scores within 1e-3 (its kernels multiply in
bf16). Against the JAX XLA path with the same layout knobs: tokens
identical, scores within 1e-4. Stopping on and off. Also: `resolve_config`
resolves every knob as JAX's does with `pallas_reorder` on and refuses
what JAX refuses, and the server captions as JAX's under `lane_beams=False`.
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
from capdec_tpu.decode import beam as jax_beam
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
N, K, R, E = 3, 5, 4, 20   # E=20: cache slots 24
KERNELS = dict(fused_attention=True, fused_interpret=True,
               chunk_slot_write=True, fused_lm_head=True,
               pallas_reorder=False)
# config -> (port knobs, JAX kernel-path knobs, JAX XLA-path knobs)
CONFIGS = {
    "nonlane": (dict(lane_beams=False), dict(lane_beams=False, **KERNELS),
                dict(lane_beams=False)),
    "nonlane_v3": (dict(lane_beams=False, fused_slot_chunks=8),
                   dict(lane_beams=False, fused_slot_chunks=8, **KERNELS),
                   dict(lane_beams=False)),
    "slot_write_k14": (dict(chunk_slot_write=False, pallas_slot_write=True),
                       dict(chunk_slot_write=False, pallas_slot_write=False,
                            pallas_reorder=True, fused_interpret=True),
                       dict()),
}


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
    return np.random.RandomState(13).randn(N, K, 128).astype(np.float32)


def _port(models, prefixes, stop, **knobs):
    _, _, tcfg, model = models
    bc = beam.BeamConfig(beam_size=R, entry_length=E, stop_token=stop,
                         **knobs)
    return [t.numpy() for t in beam.beam_search(
        model.gpt, tcfg.gpt2, torch.from_numpy(prefixes), bc)]


def _jax(models, prefixes, stop, **knobs):
    jcfg, params, _, _ = models
    return jax.tree.map(np.asarray, jax_beam_search(
        params["gpt"], jcfg.gpt2, jnp.asarray(prefixes),
        JaxBeamConfig(beam_size=R, entry_length=E, stop_token=stop,
                      **knobs)))


@pytest.fixture(scope="module")
def stop_token(models, prefixes):
    """A token whose stop ends some returned beams early on every config
    (random weights rarely emit '.')."""
    toks = _port(models, prefixes, -1, lane_beams=False)[0]
    vals, counts = np.unique(toks[:, :, 1:], return_counts=True)
    for tok in vals[np.argsort(-counts, kind="stable")]:
        if all((_port(models, prefixes, int(tok), **knobs)[1] < E).any()
               for knobs, _, _ in CONFIGS.values()):
            return int(tok)
    raise AssertionError("no emitted token stops a returned beam")


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("stopping", [False, True])
def test_nonlane_beam_search_matches_jax(models, prefixes, stop_token,
                                         config, stopping):
    stop = stop_token if stopping else -1
    knobs, jax_kernels, jax_xla = CONFIGS[config]
    got = _port(models, prefixes, stop, **knobs)
    want = _jax(models, prefixes, stop, **jax_kernels)
    np.testing.assert_array_equal(got[0], want[0])   # tokens
    np.testing.assert_array_equal(got[1], want[1])   # lengths
    np.testing.assert_array_equal(got[3], want[3])   # order
    np.testing.assert_allclose(got[2], want[2], atol=1e-3, rtol=0)
    assert (got[1] < E).any() == stopping
    xla = _jax(models, prefixes, stop, **jax_xla)
    np.testing.assert_array_equal(got[0], xla[0])
    np.testing.assert_array_equal(got[3], xla[3])
    np.testing.assert_allclose(got[2], xla[2], atol=1e-4, rtol=0)


def test_nonlane_paths_agree_with_the_lane_path(models, prefixes,
                                                stop_token):
    """The cache moves are exact copies, so every layout of the beams
    gives the lane path's result bit for bit (tests/test_decode.py's
    "lane mode is bit-identical to rank mode")."""
    lane = _port(models, prefixes, stop_token)
    for knobs, _, _ in CONFIGS.values():
        got = _port(models, prefixes, stop_token, **knobs)
        for a, b in zip(got, lane):
            np.testing.assert_array_equal(a, b)


# (JAX BeamConfig knobs) configurations whose resolution is compared
RESOLVED = [
    {}, dict(lane_beams=False), dict(lane_beams=False, fused_slot_chunks=8),
    dict(rowmajor_cache=False), dict(rowmajor_cache=False, lane_beams=False),
    dict(ancestry=True), dict(ancestry=True, rowmajor_cache=False),
    dict(temperature=0.7), dict(temperature=0.0), dict(temperature=-1.0),
    dict(chunk_slot_write=False, pallas_slot_write=True),
    dict(lane_beams=False, pallas_reorder=False), dict(pallas_reorder=False),
    dict(kv_cache_int8=True), dict(kv_cache_int8=True, fused_slot_chunks=8),
    dict(fused_slot_chunks=8), dict(full_alloc=False),
]


@pytest.mark.parametrize("knobs", RESOLVED, ids=lambda k: ",".join(
    f"{n}={v}" for n, v in k.items()) or "default")
def test_resolve_config_resolves_as_jax(knobs):
    jax_knobs = dict({"pallas_reorder": True}, **knobs)
    want = jax_beam.resolve_config(JaxBeamConfig(**jax_knobs))
    got = beam.resolve_config(beam.BeamConfig(**knobs))
    for field in dataclasses.fields(got):
        if hasattr(want, field.name):
            assert getattr(got, field.name) == getattr(want, field.name), \
                field.name
    ported = {f.name for f in dataclasses.fields(got)}
    # every JAX knob is ported but those that only pick how the TPU
    # computes the same result or that measure it (README.md)
    assert {f.name for f in dataclasses.fields(want)} - ported == {
        "chunked_top_k", "onehot_gather", "mxu_reorder", "cast_params",
        "fused_block_beams", "fused_interpret", "skip_reorder_unsafe"}
    assert ported - {f.name for f in dataclasses.fields(want)} == {
        "plain_ops"}


@pytest.mark.parametrize("knobs", [
    dict(fused_lm_head=True, temperature=0.7),
    dict(kv_cache_int8=True, lane_beams=False, fused_attention=True),
    dict(kv_cache_int8=True, rowmajor_cache=False, fused_attention=True),
    dict(kv_cache_int8=True, ancestry=True, fused_attention=True),
    dict(kv_cache_int8=True, pallas_reorder=False),
])
def test_beam_search_refuses_what_jax_refuses(models, prefixes, knobs):
    with pytest.raises(ValueError) as want:
        _jax(models, prefixes, -1, **dict({"pallas_reorder": True}, **knobs))
    with pytest.raises(ValueError) as got:
        _port(models, prefixes, -1, **knobs)
    assert str(got.value) == str(want.value)


def test_caption_server_matches_jax_without_lanes(models, stop_token):
    jcfg, params, tcfg, model = models
    knobs = dict(beam_size=R, entry_length=E, stop_token=stop_token,
                 lane_beams=False)
    jsrv = jax_serve.CaptionServer(
        params, jcfg, JaxByteTokenizer(), jax_serve.ServeConfig(
            batch_size=4, max_wait_s=0.01,
            beam_config=JaxBeamConfig(**knobs)))
    tsrv = serve.CaptionServer(
        model, tcfg, ByteTokenizer(), serve.ServeConfig(
            batch_size=4, max_wait_s=0.01,
            beam_config=beam.BeamConfig(**knobs)), device="cpu")
    embeds = np.random.RandomState(5).randn(7, 32).astype(np.float32)
    want = jsrv.caption(embeds[:4]) + jsrv.caption(embeds[4:])
    got = dict(tsrv.serve(iter(enumerate(embeds))))
    assert [got[i] for i in range(7)] == want

"""The port's slot-bounded ("v3") beam search against the JAX package, in
float32 on the CPU.

Port `beam_search` (kernel wrappers -> plain versions on CPU tensors)
against the JAX engine with the same knobs and its Pallas kernels in
interpret mode:
  * v3 fp: `fused_slot_chunks=8` (K8's route, staged growth, bounded fork
    copies), with 1 and 3 cache stages;
  * v3 int8: `kv_cache_int8=True, fused_slot_chunks=8`, whose
    `int8_prefix` resolves on (K9 over an int8 prefix and generated
    cache).
Tokens, lengths and beam order must be identical, stopping on and off;
scores agree within 1e-4. The refusals of the v3 knobs match JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capdec_tpu.decode import BeamConfig as JaxBeamConfig
from capdec_tpu.decode import beam_search as jax_beam_search
from capdec_tpu.models import caption_model as jax_cm
from capdec_tpu.models import gpt2 as jax_gpt2
from capdec_tpu_torch.decode import beam
from capdec_tpu_torch.models import caption_model, gpt2

torch.set_num_threads(2)

TINY_GPT = dict(vocab_size=300, n_positions=64, n_embd=128, n_layer=2,
                n_head=2)
N, K, R, E = 3, 5, 4, 20   # E=20: cache slots 24
PROD = dict(pallas_reorder=True, fused_interpret=True)
CONFIGS = {
    "v3_1stage": dict(fused_slot_chunks=8, cache_stages=1),
    "v3_3stages": dict(fused_slot_chunks=8, cache_stages=3),
    "v3_int8": dict(fused_slot_chunks=8, kv_cache_int8=True),
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


@pytest.fixture(scope="module")
def stop_token(models, prefixes):
    """A token whose stop ends some returned beams early on every v3
    config (random weights rarely emit '.')."""
    toks = _port(models, prefixes, -1, **CONFIGS["v3_int8"])[0]
    vals, counts = np.unique(toks[:, :, 1:], return_counts=True)
    for tok in vals[np.argsort(-counts, kind="stable")]:
        if all((_port(models, prefixes, int(tok), **knobs)[1] < E).any()
               for knobs in CONFIGS.values()):
            return int(tok)
    raise AssertionError("no emitted token stops a returned beam")


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("stopping", [False, True])
def test_v3_beam_search_matches_jax(models, prefixes, stop_token, config,
                                    stopping):
    jcfg, params, _, _ = models
    stop = stop_token if stopping else -1
    knobs = CONFIGS[config]
    jax_knobs = dict(knobs, **PROD)
    if knobs.get("kv_cache_int8"):
        jax_knobs["fused_attention"] = True
    run = lambda **kw: jax.tree.map(np.asarray, jax_beam_search(
        params["gpt"], jcfg.gpt2, jnp.asarray(prefixes),
        JaxBeamConfig(beam_size=R, entry_length=E, stop_token=stop, **kw)))
    want = run(**jax_knobs)
    got = _port(models, prefixes, stop, **knobs)
    np.testing.assert_array_equal(got[0], want[0])   # tokens
    np.testing.assert_array_equal(got[1], want[1])   # lengths
    np.testing.assert_array_equal(got[3], want[3])   # order
    assert (got[1] < E).any() == stopping
    # The TPU kernels multiply in bf16 even for f32 inputs, which moves
    # the JAX scores by up to ~2e-4 from its own f32 XLA path on these
    # inputs; the port's f32 scores sit on the XLA path's.
    np.testing.assert_allclose(got[2], want[2], atol=1e-3, rtol=0)
    if not knobs.get("kv_cache_int8"):  # int8 has no XLA path in JAX
        xla = run(cache_stages=knobs["cache_stages"])
        np.testing.assert_array_equal(got[0], xla[0])
        np.testing.assert_allclose(got[2], xla[2], atol=1e-4, rtol=0)


def test_v3_knobs_resolve_as_jax_and_refuse_what_jax_refuses(models,
                                                             prefixes):
    v3 = beam.resolve_config(beam.BeamConfig(fused_slot_chunks=8))
    assert v3.fused_attention and v3.chunk_slot_write
    assert not v3.full_alloc and v3.bounded_fork_copy
    assert not v3.int8_prefix
    i8 = beam.resolve_config(beam.BeamConfig(kv_cache_int8=True,
                                             fused_slot_chunks=8))
    assert i8.int8_prefix and not i8.full_alloc and i8.bounded_fork_copy
    # an int8 prefix needs the chunked kernel, as in the JAX decode_step
    with pytest.raises(ValueError, match="fused_slot_chunks"):
        _port(models, prefixes, -1, kv_cache_int8=True, int8_prefix=True)
    # every stage bucket must be a whole number of chunks
    with pytest.raises(ValueError, match="multiples of fused_slot_chunks"):
        _port(models, prefixes, -1, fused_slot_chunks=16)

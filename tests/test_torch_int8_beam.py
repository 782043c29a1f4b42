"""The port's int8-KV beam search and staged cache growth against the JAX
package, in float32 on the CPU.

Port `beam_search` (kernel wrappers -> plain versions on CPU tensors)
against the JAX engine with its Pallas kernels in interpret mode:
  * int8: `BeamConfig(kv_cache_int8=True, fused_attention=True,
    pallas_reorder=True, fused_interpret=True)` (staged growth, whole-row
    fork copies, quantising slot write, int8 attention);
  * staged: the bf16/f32 production knobs with `full_alloc=False`.
Tokens, lengths and beam order must be identical, stopping on and off;
scores agree within 1e-4.
The port's staged growth and its full-size allocation are bit-identical
for both cache dtypes (as tests/test_decode.py holds for JAX).
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
N, K, R, E = 3, 5, 4, 20   # E=20: cache slots 24, stage buckets 8, 16, 24
PROD = dict(pallas_reorder=True, fused_interpret=True)
CONFIGS = {
    "int8": (dict(kv_cache_int8=True),
             dict(kv_cache_int8=True, fused_attention=True, **PROD)),
    "staged": (dict(full_alloc=False), dict(full_alloc=False, **PROD)),
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
    return np.random.RandomState(12).randn(N, K, 128).astype(np.float32)


def _port(models, prefixes, stop, **knobs):
    _, _, tcfg, model = models
    bc = beam.BeamConfig(beam_size=R, entry_length=E, stop_token=stop,
                         **knobs)
    return [t.numpy() for t in beam.beam_search(
        model.gpt, tcfg.gpt2, torch.from_numpy(prefixes), bc)]


@pytest.fixture(scope="module")
def stop_token(models, prefixes):
    """A token whose stop ends some returned int8 beams early (random
    weights rarely emit '.'): the most frequent emitted token that does."""
    knobs = CONFIGS["int8"][0]
    toks = _port(models, prefixes, -1, **knobs)[0]
    vals, counts = np.unique(toks[:, :, 1:], return_counts=True)
    for tok in vals[np.argsort(-counts, kind="stable")]:
        if (_port(models, prefixes, int(tok), **knobs)[1] < E).any():
            return int(tok)
    raise AssertionError("no emitted token stops a returned beam")


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("stopping", [False, True])
def test_beam_search_matches_jax(models, prefixes, stop_token, config,
                                 stopping):
    jcfg, params, _, _ = models
    stop = stop_token if stopping else -1
    port_knobs, jax_knobs = CONFIGS[config]
    want = jax.tree.map(np.asarray, jax_beam_search(
        params["gpt"], jcfg.gpt2, jnp.asarray(prefixes),
        JaxBeamConfig(beam_size=R, entry_length=E, stop_token=stop,
                      **jax_knobs)))
    got = _port(models, prefixes, stop, **port_knobs)
    np.testing.assert_array_equal(got[0], want[0])   # tokens
    np.testing.assert_array_equal(got[1], want[1])   # lengths
    np.testing.assert_allclose(got[2], want[2], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got[3], want[3])   # order
    if config == "int8":
        assert (got[1] < E).any() == stopping


@pytest.mark.parametrize("int8", [False, True])
def test_staged_growth_matches_full_alloc(models, prefixes, stop_token,
                                          int8):
    """Staged growth (stage-sized cache, grow_cache between stages, whole-
    row fork copies) and one full-size cache (stage-bounded reads, bounded
    fork copies) read the same slots: bit-identical results."""
    knobs = dict(kv_cache_int8=int8)
    staged = _port(models, prefixes, stop_token, full_alloc=False, **knobs)
    full = _port(models, prefixes, stop_token, full_alloc=True,
                 bounded_fork_copy=True, **knobs)
    for a, b in zip(staged, full):
        np.testing.assert_array_equal(a, b)

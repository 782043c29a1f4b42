"""The port's ancestry and temperature beam paths against the JAX package,
in float32 on the CPU.

Port `beam_search` (kernel wrappers -> plain versions on CPU tensors)
against the JAX engine with the same knobs:
  * `ancestry=True` in the row-major and the seq-major layout (the cache
    never moves; the attention reads each beam's slots through the
    ancestry table);
  * `temperature=0.7` (the logits route: unfused LM head, scaled logits).
The JAX kernel path runs its Pallas kernels (the LM head, the attention,
the chunked slot write) in interpret mode: tokens, lengths and beam
order must be identical, scores within 1e-3 (its kernels multiply in
bf16). Against the JAX XLA path with the same knobs: tokens identical,
scores within 1e-4. Stopping on and off.
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
SEQ = dict(rowmajor_cache=False)
INTERPRET = dict(pallas_reorder=True, fused_interpret=True)
# config -> (port knobs, JAX kernel-path knobs, JAX XLA-path knobs)
CONFIGS = {
    "ancestry_rowmajor": (dict(ancestry=True), dict(ancestry=True, **INTERPRET),
                          dict(ancestry=True)),
    "ancestry_seqmajor": (dict(SEQ, ancestry=True),
                          dict(SEQ, ancestry=True, **INTERPRET),
                          dict(SEQ, ancestry=True)),
    "temperature": (dict(temperature=0.7), dict(temperature=0.7, **INTERPRET),
                    dict(temperature=0.7)),
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
    toks = _port(models, prefixes, -1, ancestry=True)[0]
    vals, counts = np.unique(toks[:, :, 1:], return_counts=True)
    for tok in vals[np.argsort(-counts, kind="stable")]:
        if all((_port(models, prefixes, int(tok), **knobs)[1] < E).any()
               for knobs, _, _ in CONFIGS.values()):
            return int(tok)
    raise AssertionError("no emitted token stops a returned beam")


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("stopping", [False, True])
def test_ancestry_beam_search_matches_jax(models, prefixes, stop_token,
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


def test_ancestry_agrees_with_the_lane_path(models, prefixes, stop_token):
    """Reading the cache through the ancestry table (either layout) gives
    the lane path's result bit for bit."""
    lane = _port(models, prefixes, stop_token)
    for config, (knobs, _, _) in CONFIGS.items():
        if config == "temperature":
            continue
        got = _port(models, prefixes, stop_token, **knobs)
        for a, b in zip(got, lane):
            np.testing.assert_array_equal(a, b, config)


def test_temperature_scales_the_logits_with_jax_reciprocal(models,
                                                           prefixes):
    """JAX divides by the temperature inside jitted code, where XLA
    multiplies by the float32 reciprocal; the port does the same, so the
    scores match the XLA path to float32 rounding of the sums only."""
    assert beam._inv_temperature(0.7) == float(
        np.float32(1.0) / np.float32(0.7))
    assert beam._inv_temperature(1.0) is None
    assert beam._inv_temperature(0.0) is None
    hot = _port(models, prefixes, -1, temperature=2.0)
    want = _jax(models, prefixes, -1, temperature=2.0)
    np.testing.assert_array_equal(hot[0], want[0])
    np.testing.assert_allclose(hot[2], want[2], atol=1e-4, rtol=0)

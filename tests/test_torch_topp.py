"""The port's greedy/top-p decoding against the JAX package, in float32 on
the CPU.

Port `greedy_topp_search` (kernel wrappers -> plain versions on CPU
tensors) against JAX `greedy_topp_search` with the same knobs, its Pallas
kernels in interpret mode and its fused LM head on (the TPU default):
  * the default route (seq-major cache, plain attention, plain slot
    write), and with `chunk_slot_write` (K13's route);
  * the fused row-major routes: v2 (K2), v3 (K8), v3 over int8 caches
    with an int8 prefix (K9);
  * the seq-major int8 route (the JAX XLA path's int8 cache);
stopping on and off: tokens and lengths identical. Also: the default
route against the naive re-forward oracle on a HuggingFace GPT-2,
`nucleus_filter` against JAX's, sampling deterministic per generator
seed, and the JAX engine's refusals with its messages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from capdec_tpu.decode import ToppConfig as JaxToppConfig
from capdec_tpu.decode import greedy_topp_search as jax_greedy
from capdec_tpu.decode.topp import nucleus_filter as jax_nucleus_filter
from capdec_tpu.models import caption_model as jax_cm
from capdec_tpu.models import gpt2 as jax_gpt2
from capdec_tpu_torch.decode import topp
from capdec_tpu_torch.models import caption_model, gpt2
from test_decode import oracle_greedy

torch.set_num_threads(2)

TINY_GPT = dict(vocab_size=300, n_positions=64, n_embd=128, n_layer=2,
                n_head=2)
N, K, E = 4, 5, 20   # E=20: cache slots 24, stage buckets 8, 16, 24
JAX_TPU = dict(fused_lm_head=True, fused_interpret=True)
CONFIGS = {
    "default": {},
    "chunk_slot_write": dict(chunk_slot_write=True),
    "fused_v2": dict(fused_attention=True),
    "fused_v3": dict(fused_attention=True, fused_slot_chunks=8),
    "fused_v3_int8": dict(fused_attention=True, fused_slot_chunks=8,
                          kv_cache_int8=True),
    "xla_int8": dict(kv_cache_int8=True),
}


@pytest.fixture(scope="module")
def models():
    jcfg = jax_cm.CaptionModelConfig(
        prefix_length=K, clip_length=K, prefix_size=32, num_layers=2,
        gpt2=jax_gpt2.GPT2Config(**TINY_GPT))
    params = jax_cm.init_params(jax.random.PRNGKey(8), jcfg)
    tcfg = caption_model.CaptionModelConfig(
        prefix_length=K, clip_length=K, prefix_size=32, num_layers=2,
        gpt2=gpt2.GPT2Config(**TINY_GPT))
    model = caption_model.params_from_jax_numpy(
        jax.tree.map(np.asarray, params), tcfg)
    return jcfg, params, tcfg, model


@pytest.fixture(scope="module")
def prefixes():
    return np.random.RandomState(14).randn(N, K, 128).astype(np.float32)


def _port(models, prefixes, stop, **knobs):
    _, _, tcfg, model = models
    tc = topp.ToppConfig(entry_length=E, stop_token=stop,
                         extra_stop_token=-1, **knobs)
    return [t.numpy() for t in topp.greedy_topp_search(
        model.gpt, tcfg.gpt2, torch.from_numpy(prefixes), tc)]


@pytest.fixture(scope="module")
def stop_token(models, prefixes):
    """A token that ends some rows early on every route (random weights
    rarely emit '.'): the most frequent emitted token that does."""
    toks = _port(models, prefixes, -1)[0]
    vals, counts = np.unique(toks[:, 1:], return_counts=True)
    for tok in vals[np.argsort(-counts, kind="stable")]:
        if all((_port(models, prefixes, int(tok), **knobs)[1] < E).any()
               for knobs in CONFIGS.values()):
            return int(tok)
    raise AssertionError("no emitted token stops a row")


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("stopping", [False, True])
def test_greedy_matches_jax(models, prefixes, stop_token, config, stopping):
    jcfg, params, _, _ = models
    stop = stop_token if stopping else -1
    knobs = CONFIGS[config]
    want = jax.tree.map(np.asarray, jax_greedy(
        params["gpt"], jcfg.gpt2, jnp.asarray(prefixes),
        JaxToppConfig(entry_length=E, stop_token=stop, extra_stop_token=-1,
                      **knobs, **JAX_TPU)))
    got = _port(models, prefixes, stop, **knobs)
    np.testing.assert_array_equal(got[0], want[0])   # tokens
    np.testing.assert_array_equal(got[1], want[1])   # lengths
    assert (got[1] < E).any() == stopping
    if stopping:  # the stop token stays in the output, then zeros
        for n in np.flatnonzero(got[1] < E):
            assert got[0][n, got[1][n] - 1] == stop
            assert not got[0][n, got[1][n]:].any()


def test_greedy_matches_the_reforward_oracle():
    """The default route against a naive re-forward of a HuggingFace
    GPT-2 (tests/test_decode.py's oracle), stops 13 and 764."""
    small = dict(vocab_size=97, n_positions=96, n_embd=48, n_layer=3,
                 n_head=4)
    torch.manual_seed(0)
    tm = transformers.GPT2LMHeadModel(transformers.GPT2Config(
        attn_pdrop=0.0, embd_pdrop=0.0, resid_pdrop=0.0, **small)).eval()
    cfg = gpt2.GPT2Config(**small)
    model = gpt2.params_from_torch_state_dict(tm.state_dict(), cfg)
    x = np.random.RandomState(7).randn(4, 5, 48).astype(np.float32) * 0.05
    toks, lens = topp.greedy_topp_search(
        model, cfg, torch.from_numpy(x),
        topp.ToppConfig(entry_length=10, stop_token=13,
                        extra_stop_token=764))
    for n in range(4):
        ref = oracle_greedy(tm, torch.tensor(x[n:n + 1]), 10, {13, 764})
        assert toks[n, :lens[n]].tolist() == ref, f"image {n}"


def test_nucleus_filter_matches_jax():
    logits = np.random.RandomState(1).randn(6, 40).astype(np.float32) * 2
    for top_p in (0.5, 0.8, 0.95):
        want = np.asarray(jax_nucleus_filter(jnp.asarray(logits), top_p))
        got = topp.nucleus_filter(torch.from_numpy(logits), top_p).numpy()
        np.testing.assert_array_equal(got, want)
        assert np.isinf(got).any()


def test_sampling_is_deterministic_per_generator_seed(models, prefixes):
    _, _, tcfg, model = models
    tc = topp.ToppConfig(entry_length=8, top_p=0.9, stop_token=-1,
                         extra_stop_token=-1, sample=True)
    x = torch.from_numpy(prefixes)

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return topp.greedy_topp_search(model.gpt, tcfg.gpt2, x, tc, g)[0]

    assert torch.equal(draw(0), draw(0))
    assert not torch.equal(draw(0), draw(1))
    assert not topp.resolve_config(tc).fused_lm_head  # needs the logits


def test_config_resolution_and_refusals(models, prefixes):
    tc = topp.resolve_config(topp.ToppConfig())
    assert not tc.fused_attention and not tc.chunk_slot_write
    assert tc.fused_lm_head and not tc.int8_prefix
    fused = topp.resolve_config(topp.ToppConfig(
        fused_attention=True, fused_slot_chunks=8, kv_cache_int8=True))
    assert fused.chunk_slot_write and fused.int8_prefix
    assert not topp.resolve_config(
        topp.ToppConfig(temperature=0.7)).fused_lm_head
    # the JAX engine's refusals, with its messages
    for knobs, match in (
            (dict(kv_cache_int8=True, fused_attention=True,
                  fused_slot_chunks=0), "fused_slot_chunks"),
            (dict(kv_cache_int8=True, fused_attention=False,
                  chunk_slot_write=True), "chunk_slot_write"),
            (dict(fused_lm_head=True, sample=True), "fused_lm_head")):
        with pytest.raises(ValueError, match=match):
            _port(models, prefixes, -1, **knobs)

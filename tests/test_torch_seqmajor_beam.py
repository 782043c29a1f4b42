"""The port's seq-major beam paths against the JAX package, in float32 on
the CPU.

Port `beam_search` (kernel wrappers -> plain versions on CPU tensors)
against the JAX engine with the same knobs:
  `rowmajor_cache=False` with lanes (staged growth of the seq-major
  cache, K11's gather of the lanes' sources each step) and without (K11's
  gather after each selection).
The JAX kernel path runs its LM head kernel in interpret mode and its
seq-major gathers through XLA (`_reorder_gen_cache` calls K11 without
`interpret`): tokens, lengths and beam order must be identical, scores
within 1e-3 (its kernels multiply in bf16). Against the JAX XLA path with
the same layout knobs: tokens identical, scores within 1e-4. Stopping on
and off. Also: `staging.grow_cache` grows a seq-major cache as the JAX
version does, and the server captions as JAX's on the seq-major path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capdec_tpu import serve as jax_serve
from capdec_tpu.decode import BeamConfig as JaxBeamConfig
from capdec_tpu.decode import beam_search as jax_beam_search
from capdec_tpu.decode import staging as jax_staging
from capdec_tpu.models import caption_model as jax_cm
from capdec_tpu.models import gpt2 as jax_gpt2
from capdec_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer
from capdec_tpu_torch import serve
from capdec_tpu_torch.decode import beam, staging
from capdec_tpu_torch.models import caption_model, gpt2
from capdec_tpu_torch.utils.tokenizer import ByteTokenizer

torch.set_num_threads(2)

TINY_GPT = dict(vocab_size=300, n_positions=64, n_embd=128, n_layer=2,
                n_head=2)
N, K, R, E = 3, 5, 4, 20   # E=20: cache slots 24
SEQ = dict(rowmajor_cache=False)
# config -> (port knobs, JAX kernel-path knobs, JAX XLA-path knobs)
CONFIGS = {
    "seqmajor_lanes": (SEQ, dict(SEQ, pallas_reorder=False, fused_lm_head=True,
                                 fused_interpret=True), SEQ),
    "seqmajor_nonlane": (dict(SEQ, lane_beams=False),
                         dict(SEQ, lane_beams=False, pallas_reorder=False,
                              fused_lm_head=True, fused_interpret=True),
                         dict(SEQ, lane_beams=False)),
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
    toks = _port(models, prefixes, -1, **SEQ)[0]
    vals, counts = np.unique(toks[:, :, 1:], return_counts=True)
    for tok in vals[np.argsort(-counts, kind="stable")]:
        if all((_port(models, prefixes, int(tok), **knobs)[1] < E).any()
               for knobs, _, _ in CONFIGS.values()):
            return int(tok)
    raise AssertionError("no emitted token stops a returned beam")


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("stopping", [False, True])
def test_seqmajor_beam_search_matches_jax(models, prefixes, stop_token,
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


def test_seqmajor_layouts_agree_with_the_lane_path(models, prefixes,
                                                   stop_token):
    """Moving the seq-major cache gives the row-major lane path's result
    bit for bit."""
    lane = _port(models, prefixes, stop_token)
    for config, (knobs, _, _) in CONFIGS.items():
        got = _port(models, prefixes, stop_token, **knobs)
        for a, b in zip(got, lane):
            np.testing.assert_array_equal(a, b, config)


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_grow_cache_grows_a_seqmajor_cache_as_jax(dtype):
    rng = np.random.RandomState(4)
    L, B, E0, E1, D = 2, 6, 8, 16, 32
    old = {n: (rng.randn(L, B, E0, D) * 50).astype(dtype) for n in "kv"}
    big = {n: np.zeros((L, B, E1, D), dtype) for n in "kv"}
    want = jax_staging.grow_cache(
        {n: jnp.asarray(a) for n, a in old.items()},
        {n: jnp.asarray(a) for n, a in big.items()}, jnp.asarray(False))
    got = staging.grow_cache(
        {n: torch.from_numpy(a) for n, a in old.items()},
        {n: torch.from_numpy(a.copy()) for n, a in big.items()})
    for n in "kv":
        assert got[n].shape == (L, B, E1, D)
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
    # the seq-major beam cache of a staged run keeps its layout
    cfg = gpt2.GPT2Config(**TINY_GPT)
    small = gpt2.init_gen_cache(cfg, B, E0)
    small["k"].normal_()
    grown = staging.grow_cache(small, gpt2.init_gen_cache(cfg, B, E1))
    assert grown["k"].shape == (TINY_GPT["n_layer"], B, E1, 128)
    assert torch.equal(grown["k"][:, :, :E0], small["k"])
    assert not grown["k"][:, :, E0:].any()


def test_caption_server_matches_jax_on_the_seqmajor_path(models, stop_token):
    jcfg, params, tcfg, model = models
    knobs = dict(beam_size=R, entry_length=E, stop_token=stop_token, **SEQ)
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

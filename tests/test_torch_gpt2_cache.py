"""GPT-2's single-cache API of the port (`init_kv_cache`,
`reorder_kv_cache`, `forward_with_cache` in
capdec_tpu_torch/models/gpt2.py) against the JAX package's, on the CPU.

Weights are made by the JAX package from a seed and carried across with
`params_from_jax_numpy`; inputs are numpy arrays from seeds fed to both.
The JAX functions are XLA (no Pallas kernel), so both sides run their
plain math. Tolerances, with their reasons:
  * f32 logits and caches against JAX: 1e-4 absolute (the same products
    and f32 softmax, summed in another order);
  * the port's incremental decode against its own full forward: 1e-4
    (the counterpart of tests/test_gpt2_parity.py:80);
  * bf16 against JAX's bf16: 2e-2 absolute, the tolerance of the port's
    other bf16 decode checks (tests/test_torch_ops.py,
    tests/test_torch_int8.py): PyTorch rounds each bf16 product's output
    to bf16 where JAX keeps it in f32;
  * `reorder_kv_cache` bit for bit (a gather).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capdec_tpu.models import gpt2 as jax_gpt2
from capdec_tpu_torch.models import gpt2

torch.set_num_threads(2)

SMALL = dict(vocab_size=97, n_positions=64, n_embd=48, n_layer=3, n_head=4)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-4, "bf16": 2e-2}


def models(name, **kw):
    jdt, tdt = DTYPES[name]
    shape = dict(SMALL, **kw)
    jcfg = jax_gpt2.GPT2Config(**shape, compute_dtype=jdt)
    params = jax_gpt2.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = gpt2.GPT2Config(**shape, compute_dtype=tdt)
    model = gpt2.params_from_jax_numpy(jax.tree.map(np.asarray, params), cfg)
    return jcfg, params, cfg, model


@pytest.fixture(scope="module", params=sorted(DTYPES))
def pair(request):
    return (request.param, *models(request.param))


def as_np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def assert_close(got, want, tol, what=""):
    np.testing.assert_allclose(as_np(got), as_np(want), atol=tol, rtol=0,
                               err_msg=what)


def both(pair, embeds, jcache, cache, index, key_mask=None):
    """One forward_with_cache call on each side: ((jax logits, cache),
    (port logits, cache))."""
    _, jcfg, params, cfg, model = pair
    jmask = None if key_mask is None else jnp.asarray(key_mask)
    tmask = None if key_mask is None else torch.from_numpy(key_mask)
    want = jax_gpt2.forward_with_cache(params, jcfg, jnp.asarray(embeds),
                                       jcache, jnp.asarray(index),
                                       key_mask=jmask)
    with torch.no_grad():
        got = gpt2.forward_with_cache(model, cfg, torch.from_numpy(embeds),
                                      cache, index, key_mask=tmask)
    return want, got


def assert_step(want, got, name, what):
    """Logits f32 and the cache in the compute dtype, both within TOL."""
    assert got[0].dtype == torch.float32
    assert_close(got[0], want[0], TOL[name], f"{what} logits")
    for k in ("k", "v"):
        assert got[1][k].dtype == DTYPES[name][1]
        assert_close(got[1][k], want[1][k], TOL[name], f"{what} {k}")


def test_init_kv_cache_is_the_jax_cache(pair):
    name, jcfg, _, cfg, _ = pair
    want = jax_gpt2.init_kv_cache(jcfg, 3, 10)
    got = gpt2.init_kv_cache(cfg, 3, 10)
    for k in ("k", "v"):
        assert tuple(got[k].shape) == want[k].shape == (3, 3, 4, 10, 12)
        assert got[k].dtype == DTYPES[name][1]
        assert not got[k].any()
    assert gpt2.init_kv_cache(cfg, 1, 4, dtype=torch.float32)["k"].dtype \
        == torch.float32


def test_prefill_then_decode_matches_jax(pair):
    """Prefill 6 positions at index 0, then 5 decode steps: every step's
    logits and cache against JAX's."""
    name, jcfg, params, cfg, model = pair
    rng = np.random.RandomState(3)
    B, P, T = 2, 6, 5
    prefix = rng.randn(B, P, SMALL["n_embd"]).astype(np.float32) * 0.02
    tokens = rng.randint(0, SMALL["vocab_size"], size=(B, T))
    jcache = jax_gpt2.init_kv_cache(jcfg, B, P + T)
    cache = gpt2.init_kv_cache(cfg, B, P + T)
    want, got = both(pair, prefix, jcache, cache, 0)
    assert tuple(got[0].shape) == (B, P, SMALL["vocab_size"])
    assert_step(want, got, name, "prefill")
    for t in range(T):
        embeds = np.asarray(jax_gpt2.embed_tokens(
            params, jnp.asarray(tokens[:, t:t + 1]))).astype(np.float32)
        want, got = both(pair, embeds, want[1], got[1], P + t)
        assert_step(want, got, name, f"step {t}")


def test_incremental_decode_equals_the_full_forward():
    """The port's form of tests/test_gpt2_parity.py:80: prefill + cached
    decode give the full forward's logits, f32, within 1e-4; the given
    cache is left as it was."""
    _, _, cfg, model = models("f32")
    rng = np.random.RandomState(3)
    B, P, T = 2, 6, 5
    prefix = torch.from_numpy(
        rng.randn(B, P, SMALL["n_embd"]).astype(np.float32) * 0.02)
    tokens = torch.from_numpy(rng.randint(0, SMALL["vocab_size"], (B, T)))
    with torch.no_grad():
        full = gpt2.forward(model, cfg, torch.cat(
            [prefix, gpt2.embed_tokens(model, tokens)], dim=1))
        cache = gpt2.init_kv_cache(cfg, B, P + T)
        logits, new = gpt2.forward_with_cache(model, cfg, prefix, cache,
                                              torch.tensor(0))
        assert not cache["k"].any() and new["k"][:, :, :, :P].any()
        assert_close(logits, full[:, :P], 1e-4, "prefill")
        for t in range(T):
            step = gpt2.embed_tokens(model, tokens[:, t:t + 1])
            logits, new = gpt2.forward_with_cache(model, cfg, step, new,
                                                  torch.tensor(P + t))
            assert_close(logits[:, 0], full[:, P + t], 1e-4, f"step {t}")


EDGE = dict(vocab_size=40, n_positions=32, n_embd=16, n_layer=1, n_head=2)


def test_key_mask_matches_jax():
    """tests/test_edge_cases.py:32's case on both packages, and a second
    row whose every slot is masked: JAX's finite -1e9 gives that row a
    uniform softmax over its visible slots, and the port the same."""
    jcfg = jax_gpt2.GPT2Config(**EDGE)
    params = jax_gpt2.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = gpt2.GPT2Config(**EDGE)
    model = gpt2.params_from_jax_numpy(jax.tree.map(np.asarray, params), cfg)
    pair = ("f32", jcfg, params, cfg, model)
    x = np.random.RandomState(0).randn(2, 4, 16).astype(np.float32) * 0.1
    key_mask = np.ones((2, 8), np.float32)
    key_mask[0, 1] = 0          # mask out slot 1 of row 0
    key_mask[1] = 0             # every slot of row 1
    jc, tc = jax_gpt2.init_kv_cache(jcfg, 2, 8), gpt2.init_kv_cache(cfg, 2, 8)
    masked = both(pair, x, jc, tc, 0, key_mask)
    plain = both(pair, x, jc, tc, 0)
    for want, got in (masked, plain):
        assert torch.isfinite(got[0]).all()
        assert_close(got[0], want[0], 1e-5)
    got_m, got = masked[1][0].numpy(), plain[1][0].numpy()
    # masking a visible key changes downstream logits; position 0 sees
    # only itself either way
    assert not np.allclose(got_m[0, 2:], got[0, 2:])
    np.testing.assert_allclose(got_m[0, 0], got[0, 0], atol=1e-5)
    # a bool mask is the same mask
    with torch.no_grad():
        as_bool = gpt2.forward_with_cache(
            model, cfg, torch.from_numpy(x), tc, 0,
            key_mask=torch.from_numpy(key_mask > 0))[0]
    np.testing.assert_array_equal(as_bool.numpy(), got_m)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_reorder_kv_cache_is_the_jax_gather(dtype):
    jdt, tdt = DTYPES[dtype]
    cache = np.random.RandomState(5).randn(2, 4, 3, 6, 8).astype(np.float32)
    src = np.asarray([3, 3, 0, 1])
    want = jax_gpt2.reorder_kv_cache(
        {"k": jnp.asarray(cache, jdt), "v": jnp.asarray(-cache, jdt)},
        jnp.asarray(src))
    given = {"k": torch.tensor(cache, dtype=tdt),
             "v": torch.tensor(-cache, dtype=tdt)}
    got = gpt2.reorder_kv_cache(given, torch.from_numpy(src))
    for name in ("k", "v"):
        assert got[name].dtype == tdt
        np.testing.assert_array_equal(as_np(got[name]), as_np(want[name]))
        np.testing.assert_array_equal(as_np(got[name]),
                                      as_np(given[name])[:, src])


@pytest.mark.parametrize("index", [9, 10, 12, 15, 40])
def test_writes_past_the_cache_clamp_as_jax_does(pair, index):
    """T = 3 new positions on a 12-slot cache filled by a prefill of 6:
    at index S_max - T = 9 the write ends at the last slot; past it
    `lax.dynamic_update_slice` moves the write back to start at 9 while
    the causal mask keeps the given index (so the slots between 6 and the
    write, zeros, are visible too). Logits and caches against JAX's."""
    name = pair[0]
    _, jcfg, _, cfg, _ = pair
    rng = np.random.RandomState(index)
    B, P, T, S = 2, 6, 3, 12
    jc, tc = jax_gpt2.init_kv_cache(jcfg, B, S), gpt2.init_kv_cache(cfg, B, S)
    want, got = both(pair, rng.randn(B, P, 48).astype(np.float32) * 0.02,
                     jc, tc, 0)
    want, got = both(pair, rng.randn(B, T, 48).astype(np.float32) * 0.02,
                     want[1], got[1], index)
    assert_step(want, got, name, f"index {index}")
    start = min(index, S - T)
    written = set(np.flatnonzero(as_np(got[1]["k"])[0, 0, 0, :, 0]))
    assert written == set(range(P)) | set(range(start, start + T))


def test_refusals_where_jax_wraps_or_fills_nan():
    """Inputs where the JAX function gives no defined answer are refused:
    more positions than slots (JAX raises too), a negative index (JAX
    wraps it from the end), and positions past n_positions, where JAX's
    `jnp.take` on wpe fills NaN."""
    jcfg, params, cfg, model = models("f32")
    x = np.zeros((1, 3, 48), np.float32)
    past = jax_gpt2.forward_with_cache(
        params, jcfg, jnp.asarray(x), jax_gpt2.init_kv_cache(jcfg, 1, 8),
        jnp.asarray(62))[0]
    assert np.isnan(np.asarray(past)).all()
    with pytest.raises(TypeError):
        jax_gpt2.forward_with_cache(params, jcfg, jnp.asarray(x),
                                    jax_gpt2.init_kv_cache(jcfg, 1, 2),
                                    jnp.asarray(0))
    cases = ((gpt2.init_kv_cache(cfg, 1, 2), 0, "do not fit"),
             (gpt2.init_kv_cache(cfg, 1, 8), -1, "outside"),
             (gpt2.init_kv_cache(cfg, 1, 8), 62, "outside"),
             (gpt2.init_kv_cache(cfg, 1, 8), torch.tensor(62), "outside"))
    for cache, index, match in cases:
        with pytest.raises(ValueError, match=match):
            gpt2.forward_with_cache(model, cfg, torch.from_numpy(x), cache,
                                    index)
    # the last position that fits is served
    logits, _ = gpt2.forward_with_cache(model, cfg, torch.from_numpy(x),
                                        gpt2.init_kv_cache(cfg, 1, 8), 61)
    assert torch.isfinite(logits).all()

"""The port's int8-KV ops, staged cache growth and int8 decode step against
the JAX package, on the CPU.

On the CPU every wrapper runs its plain PyTorch version; these tests hold
those plain versions against the JAX Pallas kernels run in interpret mode,
on the same inputs made from a numpy seed. (The CUDA kernels are held
against the same plain versions on the card: tests/test_torch_cuda.py
and chip_smoke.py.)

Tolerances:
  * absmax_int8_quant, K5 (write_gen_slot_chunk_q), K7 (copy_forked_rows)
    and grow_cache: bit-exact.
  * K6 (int8 decode attention): 2e-2, because the TPU kernel multiplies
    in bf16 even for f32 inputs (decode_attention.py:271-275).
  * One int8 decode step: the hidden state within 2e-2 (K6 as above); the
    written scales within 1e-3 relative and the dequantised values within
    1e-2: the K/V of layer 1 follow layer 0's attention (bf16 products in
    the JAX kernel), and torch and XLA sum the QKV product in another
    order, so the quantised K/V differ by ulps and, rarely, by one level.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capdec_tpu.decode import staging as jax_staging
from capdec_tpu.models import gpt2 as jax_gpt2
from capdec_tpu.ops import cache_reorder as jax_cr
from capdec_tpu.ops import decode_attention as jax_da
from capdec_tpu_torch.decode import staging
from capdec_tpu_torch.models import gpt2
from capdec_tpu_torch.ops import cache_reorder, decode_attention

torch.set_num_threads(2)

TINY = dict(vocab_size=300, n_positions=64, n_embd=128, n_layer=2, n_head=2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}



def _quant_rows(rng):
    """Random rows, a zero row, and rows whose x / scale falls exactly on
    .5 level boundaries (scale 1 and 0.5), where rounding half to even
    and half away from zero differ."""
    x = rng.randn(6, 128).astype(np.float32)
    x[1] = 0.0
    halves = np.arange(-63, 64) + 0.5                 # x / 1 = k + 0.5
    x[2, :127], x[2, 127] = halves, 127.0
    x[3, :127], x[3, 127] = halves / 2, -63.5         # x / 0.5 = k + 0.5
    x[4, :] = 1e-30                                   # tiny nonzero amax
    x[5, ::2] *= 1e3
    return x


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_absmax_int8_quant_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    x = _quant_rows(np.random.RandomState(0))
    # jitted, as every JAX int8 path runs it (XLA turns the division by
    # 127 into a multiply by its reciprocal there; eager JAX divides)
    want_q, want_s = jax.jit(jax_cr.absmax_int8_quant)(jnp.asarray(x, jdt))
    got_q, got_s = cache_reorder.absmax_int8_quant(torch.tensor(x, dtype=tdt))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_s[1, 0] == 1.0 and not got_q[1].any()
    # half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -0.5 -> 0
    assert got_q[2, 63:67].tolist() == [0, 2, 2, 4]
    assert got_q[2, 62] == 0 and got_q[2, 61] == -2


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("step", [0, 11])
def test_write_gen_slot_q_plain_matches_jax_kernel(dtype, step):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(step)
    B, L, E, D = 6, 2, 16, 128
    k = rng.randint(-127, 128, (B, L, E, D)).astype(np.int8)
    v = rng.randint(-127, 128, (B, L, E, D)).astype(np.int8)
    ks = rng.rand(B, L, 1, E).astype(np.float32)
    vs = rng.rand(B, L, 1, E).astype(np.float32)
    nk = rng.randn(B, L, D).astype(np.float32)
    nv = rng.randn(B, L, D).astype(np.float32)
    nk[0, 1] = 0.0                                    # a zero row
    nv[2, 0, :127] = np.arange(-63, 64) + 0.5         # .5 boundaries
    nv[2, 0, 127] = 127.0
    want = jax.tree.map(np.asarray, jax_cr.write_gen_slot_chunk_q(
        *(jnp.asarray(a) for a in (k, v, ks, vs)),
        jnp.asarray(nk, jdt), jnp.asarray(nv, jdt), jnp.int32(step),
        interpret=True))
    t = {n: torch.from_numpy(a.copy()) for n, a in
         (("k", k), ("v", v), ("ks", ks), ("vs", vs))}
    got = cache_reorder.write_gen_slot_chunk_q(
        t["k"], t["v"], t["ks"], t["vs"], torch.tensor(nk, dtype=tdt),
        torch.tensor(nv, dtype=tdt), step)
    for name in ("k", "v", "ks", "vs"):
        assert got[name] is t[name]  # in place
        np.testing.assert_array_equal(got[name].numpy(), want[name])


def _attn_q_inputs(seed, step, N=3, R=4, L=2, K=5, E=24, D=128):
    """Random int8 levels with scales ~ amax / 127 of unit-normal values;
    the scales past `step` are NaN (a stale slot's scale is never read)."""
    rng = np.random.RandomState(seed)
    B = N * R
    f = lambda *s: rng.randn(*s).astype(np.float32)
    lev = lambda: rng.randint(-127, 128, (B, L, E, D)).astype(np.int8)
    sc = lambda: (rng.rand(B, L, 1, E) * 3 / 127).astype(np.float32)
    x = dict(q=f(B, D), k_new=f(B, D), v_new=f(B, D), pk=f(L, N, K, D),
             pv=f(L, N, K, D), gk=lev(), gv=lev(), gks=sc(), gvs=sc())
    x["gks"][..., step:] = np.nan
    x["gvs"][..., step:] = np.nan
    return x


ATTN_ARGS = ("q", "k_new", "v_new", "pk", "pv", "gk", "gv", "gks", "gvs")


@pytest.mark.parametrize("step,e_cap", [(0, None), (7, 16), (13, None),
                                        (23, None)])
def test_decode_attention_q_plain_matches_jax_kernel(step, e_cap):
    R, layer = 4, 1
    x = _attn_q_inputs(step, step)
    want = np.asarray(jax_da.beam_decode_attention_rowmajor_q(
        *(jnp.asarray(x[k]) for k in ATTN_ARGS), jnp.int32(step),
        jnp.int32(layer), beams_per_image=R, head_dim=64, interpret=True,
        e_cap=e_cap))
    got = decode_attention.beam_decode_attention_rowmajor_q(
        *(torch.from_numpy(x[k]) for k in ATTN_ARGS), step, layer,
        beams_per_image=R, head_dim=64, e_cap=e_cap)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-2)


def _lane_src(rng, N, R):
    """A fork pattern obeying the lane invariant: sources are lanes that
    keep their beam; every other lane takes one of them."""
    src = []
    for n in range(N):
        keep = rng.rand(R) < 0.5
        keep[rng.randint(R)] = True
        alive = np.flatnonzero(keep)
        src += [n * R + (r if keep[r] else rng.choice(alive))
                for r in range(R)]
    return np.asarray(src, np.int64)


@pytest.mark.parametrize("dtype", [np.int8, np.float32])
def test_copy_forked_rows_plain_matches_jax_kernel(dtype):
    rng = np.random.RandomState(4)
    N, R, L, E, D = 3, 4, 2, 16, 128
    B = N * R
    k = (rng.randn(B, L, E, D) * 50).astype(dtype)
    v = (rng.randn(B, L, E, D) * 50).astype(dtype)
    src = _lane_src(rng, N, R)
    assert (src != np.arange(B)).any()
    want = jax.tree.map(np.asarray, jax_cr.copy_forked_rows(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(src, jnp.int32),
        interpret=True))
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    got = cache_reorder.copy_forked_rows(tk, tv, torch.from_numpy(src))
    assert got["k"] is tk and got["v"] is tv  # in place
    for name in ("k", "v"):
        np.testing.assert_array_equal(got[name].numpy(), want[name])


@pytest.mark.parametrize("int8", [False, True])
def test_grow_cache_matches_jax(int8):
    jcfg, tcfg = jax_gpt2.GPT2Config(**TINY), gpt2.GPT2Config(**TINY)
    B, E0, E1 = 6, 8, 16
    rng = np.random.RandomState(5)
    if int8:
        jinit, tinit = (jax_gpt2.init_gen_cache_rowmajor_int8,
                        gpt2.init_gen_cache_rowmajor_int8)
    else:
        jinit, tinit = (jax_gpt2.init_gen_cache_rowmajor,
                        gpt2.init_gen_cache_rowmajor)
    small = {n: rng.randn(*a.shape).astype(np.float32) * 100
             for n, a in tinit(tcfg, B, E0).items()}
    small = {n: a.astype(np.asarray(jinit(jcfg, B, E0)[n]).dtype)
             for n, a in small.items()}
    want = jax.tree.map(np.asarray, jax_staging.grow_cache(
        {n: jnp.asarray(a) for n, a in small.items()}, jinit(jcfg, B, E1),
        jnp.bool_(False)))
    got = staging.grow_cache({n: torch.from_numpy(a.copy())
                              for n, a in small.items()},
                             tinit(tcfg, B, E1))
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == torch.from_numpy(want[name]).dtype
        np.testing.assert_array_equal(got[name].numpy(), want[name])
    with pytest.raises(ValueError):
        staging.grow_cache(tinit(tcfg, B, E1), tinit(tcfg, B, E0))


def test_int8_decode_step_matches_jax():
    """One decode step over an int8 generated cache (K6 and K5 plain
    versions) against the JAX int8 decode_step with its Pallas kernels in
    interpret mode. Slots >= step hold stale levels and NaN scales."""
    jcfg, tcfg = jax_gpt2.GPT2Config(**TINY), gpt2.GPT2Config(**TINY)
    params = jax_gpt2.init_params(jax.random.PRNGKey(0), jcfg)
    model = gpt2.params_from_jax_numpy(jax.tree.map(np.asarray, params),
                                       tcfg)
    N, R, K, E, step = 3, 4, 5, 16, 6
    B, L = N * R, TINY["n_layer"]
    rng = np.random.RandomState(9)
    x = rng.randn(N, K, TINY["n_embd"]).astype(np.float32)
    tok = rng.randn(B, TINY["n_embd"]).astype(np.float32)
    cache = {n: rng.randint(-127, 128, (B, L, E, TINY["n_embd"])).astype(
        np.int8) for n in ("k", "v")}
    for n in ("ks", "vs"):
        cache[n] = (rng.rand(B, L, 1, E) * 0.02).astype(np.float32)
        cache[n][..., step:] = np.nan
    _, pcache = jax_gpt2.prefill(params, jcfg, jnp.asarray(x))
    hid, upd = jax_gpt2.decode_step(
        params, jcfg, jnp.asarray(tok), pcache,
        {n: jnp.asarray(a) for n, a in cache.items()}, jnp.int32(step),
        rowmajor=True, fused_attention=True, fused_interpret=True,
        return_hidden=True)
    upd = jax.tree.map(np.asarray, upd)
    _, tpc = gpt2.prefill(model, tcfg, torch.from_numpy(x))
    tcache = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    thid = gpt2.decode_step(model, tcfg, torch.from_numpy(tok), tpc, tcache,
                            step, e_cap=E)
    np.testing.assert_allclose(thid.numpy(), np.asarray(hid), atol=2e-2,
                               rtol=0)
    for lv, sc in (("k", "ks"), ("v", "vs")):
        got_l, got_s = tcache[lv].numpy(), tcache[sc].numpy()
        np.testing.assert_allclose(got_s[..., step], upd[sc][..., step],
                                   rtol=1e-3, atol=0)
        np.testing.assert_allclose(
            got_l[:, :, step] * got_s[:, :, 0, step, None],
            upd[lv][:, :, step] * upd[sc][:, :, 0, step, None],
            atol=1e-2, rtol=0)
        # the other slots keep their bits
        np.testing.assert_array_equal(np.delete(got_l, step, axis=2),
                                      np.delete(cache[lv], step, axis=2))

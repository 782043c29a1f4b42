"""The port's slot-bounded attention (K8, K9), int8 prefix quantisation and
seq-major slot write (K13) against the JAX package, on the CPU.

On the CPU every wrapper runs its plain PyTorch version; these tests hold
those against the JAX Pallas kernels in interpret mode on the same inputs
made from a numpy seed. (The CUDA kernels are held against the same plain
versions on the card: tests/test_torch_cuda.py and chip_smoke.py.)

Tolerances:
  * K8 / K9: 2e-2, because the TPU kernels multiply in bf16 even for f32
    inputs (decode_attention.py:370-371, 406-407).
  * quantize_prefix_cache and K13: bit-exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capdec_tpu.models import gpt2 as jax_gpt2
from capdec_tpu.ops import cache_reorder as jax_cr
from capdec_tpu.ops import decode_attention as jax_da
from capdec_tpu_torch.models import gpt2
from capdec_tpu_torch.ops import cache_reorder, decode_attention

torch.set_num_threads(2)

N, L, K, E, D, HD = 3, 2, 5, 24, 128, 64
STEPS = [0, 7, 8, 13, 23]  # chunk edges at 8 and 16


def _inputs(seed, R, step, int8=False, int8_prefix=False):
    """Attention inputs; the generated slots at or above `step` hold NaN
    (fp) or, for an int8 cache, scales of 1e30 (the TPU kernel picks a
    chunk's scales with a one-hot matmul, where a NaN anywhere in the row
    would reach every slot; 1e30 still poisons any read)."""
    rng = np.random.RandomState(seed)
    B = N * R
    f = lambda *s: rng.randn(*s).astype(np.float32)
    lev = lambda *s: rng.randint(-127, 128, s).astype(np.int8)
    sc = lambda *s: (rng.rand(*s) * 3 / 127).astype(np.float32)
    x = dict(q=f(B, D), k_new=f(B, D), v_new=f(B, D), pk=f(L, N, K, D),
             pv=f(L, N, K, D))
    if int8_prefix:
        x.update(pk=lev(L, N, K, D), pv=lev(L, N, K, D),
                 pks=sc(L, N, 1, K), pvs=sc(L, N, 1, K))
    if int8:
        x.update(gk=lev(B, L, E, D), gv=lev(B, L, E, D), gks=sc(B, L, 1, E),
                 gvs=sc(B, L, 1, E))
        x["gks"][..., step:] = 1e30
        x["gvs"][..., step:] = 1e30
    else:
        x.update(gk=f(B, L, E, D), gv=f(B, L, E, D))
        x["gk"][:, :, step:] = np.nan
        x["gv"][:, :, step:] = np.nan
    return x


FP = ("q", "k_new", "v_new", "pk", "pv", "gk", "gv")
Q8 = FP + ("gks", "gvs")


@pytest.mark.parametrize("R", [1, 4])
@pytest.mark.parametrize("step", STEPS)
def test_chunked_attention_plain_matches_jax_kernel(R, step):
    x = _inputs(step, R, step)
    layer = 1
    want = np.asarray(jax_da.beam_decode_attention_chunked(
        *(jnp.asarray(x[k]) for k in FP), jnp.int32(step), jnp.int32(layer),
        beams_per_image=R, head_dim=HD, chunk=8, interpret=True))
    got = decode_attention.beam_decode_attention_chunked(
        *(torch.from_numpy(x[k]) for k in FP), step, layer,
        beams_per_image=R, head_dim=HD, chunk=8)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-2)


@pytest.mark.parametrize("int8_prefix", [False, True])
@pytest.mark.parametrize("R", [1, 4])
@pytest.mark.parametrize("step", STEPS)
def test_chunked_int8_attention_plain_matches_jax_kernel(int8_prefix, R,
                                                        step):
    x = _inputs(100 + step, R, step, int8=True, int8_prefix=int8_prefix)
    layer = 0
    pre = ("pks", "pvs") if int8_prefix else ()
    want = np.asarray(jax_da.beam_decode_attention_chunked_q(
        *(jnp.asarray(x[k]) for k in Q8), jnp.int32(step), jnp.int32(layer),
        beams_per_image=R, head_dim=HD, chunk=8, interpret=True,
        **{k: jnp.asarray(x[k]) for k in pre}))
    got = decode_attention.beam_decode_attention_chunked_q(
        *(torch.from_numpy(x[k]) for k in Q8), step, layer,
        beams_per_image=R, head_dim=HD, chunk=8,
        **{k: torch.from_numpy(x[k]) for k in pre})
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-2)


def test_chunked_attention_refuses_what_jax_refuses():
    x = {k: torch.from_numpy(v) for k, v in _inputs(0, 4, 3).items()}
    args = [x[k] for k in FP]
    with pytest.raises(ValueError, match="multiple of chunk"):
        decode_attention.beam_decode_attention_chunked(
            *args, 3, 0, beams_per_image=4, head_dim=HD, chunk=16)
    with pytest.raises(ValueError, match="beams_per_image"):
        decode_attention.beam_decode_attention_chunked(
            *args, 3, 0, beams_per_image=5, head_dim=HD, chunk=8)
    q8 = {k: torch.from_numpy(v) for k, v in
          _inputs(0, 4, 3, int8=True).items()}
    with pytest.raises(ValueError, match="multiple of chunk"):
        decode_attention.beam_decode_attention_chunked_q(
            *(q8[k] for k in Q8), 3, 0, beams_per_image=4, head_dim=HD,
            chunk=16)


def test_quantize_prefix_cache_bit_exact_with_jitted_jax():
    rng = np.random.RandomState(5)
    cache = {"k": rng.randn(L, N, K, D).astype(np.float32) * 3,
             "v": rng.randn(L, N, K, D).astype(np.float32)}
    cache["k"][1, 2, 3] = 0.0  # a zero row takes scale 1
    want = jax.tree.map(np.asarray, jax.jit(jax_gpt2.quantize_prefix_cache)(
        {k: jnp.asarray(v) for k, v in cache.items()}))
    got = gpt2.quantize_prefix_cache(
        {k: torch.from_numpy(v) for k, v in cache.items()})
    assert sorted(got) == sorted(want) == ["k", "ks", "v", "vs"]
    for name in want:
        assert got[name].shape == want[name].shape
        np.testing.assert_array_equal(got[name].numpy(), want[name])


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_seqmajor_slot_write_plain_matches_jax_kernel(dtype):
    rng = np.random.RandomState(2)
    B, step = 6, 13
    k, v = rng.randn(L, B, E, D), rng.randn(L, B, E, D)
    nk, nv = rng.randn(L, B, D), rng.randn(L, B, D)
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    want = jax_cr.write_gen_slot_chunk_seqmajor(
        *(jnp.asarray(a, jdt) for a in (k, v, nk, nv)), jnp.int32(step),
        interpret=True)
    tk, tv, tnk, tnv = (torch.tensor(a, dtype=tdt) for a in (k, v, nk, nv))
    got = cache_reorder.write_gen_slot_chunk_seqmajor(tk, tv, tnk, tnv, step)
    assert got["k"] is tk and got["v"] is tv  # in place
    for name in ("k", "v"):
        np.testing.assert_array_equal(
            got[name].float().numpy(),
            np.asarray(want[name].astype(jnp.float32)))

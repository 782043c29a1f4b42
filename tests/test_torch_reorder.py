"""The cache gathers K10-K12 and the slot write K14 of the port against the
JAX package's Pallas kernels in interpret mode, on the CPU.

Port wrappers (their plain versions on CPU tensors) against
`capdec_tpu.ops.cache_reorder.{reorder_rows_leading, reorder_cache_rows,
reorder_cache_rows_bounded, write_gen_slot}(..., interpret=True)`, bit for
bit in float32 and bfloat16: an odd batch, a `src` in which several rows
read one source, K12 over counts 1, 16, 17, 33 and 40 (only the slots
below `count` are defined), K14 at steps 0, odd, even and E-1. Also the
gathers' output contract: fresh caches by default, a given output kept
beyond K12's count, an output that overlaps the input refused, and a
source outside the batch refused.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capdec_tpu.ops import cache_reorder as jax_cr
from capdec_tpu_torch.ops import cache_reorder as cr

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
SRC = np.asarray([3, 3, 0, 10, 1, 5, 5, 5, 2, 0, 3], np.int64)  # B = 11


def _pair(rng, shape, dtype):
    """One random array in the JAX and the port dtype (bf16 rounds to
    nearest even in both)."""
    x = rng.randn(*shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_reorder_rows_leading_matches_jax_kernel(dtype):
    rng = np.random.RandomState(0)
    shape = (len(SRC), 3, 16, 128)   # [B, L, E, D]
    (jk, k), (jv, v) = _pair(rng, shape, dtype), _pair(rng, shape, dtype)
    want = jax_cr.reorder_rows_leading(jk, jv, jnp.asarray(SRC, jnp.int32),
                                       interpret=True)
    got = cr.reorder_rows_leading(k, v, torch.from_numpy(SRC))
    for name in ("k", "v"):
        np.testing.assert_array_equal(_np(got[name]), _np(want[name]))
    assert got["k"].data_ptr() != k.data_ptr()  # out of place
    assert torch.equal(got["k"], k[torch.from_numpy(SRC)])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_reorder_cache_rows_matches_jax_kernel(dtype):
    rng = np.random.RandomState(1)
    shape = (3, len(SRC), 16, 128)   # [L, B, E, D]
    (jk, k), (jv, v) = _pair(rng, shape, dtype), _pair(rng, shape, dtype)
    want = jax_cr.reorder_cache_rows(jk, jv, jnp.asarray(SRC, jnp.int32),
                                     interpret=True)
    got = cr.reorder_cache_rows(k, v, torch.from_numpy(SRC))
    for name in ("k", "v"):
        np.testing.assert_array_equal(_np(got[name]), _np(want[name]))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("count", [1, 16, 17, 33, 40])
def test_reorder_cache_rows_bounded_matches_jax_kernel(dtype, count):
    rng = np.random.RandomState(2)
    shape = (2, len(SRC), 40, 128)   # [L, B, E, D]
    (jk, k), (jv, v) = _pair(rng, shape, dtype), _pair(rng, shape, dtype)
    want = jax_cr.reorder_cache_rows_bounded(
        jk, jv, jnp.asarray(SRC, jnp.int32), jnp.asarray(count, jnp.int32),
        chunk=16, interpret=True)
    # a given output keeps its slots at or above `count`
    out_k, out_v = torch.full_like(k, 7.0), torch.full_like(v, -7.0)
    got = cr.reorder_cache_rows_bounded(k, v, torch.from_numpy(SRC), count,
                                        out_k=out_k, out_v=out_v)
    assert got["k"] is out_k and got["v"] is out_v
    for name in ("k", "v"):
        np.testing.assert_array_equal(_np(got[name])[:, :, :count],
                                      _np(want[name])[:, :, :count])
    assert (out_k[:, :, count:] == 7.0).all()
    assert (out_v[:, :, count:] == -7.0).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("step", [0, 5, 10, 23])
def test_write_gen_slot_matches_jax_kernel(dtype, step):
    rng = np.random.RandomState(3)
    B, L, E, D = 7, 3, 24, 128
    (jk, k), (jv, v) = (_pair(rng, (B, L, E, D), dtype) for _ in range(2))
    (jnk, nk), (jnv, nv) = (_pair(rng, (B, L, D), dtype) for _ in range(2))
    want = jax_cr.write_gen_slot(jk, jv, jnk, jnv,
                                 jnp.asarray(step, jnp.int32), interpret=True)
    k0 = k.clone()
    got = cr.write_gen_slot(k, v, nk, nv, step)
    assert got["k"] is k and got["v"] is v  # in place
    for name in ("k", "v"):
        np.testing.assert_array_equal(_np(got[name]), _np(want[name]))
    other = torch.arange(E) != step
    assert torch.equal(k[:, :, other], k0[:, :, other])


@pytest.mark.parametrize("gather,args", [
    (cr.reorder_rows_leading, ()), (cr.reorder_cache_rows, ()),
    (cr.reorder_cache_rows_bounded, (4,))])
def test_gathers_refuse_an_output_that_overlaps_the_input(gather, args):
    k, v = torch.randn(2, 6, 8, 16), torch.randn(2, 6, 8, 16)
    src = torch.tensor([1, 1, 0, 5, 4, 4])
    if gather is cr.reorder_rows_leading:
        src = torch.tensor([1, 1])
    with pytest.raises(ValueError, match="overlap"):
        gather(k, v, src, *args, out_k=k, out_v=torch.empty_like(v))
    with pytest.raises(ValueError, match="overlap"):
        gather(k, v, src, *args, out_k=torch.empty_like(k), out_v=v[:])
    both = torch.empty(2, *k.shape)
    with pytest.raises(ValueError, match="overlap"):
        gather(k, v, src, *args, out_k=both[0], out_v=both[0])
    with pytest.raises(ValueError, match="both"):
        gather(k, v, src, *args, out_k=torch.empty_like(k))
    with pytest.raises(ValueError, match="match"):
        gather(k, v, src, *args, out_k=torch.empty(2, 6, 8, 8),
               out_v=torch.empty_like(v))
    # separate outputs are accepted and written
    out = gather(k, v, src, *args, out_k=both[0], out_v=both[1])
    assert out["k"].data_ptr() == both[0].data_ptr()


@pytest.mark.parametrize("gather,args,axis", [
    (cr.reorder_rows_leading, (), 0), (cr.reorder_cache_rows, (), 1),
    (cr.reorder_cache_rows_bounded, (4,), 1)])
@pytest.mark.parametrize("bad", [-1, 6])
def test_gathers_refuse_a_source_outside_the_batch(gather, args, axis, bad):
    """A source outside [0, B) raises on the CPU (the kernel trips a
    device-side assert on the card; tests/test_torch_cuda.py)."""
    k, v = torch.randn(6, 6, 8, 16), torch.randn(6, 6, 8, 16)
    src = torch.tensor([1, 1, 0, 5, 4, bad])
    with pytest.raises((IndexError, RuntimeError), match="out of"):
        gather(k, v, src, *args)
    good = gather(k, v, src.clamp(0, 5), *args)
    assert torch.equal(good["k"].narrow(2, 0, 4),
                       k.index_select(axis, src.clamp(0, 5)).narrow(2, 0, 4))

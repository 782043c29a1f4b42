"""The port's kernel ops (capdec_tpu_torch/ops) against the JAX package.

On the CPU every wrapper runs its plain PyTorch version; these tests hold
those plain versions against the JAX Pallas kernels run in interpret
mode, on the same inputs made from a numpy seed. (The hand-written CUDA
kernels are held against the same plain versions on the card:
tests/test_torch_cuda.py and chip_smoke.py.)

Tolerances:
  * K1 (lm_head_topk): indices identical, ties included; values and
    logsumexp within 1e-5 (f32 reduction order).
  * K2 (decode attention): 2e-2, because the TPU kernel multiplies in
    bf16 even for f32 inputs (decode_attention.py:215-239). The f32
    comparison against the XLA path lives in test_torch_models.py.
  * K3 / K4 (cache writes): bit-exact (K4 on the slots it must move).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capdec_tpu.ops import cache_reorder as jax_cr
from capdec_tpu.ops import decode_attention as jax_da
from capdec_tpu.ops import lm_head as jax_lm
from capdec_tpu_torch.ops import cache_reorder, decode_attention, lm_head

torch.set_num_threads(2)


def _lm_check(h, w, r):
    vals, idx, lse = jax.tree.map(np.asarray, jax_lm.lm_head_topk(
        jnp.asarray(h), jnp.asarray(w), r, block_rows=4, vocab_chunk=128,
        interpret=True))
    tv, ti, tl = lm_head.lm_head_topk(torch.from_numpy(h),
                                      torch.from_numpy(w), r)
    np.testing.assert_array_equal(ti.numpy(), idx)
    np.testing.assert_allclose(tv.numpy(), vals, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), lse, rtol=0, atol=1e-5)
    return ti.numpy()


def test_lm_head_plain_matches_jax_kernel():
    rng = np.random.RandomState(0)
    _lm_check(rng.randn(8, 128).astype(np.float32),
              rng.randn(300, 128).astype(np.float32), 4)


def test_lm_head_all_ties_lowest_index_wins():
    idx = _lm_check(np.zeros((4, 128), np.float32),
                    np.ones((300, 128), np.float32), 5)
    np.testing.assert_array_equal(idx, np.tile(np.arange(5), (4, 1)))


def test_lm_head_ties_across_chunk_boundaries():
    # duplicate rows of w: equal logits straddle the 128-entry chunks
    rng = np.random.RandomState(3)
    base = rng.randn(140, 16)
    w = np.concatenate([base, base[:100], base[:60]]).astype(np.float32)
    _lm_check(rng.randn(6, 16).astype(np.float32), w, 6)


def _attn_inputs(seed, N=3, R=4, L=2, K=5, E=24, D=128, nan_from=None):
    rng = np.random.RandomState(seed)
    B = N * R
    f = lambda *s: rng.randn(*s).astype(np.float32)
    gk, gv = f(B, L, E, D), f(B, L, E, D)
    if nan_from is not None:  # stale slots after a bounded fork copy
        gk[:, :, nan_from:] = np.nan
        gv[:, :, nan_from:] = np.nan
    return dict(q=f(B, D), k_new=f(B, D), v_new=f(B, D), pk=f(L, N, K, D),
                pv=f(L, N, K, D), gk=gk, gv=gv)


@pytest.mark.parametrize("step,e_cap,nan_tail", [
    (0, None, False), (7, 16, False), (13, 24, True), (23, None, True)])
def test_decode_attention_plain_matches_jax_kernel(step, e_cap, nan_tail):
    R, layer = 4, 1
    x = _attn_inputs(step, nan_from=step if nan_tail else None)
    want = np.asarray(jax_da.beam_decode_attention_rowmajor(
        *(jnp.asarray(x[k]) for k in ("q", "k_new", "v_new", "pk", "pv",
                                      "gk", "gv")),
        jnp.int32(step), jnp.int32(layer), beams_per_image=R, head_dim=64,
        interpret=True, e_cap=e_cap))
    got = decode_attention.beam_decode_attention_rowmajor(
        *(torch.from_numpy(x[k]) for k in ("q", "k_new", "v_new", "pk",
                                           "pv", "gk", "gv")),
        step, layer, beams_per_image=R, head_dim=64, e_cap=e_cap)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-2)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_write_gen_slot_plain_matches_jax_kernel(dtype):
    rng = np.random.RandomState(1)
    B, L, E, D, step = 6, 2, 16, 128, 11
    k, v = rng.randn(B, L, E, D), rng.randn(B, L, E, D)
    nk, nv = rng.randn(B, L, D), rng.randn(B, L, D)
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    want = jax_cr.write_gen_slot_chunk(
        *(jnp.asarray(a, jdt) for a in (k, v, nk, nv)), jnp.int32(step),
        interpret=True)
    tk, tv, tnk, tnv = (torch.tensor(a, dtype=tdt) for a in (k, v, nk, nv))
    got = cache_reorder.write_gen_slot_chunk(tk, tv, tnk, tnv, step)
    assert got["k"] is tk  # in place
    for name in ("k", "v"):
        np.testing.assert_array_equal(
            got[name].float().numpy(),
            np.asarray(want[name].astype(jnp.float32)))


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


@pytest.mark.parametrize("count", [0, 9, 30])
def test_copy_forked_rows_plain_matches_jax_kernel(count):
    rng = np.random.RandomState(count)
    N, R, L, E, D = 3, 4, 2, 32, 128
    B = N * R
    k = rng.randn(B, L, E, D).astype(np.float32)
    v = rng.randn(B, L, E, D).astype(np.float32)
    src = _lane_src(rng, N, R)
    want = jax.tree.map(np.asarray, jax_cr.copy_forked_rows_bounded(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(src, jnp.int32),
        jnp.int32(count), interpret=True))
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    got = cache_reorder.copy_forked_rows_bounded(tk, tv,
                                                 torch.from_numpy(src), count)
    forked = src != np.arange(B)
    for name, orig in (("k", k), ("v", v)):
        g = got[name].numpy()
        # the slots the contract moves agree bit for bit with the kernel
        np.testing.assert_array_equal(g[:, :, :count], want[name][:, :, :count])
        # rows that keep their lane and slots >= count are untouched
        np.testing.assert_array_equal(g[~forked], orig[~forked])
        np.testing.assert_array_equal(g[:, :, count:], orig[:, :, count:])

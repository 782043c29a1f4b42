"""K15's plain version (`beam_decode_attention_plain`, the v1 fused decode
attention with the slot write fused in) against the JAX package's Pallas
kernel in interpret mode and against the numpy oracle of
tests/test_decode_attention_kernel.py, on the CPU in f32.

Tolerances: the oracle within 1e-5 (f32 both); the JAX kernel within 5e-2,
because it multiplies in bf16 even for f32 inputs (ROADMAP.md Queue 3,
PR 3). The written slot and every other slot are checked exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capdec_tpu.ops.decode_attention import beam_decode_attention as jax_v1
from capdec_tpu_torch.ops import decode_attention as da
from test_decode_attention_kernel import oracle

torch.set_num_threads(2)


def inputs(seed, N, R, K, E, D, step, tail=0.0):
    rng = np.random.RandomState(seed)
    mk = lambda *s: rng.randn(*s).astype(np.float32) * 0.3
    B = N * R
    q, kn, vn = mk(B, D), mk(B, D), mk(B, D)
    pk, pv = mk(N, K, D), mk(N, K, D)
    gk, gv = mk(B, E, D), mk(B, E, D)
    gk[:, step:] = tail  # slots at or above `step`: not yet written
    gv[:, step:] = tail
    return q, kn, vn, pk, pv, gk, gv


def run_port(q, kn, vn, pk, pv, gk, gv, step, R, hd):
    t = [torch.from_numpy(a.copy()) for a in (q, kn, vn, pk, pv, gk, gv)]
    out, gk2, gv2 = da.beam_decode_attention(*t, step, beams_per_image=R,
                                             head_dim=hd)
    assert gk2 is t[5] and gv2 is t[6]  # updated in place
    return out.numpy(), gk2.numpy(), gv2.numpy()


def run_jax(q, kn, vn, pk, pv, gk, gv, step, R, hd, block_beams):
    out, gk2, gv2 = jax_v1(*map(jnp.asarray, (q, kn, vn, pk, pv, gk, gv)),
                           jnp.asarray(step, jnp.int32), beams_per_image=R,
                           head_dim=hd, block_beams=block_beams,
                           interpret=True)
    return np.asarray(out), np.asarray(gk2), np.asarray(gv2)


def check_slots(gk, gv, gk2, gv2, kn, vn, step):
    np.testing.assert_array_equal(gk2[:, step], kn)
    np.testing.assert_array_equal(gv2[:, step], vn)
    other = np.arange(gk.shape[1]) != step
    np.testing.assert_array_equal(gk2[:, other], gk[:, other])
    np.testing.assert_array_equal(gv2[:, other], gv[:, other])


@pytest.mark.parametrize("step", [0, 3, 7])
def test_plain_matches_oracle_and_the_jax_kernel(step):
    N, R, K, E, D, hd = 2, 5, 6, 8, 256, 64
    args = inputs(step, N, R, K, E, D, step)
    q, kn, vn, pk, pv, gk, gv = args
    out, gk2, gv2 = run_port(*args, step, R, hd)
    np.testing.assert_allclose(out, oracle(*args, step, R, hd), atol=1e-5,
                               rtol=0)
    check_slots(gk, gv, gk2, gv2, kn, vn, step)
    jout, jgk, jgv = run_jax(*args, step, R, hd, block_beams=R)
    np.testing.assert_allclose(out, jout, atol=5e-2, rtol=5e-2)
    # the JAX kernel's caches end the same, bit for bit
    np.testing.assert_array_equal(gk2, jgk)
    np.testing.assert_array_equal(gv2, jgv)


def test_beams_per_image_above_the_jax_block():
    N, R, K, E, D, hd, step = 1, 24, 4, 8, 128, 64, 2
    args = inputs(5, N, R, K, E, D, step)
    q, kn, vn, pk, pv, gk, gv = args
    out, gk2, gv2 = run_port(*args, step, R, hd)
    np.testing.assert_allclose(out, oracle(*args, step, R, hd), atol=1e-5,
                               rtol=0)
    check_slots(gk, gv, gk2, gv2, kn, vn, step)
    jout, _, _ = run_jax(*args, step, R, hd, block_beams=20)
    np.testing.assert_allclose(out, jout, atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("tail", [np.nan, np.inf])
def test_garbage_tail_slots_never_reach_the_output(tail):
    N, R, K, E, D, hd, step = 2, 5, 4, 8, 128, 64, 3
    args = inputs(1, N, R, K, E, D, step, tail=tail)
    q, kn, vn, pk, pv, gk, gv = args
    out, gk2, gv2 = run_port(*args, step, R, hd)
    assert np.isfinite(out).all()
    clean = list(args)
    clean[5], clean[6] = gk.copy(), gv.copy()
    clean[5][:, step:] = 0.0
    clean[6][:, step:] = 0.0
    np.testing.assert_allclose(out, oracle(*clean, step, R, hd), atol=1e-5,
                               rtol=0)
    # slot `step` now holds k_new/v_new; the tail above it is untouched
    check_slots(gk, gv, gk2, gv2, kn, vn, step)


def test_bad_arguments_are_refused():
    args = [torch.from_numpy(a) for a in inputs(0, 2, 5, 4, 8, 128, 3)]
    kw = dict(beams_per_image=5, head_dim=64)
    with pytest.raises(ValueError, match="step"):
        da.beam_decode_attention(*args, 8, **kw)
    with pytest.raises(ValueError, match="gk/gv"):
        da.beam_decode_attention(*args[:5], args[5][:, None], args[6], 3,
                                 **kw)

"""The launch plan of K5, the quantising slot write
(csrc/cache_reorder.cu write_gen_slot_q, `cache_reorder.quant_write_plan`),
checked on the CPU: every (row, layer, K|V) item taken by exactly one warp
(also when the grid has fewer warps than items and each warp loops), the
units a lane holds, refusals of a D the kernel does not take, and one
launch per wrapper call with the plan's arguments, recorded by a stand-in
for the kernel library (the kernel runs only on the card:
tests/test_torch_cuda.py).
"""
import ctypes

import pytest
import torch

from capdec_tpu_torch.ops import _build
from capdec_tpu_torch.ops import cache_reorder as cr

E = 72


def _warp_items(blocks, threads, items):
    """The items each warp takes in the kernel's loop: warp w takes
    w, w + warps, ... below `items`."""
    warps = blocks * threads // 32
    return [list(range(w, items, warps)) for w in range(warps)]


# the served shape (320 rows, 12 layers, 768), the limits of D, and item
# counts that are not a multiple of a block's warps
SHAPES = [(320, 12, 768), (64, 12, 768), (7, 3, 64), (1, 1, 16),
          (333, 5, 1024), (333, 5, 1040), (33, 3, 2048)]


@pytest.mark.parametrize("B,L,D", SHAPES)
@pytest.mark.parametrize("blocks", [None, 1, 3])
def test_plan_covers_every_item_once(B, L, D, blocks):
    """Items 2 (b L + l) + (0 K | 1 V) are each taken by exactly one warp:
    one warp an item under the plan's grid, and under a smaller grid
    (`blocks`) through the kernel's loop."""
    plan = cr.quant_write_plan(B, L, D)
    assert plan["items"] == 2 * B * L
    assert plan["threads"] == cr.QUANT_THREADS and plan["threads"] % 32 == 0
    taken = _warp_items(blocks or plan["blocks"], plan["threads"],
                        plan["items"])
    flat = sorted(i for items in taken for i in items)
    assert flat == list(range(2 * B * L))
    if blocks is None:  # one warp an item, the last block's tail idle
        assert all(len(items) <= 1 for items in taken)
        assert (plan["blocks"] - 1) * plan["threads"] // 32 < plan["items"]
    # a lane holds the item's 8-value units u = lane + 32 c, c < units
    assert plan["units"] == (4 if D <= 1024 else 8)
    assert D // 8 <= 32 * plan["units"]


@pytest.mark.parametrize("D", [0, 8, 24, 2064, 4096])
def test_plan_refuses_a_d_the_kernel_does_not_take(D):
    with pytest.raises(ValueError, match="D % 16 == 0 and D <= 2048"):
        cr.quant_write_plan(4, 2, D)


class _Library:
    """Stands in for the kernel library: records each C entry called."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("capdec_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def library(monkeypatch):
    """The wrapper's kernel route on CPU tensors, into a _Library."""
    lib = _Library()
    monkeypatch.setattr(_build, "on_cpu", lambda t: False)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda device: 0)
    return lib


def _caches(B, L, D, dtype=torch.bfloat16):
    k, v = (torch.zeros(B, L, E, D, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.zeros(B, L, 1, E) for _ in range(2))
    nk, nv = (torch.zeros(B, L, D, dtype=dtype) for _ in range(2))
    return k, v, ks, vs, nk, nv


@pytest.mark.parametrize("B,L,D", [(320, 12, 768), (7, 3, 64),
                                   (5, 2, 2048)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("step", [0, 66])
def test_one_launch_per_call_with_the_plan(library, B, L, D, dtype, step):
    """One launch of K5's C entry: the caches, scales and new K/V, then
    B, L, E, D, step, the plan's blocks and threads, the dtype code and the
    stream, as its SIGNATURES row orders them."""
    args = _caches(B, L, D, dtype)
    n0 = cr.write_gen_slot_chunk_q.launches
    out = cr.write_gen_slot_chunk_q(*args, step)
    assert cr.write_gen_slot_chunk_q.launches == n0 + 1
    assert all(out[name] is t for name, t in zip(("k", "v", "ks", "vs"),
                                                 args))
    entry = "capdec_write_gen_slot_q"
    assert len(library.calls) == 1 and library.calls[0][0] == entry
    got = library.calls[0][1]
    assert got[:6] == tuple(t.data_ptr() for t in args)
    plan = cr.quant_write_plan(B, L, D)
    assert got[6:] == (B, L, E, D, step, plan["blocks"], plan["threads"],
                       _build.DTYPE_CODES[dtype], 0)
    sig = _build.SIGNATURES[entry]
    assert len(sig) == len(got)
    assert all(t is ctypes.c_void_p for t in sig[:6])
    assert all(t is ctypes.c_int for t in sig[6:-1])


def test_refuses_before_any_launch(library):
    """A D above the kernel's limit or off 16, scales of the wrong shape,
    new K/V of another shape, a step out of range, and non-int8 caches or
    int8 new K/V are refused before any launch."""
    with pytest.raises(ValueError, match="D <= 2048"):
        cr.write_gen_slot_chunk_q(*_caches(2, 2, 2064), 0)
    with pytest.raises(ValueError, match="16"):  # int8 rows of 16 bytes
        cr.write_gen_slot_chunk_q(*_caches(2, 2, 40), 0)
    k, v, ks, vs, nk, nv = _caches(4, 2, 64)
    with pytest.raises(ValueError, match="ks/vs"):
        cr.write_gen_slot_chunk_q(k, v, ks[:, :, :, 1:], vs, nk, nv, 0)
    with pytest.raises(ValueError, match="new_k/new_v"):
        cr.write_gen_slot_chunk_q(k, v, ks, vs, nk[:, :1], nv, 0)
    for step in (-1, E):
        with pytest.raises(ValueError, match="step"):
            cr.write_gen_slot_chunk_q(k, v, ks, vs, nk, nv, step)
    with pytest.raises(TypeError, match="int8"):
        cr.write_gen_slot_chunk_q(k.float(), v.float(), ks, vs, nk, nv, 0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cr.write_gen_slot_chunk_q(k, v, ks, vs, nk.to(torch.int8),
                                  nv.to(torch.int8), 0)
    assert library.calls == []


def test_division_free_quotient_is_the_ieee_quotient():
    """K5 takes x / s as q = x * fl(1/s) corrected once by an FMA
    (csrc/cache_reorder.cu level_fma, Markstein's step), then rounds the
    clamped quotient by adding 1.5 * 2^23. For normal operands, amax in
    the kernel's range [2^-60, 2^100] and exact ties (x / s = k + 0.5)
    included, that is the IEEE quotient and its level. Emulated in
    numpy: float32 products and sums, and each FMA as a long double
    (64-bit mantissa) sum rounded once to float32."""
    import numpy as np
    f32, ld = np.float32, np.longdouble
    rng = np.random.default_rng(0)
    x = torch.randn(2000, 768, generator=torch.Generator().manual_seed(0))
    x = x.to(torch.bfloat16).float().numpy()
    x[1::2] = rng.standard_normal((1000, 768)).astype(f32)  # f32 inputs
    x[::5, :127] = np.arange(-63, 64) + 0.5  # ties under amax 127
    x[::5, 127] = 127
    x = (x * f32(2.0) ** rng.integers(-50, 50, (2000, 1))).astype(f32)
    amax = np.abs(x).max(-1, keepdims=True)
    s = (amax * f32(cr.INV_127)).astype(f32)
    inv = (f32(1) / s).astype(f32)
    q = (x * inv).astype(f32)
    r = (-q.astype(ld) * s.astype(ld) + x.astype(ld)).astype(f32)
    y = (r.astype(ld) * inv.astype(ld) + q.astype(ld)).astype(f32)
    assert np.array_equal(y, (x / s).astype(f32))
    magic = f32(12582912.0)
    level = (np.clip(y, -127, 127).astype(f32) + magic).view(np.uint32)
    want = np.clip(np.rint(x / s), -127, 127).astype(np.int64) & 0xff
    assert np.array_equal(level.astype(np.int64) & 0xff, want)

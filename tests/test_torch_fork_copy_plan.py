"""K4, the bounded fork copy (csrc/cache_reorder.cu
copy_forked_rows_bounded, `cache_reorder.fork_copy_plan`), checked on the
CPU:

  * the launch plan takes every (row, layer, K|V, tile) item with exactly
    one warp and every 16-byte word of a (row, layer) slab below `count`
    with exactly one lane, at D 384 and 768 in bf16 and f32 and at B 5,
    320 and 2560; it refuses shapes its kernel does not take;
  * one launch per wrapper call (none at count 0), its arguments in
    `SIGNATURES` order, recorded by a stand-in for the kernel library
    that also carries the kernel's copy out on the CPU as its warps do
    (src read through its pointer; a warp of a row that kept its lane
    moves nothing, a fork's warp copies its source's tile), bit-identical
    to the plain version;
  * the plain version and the wrapper's kernel route through the stand-in
    equal the JAX Pallas kernel in interpret mode bit for bit on the
    slots below `count`, for fork sources from the port's lane
    assignment (R 1, 5 and 33, several seeds) and for a valid `src` whose
    forks cross images; every other byte stays as it was.
"""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capdec_tpu.ops import cache_reorder as jax_cr
from capdec_tpu_torch.decode import beam
from capdec_tpu_torch.ops import _build
from capdec_tpu_torch.ops import cache_reorder as cr

torch.set_num_threads(2)

ITEMSIZE = {torch.bfloat16: 2, torch.float32: 4}


def _decode(plan, L, it):
    """Item it -> (row, layer, K|V, tile), as the kernel decodes it: tile
    fastest, then K|V, then the layer, then the row."""
    tile, rest = it % plan["tiles"], it // plan["tiles"]
    return (rest >> 1) // L, (rest >> 1) % L, rest & 1, tile


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [384, 768])
@pytest.mark.parametrize("B", [5, 320, 2560])
@pytest.mark.parametrize("count", [1, 13, 66])
def test_plan_covers_every_item_and_word_once(B, D, dtype, count):
    L = 12
    plan = cr.fork_copy_plan(B, L, count, D * ITEMSIZE[dtype])
    row16 = D * ITEMSIZE[dtype] // 16
    W = plan["words"]
    assert W == cr.FORK_W
    assert plan["row16"] == row16 and plan["slab16"] == count * row16
    assert plan["threads"] == 32 * plan["warps"]
    assert plan["items"] == 2 * B * L * plan["tiles"]
    # every item decodes to one (row, layer, K|V, tile), each once
    it = np.arange(plan["items"])
    b, l, kv, tile = _decode(plan, L, it)
    key = ((b * L + l) * 2 + kv) * plan["tiles"] + tile
    assert np.array_equal(np.sort(key), it)
    assert b.max() == B - 1 and tile.max() == plan["tiles"] - 1
    # one warp an item: the last block's tail idle
    assert (plan["blocks"] - 1) * plan["warps"] < plan["items"] <= \
        plan["blocks"] * plan["warps"]
    # every word of a slab with one lane of one tile
    t, lane, c = np.meshgrid(np.arange(plan["tiles"]), np.arange(32),
                             np.arange(W), indexing="ij")
    word = (t * 32 * W + lane + 32 * c).ravel()
    assert np.array_equal(np.bincount(word[word < plan["slab16"]],
                                      minlength=plan["slab16"]),
                          np.ones(plan["slab16"]))


def test_served_plans():
    """Batch 64 x R 5 (B 320) at D 768 bf16, 66 live slots: four words a
    lane, 50 tiles a slab, 384000 warps (one of a row that kept its lane
    exits at once); one image: 6000."""
    assert cr.fork_copy_plan(320, 12, 66, 1536) == dict(
        words=4, row16=96, slab16=6336, tiles=50, items=384000, warps=4,
        threads=128, blocks=96000)
    assert cr.fork_copy_plan(5, 12, 66, 1536)["items"] == 6000


@pytest.mark.parametrize("args,match", [
    ((4, 2, 8, 24), "multiple of 16"), ((4, 2, 8, 0), "multiple of 16"),
    ((0, 2, 8, 32), ">= 1"), ((4, 0, 8, 32), ">= 1"),
    ((4, 2, 0, 32), ">= 1")])
def test_plan_refuses_a_shape_the_kernel_does_not_take(args, match):
    with pytest.raises(ValueError, match=match):
        cr.fork_copy_plan(*args)


class _Library:
    """Stands in for the kernel library: records each C entry called and
    carries K4's copy out on the CPU as the kernel's warps would."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("capdec_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            if name == "capdec_copy_forked_rows_bounded":
                _emulate_k4(*args)
            return 0
        return entry


def _emulate_k4(k, v, src_ptr, B, L, E, count, row_bytes, blocks, stream):
    """Warp it decodes its item (row b, layer l, K|V, tile of FORK_W
    words a lane); it moves nothing when src[b] == b, else it copies the
    tile of row src[b]'s slab into row b's."""
    row16, words = row_bytes // 16, cr.FORK_W
    slab16 = count * row16
    tiles = -(-slab16 // (32 * words))
    items = 2 * B * L * tiles
    assert blocks == -(-items // 4)
    src = np.ctypeslib.as_array((ctypes.c_int64 * B).from_address(src_ptr))
    for it in range(items):
        tile, rest = it % tiles, it // tiles
        b, l = divmod(rest >> 1, L)
        s = int(src[b])
        if s == b:
            continue
        cache = v if rest & 1 else k
        w0 = tile * 32 * words
        n = min(slab16 - w0, 32 * words)
        slab = l * E * row16 + w0
        ctypes.memmove(cache + 16 * (b * L * E * row16 + slab),
                       cache + 16 * (s * L * E * row16 + slab), 16 * n)


@pytest.fixture
def library(monkeypatch):
    """The wrapper's kernel route on CPU tensors, into a _Library."""
    lib = _Library()
    monkeypatch.setattr(_build, "run_plain", lambda t: False)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda device: 0)
    return lib


def _lane_src(rng, N, R):
    """Fork sources as the beam engine makes them: random ranked winners'
    source lanes [N, R], given lanes by beam._assign_lanes, as flat rows
    (the engine's pending_src)."""
    winners = torch.from_numpy(rng.randint(0, R, size=(N, R)))
    lanes = beam._assign_lanes(winners, R)
    base = torch.arange(N)[:, None] * R
    return (base + beam._to_lane(winners, lanes)).reshape(-1)


def _ungrouped_src(rng, B):
    """A src that keeps the lane invariant (no written row is a source)
    but forks across the whole batch: a random half of the rows keep
    their beam, each other row copies one of them, anywhere."""
    keep = rng.permutation(B)[:max(1, B // 2)]
    src = np.arange(B)
    for r in range(B):
        if r not in keep:
            src[r] = rng.choice(keep)
    return torch.from_numpy(src)


def _check_invariant(src):
    forked = src != torch.arange(src.shape[0])
    assert not forked[src[forked]].any()  # a source is never written
    return forked


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
@pytest.mark.parametrize("count", [0, 1, 9, 24])
def test_one_launch_per_call_with_the_plan(library, dtype, count):
    """One launch of K4's C entry: the caches, src, B, L, E, count, the
    slot row's bytes, the plan's blocks and the stream, in its
    SIGNATURES row's order; the copy is the plain version's, bit for bit.
    Count 0 moves nothing and launches nothing."""
    N, R, L, E, D = 7, 5, 2, 24, 64
    B = N * R
    rng = np.random.RandomState(count)
    k0 = torch.from_numpy(rng.randn(B, L, E, D).astype(np.float32))
    v0 = torch.from_numpy(rng.randn(B, L, E, D).astype(np.float32))
    if dtype is torch.int8:
        k0, v0 = (t.mul(40).to(torch.int8) for t in (k0, v0))
    k0, v0 = k0.to(dtype), v0.to(dtype)
    src = _lane_src(rng, N, R)
    k, v = k0.clone(), v0.clone()
    n0 = cr.copy_forked_rows_bounded.launches
    out = cr.copy_forked_rows_bounded(k, v, src, count)
    assert out["k"] is k and out["v"] is v
    want = cr.copy_forked_rows_bounded_plain(k0.clone(), v0.clone(), src,
                                             count)
    assert torch.equal(k, want["k"]) and torch.equal(v, want["v"])
    if count == 0:
        assert library.calls == [] and torch.equal(k, k0)
        assert cr.copy_forked_rows_bounded.launches == n0
        return
    assert cr.copy_forked_rows_bounded.launches == n0 + 1
    entry = "capdec_copy_forked_rows_bounded"
    assert len(library.calls) == 1 and library.calls[0][0] == entry
    got = library.calls[0][1]
    row_bytes = D * k.element_size()
    plan = cr.fork_copy_plan(B, L, count, row_bytes)
    assert got == (k.data_ptr(), v.data_ptr(), src.data_ptr(), B, L, E,
                   count, row_bytes, plan["blocks"], 0)
    sig = _build.SIGNATURES[entry]
    assert sig == [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + \
        [ctypes.c_long, ctypes.c_int, ctypes.c_void_p]


@pytest.mark.parametrize("case", ["src_dtype", "src_shape", "count_high",
                                  "count_negative", "row_bytes"])
def test_refuses_before_any_launch(library, case):
    B, L, E, D = 10, 2, 8, 64
    k, v = (torch.zeros(B, L, E, D, dtype=torch.bfloat16) for _ in range(2))
    src, count = torch.arange(B), 4
    if case == "src_dtype":
        src = src.int()
    elif case == "src_shape":
        src = src[:-1]
    elif case == "count_high":
        count = E + 1
    elif case == "count_negative":
        count = -1
    else:
        k, v = (torch.zeros(B, L, E, 4, dtype=torch.bfloat16)
                for _ in range(2))
    with pytest.raises(ValueError):
        cr.copy_forked_rows_bounded(k, v, src, count)
    assert library.calls == []


def _jax_fork(k, v, src, count):
    return jax.tree.map(np.asarray, jax_cr.copy_forked_rows_bounded(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(src, jnp.int32),
        jnp.int32(count), interpret=True))


@pytest.mark.parametrize("R,N,seed", [(1, 4, 0), (5, 6, 0), (5, 6, 1),
                                      (5, 6, 2), (33, 2, 0)])
@pytest.mark.parametrize("count", [7, 24])
def test_lane_assigned_forks_match_jax_kernel(library, R, N, seed, count):
    """Fork sources from the port's lane assignment: the plain version
    and the kernel route against the JAX kernel in interpret mode on the
    slots below count; rows that keep their lane and slots >= count
    untouched."""
    rng = np.random.RandomState(seed * 100 + R)
    B, L, E, D = N * R, 2, 24, 32
    k = rng.randn(B, L, E, D).astype(np.float32)
    v = rng.randn(B, L, E, D).astype(np.float32)
    src = _lane_src(rng, N, R)
    forked = _check_invariant(src).numpy()
    want = _jax_fork(k, v, src.numpy(), count)
    for fn in (cr.copy_forked_rows_bounded_plain,
               cr.copy_forked_rows_bounded):
        tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
        got = fn(tk, tv, src, count)
        for name, orig in (("k", k), ("v", v)):
            g = got[name].numpy()
            np.testing.assert_array_equal(g[:, :, :count],
                                          want[name][:, :, :count])
            np.testing.assert_array_equal(g[~forked], orig[~forked])
            np.testing.assert_array_equal(g[:, :, count:],
                                          orig[:, :, count:])
    assert len(library.calls) == 1


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_spread_src_matches_jax_kernel(library, seed):
    """A valid src whose forks cross images: the kernel route gives the
    JAX kernel's bytes, bf16."""
    rng = np.random.RandomState(seed)
    B, L, E, D, count = 70, 2, 24, 64, 17
    k = rng.randn(B, L, E, D).astype(np.float32)
    v = rng.randn(B, L, E, D).astype(np.float32)
    src = _ungrouped_src(rng, B)
    forked = _check_invariant(src).numpy()
    jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (k, v))
    want = jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)),
        jax_cr.copy_forked_rows_bounded(jk, jv, jnp.asarray(src, jnp.int32),
                                        jnp.int32(count), interpret=True))
    tk, tv = (torch.from_numpy(a.copy()).to(torch.bfloat16) for a in (k, v))
    k0 = tk.clone()
    got = cr.copy_forked_rows_bounded(tk, tv, src, count)
    assert len(library.calls) == 1
    for name in ("k", "v"):
        np.testing.assert_array_equal(got[name][:, :, :count].float().numpy(),
                                      want[name][:, :, :count])
    assert torch.equal(got["k"][torch.from_numpy(~forked)],
                       k0[torch.from_numpy(~forked)])
    assert torch.equal(got["k"][:, :, count:], k0[:, :, count:])

"""K13, the seq-major slot write from per-layer views
(csrc/cache_reorder.cu write_gen_slot_seqmajor,
`cache_reorder.seqmajor_write_plan`), checked on the CPU:

  * the launch plan takes every (layer, row, K|V) item with exactly one
    warp and every 16-byte word of its row with exactly one lane, at the
    served shape and the limits of L, B and D, in bf16 and f32;
  * one launch per wrapper call, its arguments in `SIGNATURES` order,
    recorded by a stand-in for the kernel library that also carries the
    kernel's copy out on the CPU from the pointers and row strides of the
    parameter struct (the kernel itself runs only on the card:
    tests/test_torch_cuda.py), bit-identical to the plain version;
  * the refusals, before any launch;
  * the plain version, given L per-layer views of [B, 3D] arrays, equals
    the JAX Pallas kernel (interpret mode) given the stacked arrays, bit
    for bit;
  * decode_step's K13 route hands the wrapper the per-layer views and
    stacks nothing; every other route still stacks.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capdec_tpu.ops import cache_reorder as jax_cr
from capdec_tpu_torch.models import gpt2
from capdec_tpu_torch.ops import _build
from capdec_tpu_torch.ops import cache_reorder as cr

torch.set_num_threads(2)

SMS = 132  # the H100's SMs
ITEMSIZE = {torch.bfloat16: 2, torch.float32: 4}


def _items_taken(plan):
    """How often each item is taken in the kernel's loop: warp w takes
    items w, w + warps, ... below `items`."""
    warps = plan["blocks"] * plan["warps"]
    count = np.zeros(plan["items"], np.int64)
    for first in range(0, plan["items"], warps):
        count[first:first + warps] += 1
    return count


def _words_taken(plan):
    """How often each word of a row is taken: lane `lane` in pass p holds
    words lane + 32 W p + 32 c, c < W, those below row16."""
    row16, W = plan["row16"], plan["words"]
    lane, p, c = np.meshgrid(np.arange(32), np.arange(plan["passes"] + 1),
                             np.arange(W), indexing="ij")
    word = (lane + 32 * W * p + 32 * c).ravel()
    return np.bincount(word[word < row16], minlength=row16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 768, 1024, 1600])
@pytest.mark.parametrize("B", [1, 7, 64, 320])
@pytest.mark.parametrize("L", [1, 12, 48, 64])
def test_plan_covers_every_item_and_word_once(L, B, D, dtype):
    """Items 2 (l B + b) + (0 K | 1 V) are each taken by one warp, and
    each of a row's 16-byte words by one lane; W is the least of 1, 2, 4,
    8 that covers a row in one pass (8 in passes beyond); blocks of four
    warps unless that leaves an SM without a block."""
    plan = cr.seqmajor_write_plan(L, B, D, ITEMSIZE[dtype], SMS)
    row16 = D * ITEMSIZE[dtype] // 16
    assert plan["items"] == 2 * L * B and plan["row16"] == row16
    assert plan["threads"] == 32 * plan["warps"]
    assert np.array_equal(_items_taken(plan), np.ones(2 * L * B))
    # one warp an item: the last block's tail idle, no warp loops
    assert (plan["blocks"] - 1) * plan["warps"] < plan["items"] <= \
        plan["blocks"] * plan["warps"]
    assert np.array_equal(_words_taken(plan), np.ones(row16))
    W = plan["words"]
    assert W in cr.SEQ_WORDS and (32 * W >= row16 or W == 8)
    assert W == 1 or 16 * W < row16  # the least that covers the row
    assert plan["passes"] == -(-row16 // (32 * W))
    assert plan["warps"] == 4 or -(-plan["items"] // (2 * plan["warps"])) \
        < SMS
    # the items decode to every (layer, row, K|V) once, each slot row once
    it = np.arange(plan["items"])
    row, kv = it >> 1, it & 1
    l, b = row // B, row % B
    assert np.array_equal(np.unique(l * B * 2 + b * 2 + kv), it)


def test_served_plan():
    """At the served shape (L 12, B 64, D 768 bf16): 1536 warps, three of
    a lane's four words live, 384 blocks of four warps: one wave."""
    plan = cr.seqmajor_write_plan(12, 64, 768, 2, SMS)
    assert plan == dict(warps=4, threads=128, words=4, blocks=384,
                        items=1536, row16=96, passes=1)


@pytest.mark.parametrize("args,match", [
    ((65, 4, 64, 2), "L <= 64"), ((0, 4, 64, 2), "L <= 64"),
    ((2, 0, 64, 2), "B >= 1"), ((2, 4, 4, 2), "16 == 0"),
    ((2, 4, 38, 4), "16 == 0")])
def test_plan_refuses_a_shape_the_kernel_does_not_take(args, match):
    with pytest.raises(ValueError, match=match):
        cr.seqmajor_write_plan(*args, SMS)


class _Library:
    """Stands in for the kernel library: records each C entry called and
    carries K13's copy out on the CPU as the kernel would, 16-byte word
    by word, from the parameter struct's pointers and row strides."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("capdec_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            if name == "capdec_write_gen_slot_seqmajor":
                _emulate_k13(*args)
            return 0
        return entry


def _emulate_k13(k, v, src, L, B, E, step, row_bytes, warps, words, blocks,
                 stream):
    """The kernel's loop: warp w takes items w, w + warps, ...; item it
    is row (it >> 1) = l B + b of K (it even) or V; lane words as
    _words_taken lists them."""
    row16 = row_bytes // 16
    total = blocks * warps
    for w in range(total):
        for it in range(w, 2 * L * B, total):
            row, is_v = it >> 1, it & 1
            l, b = divmod(row, B)
            base, stride = ((src.v[l], src.v_row16[l]) if is_v
                            else (src.k[l], src.k_row16[l]))
            s = base + 16 * b * stride
            d = (v if is_v else k) + 16 * ((row * E + step) * row16)
            for lane in range(32):
                for first in range(lane, row16, 32 * words):
                    for c in range(words):
                        i = first + 32 * c
                        if i < row16:
                            ctypes.memmove(d + 16 * i, s + 16 * i, 16)


@pytest.fixture
def library(monkeypatch):
    """The wrapper's kernel route on CPU tensors, into a _Library."""
    lib = _Library()
    monkeypatch.setattr(_build, "on_cpu", lambda t: False)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda device: 0)
    monkeypatch.setattr(_build, "sm_count", lambda device: SMS)
    return lib


def _values(rng, *shape, dtype=torch.bfloat16):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)


def _sources(rng, form, L, B, D, dtype):
    """new_k, new_v and the tensors holding them: per-layer views of
    [B, 3D] qkv arrays ("qkv"), L contiguous [B, D] tensors ("layers"),
    or [L, B, D] tensors ("stacked", the JAX signature)."""
    if form == "qkv":
        qkv = [_values(rng, B, 3 * D, dtype=dtype) for _ in range(L)]
        return ([t[:, D:2 * D] for t in qkv], [t[:, 2 * D:] for t in qkv],
                qkv)
    if form == "layers":
        nk = [_values(rng, B, D, dtype=dtype) for _ in range(L)]
        nv = [_values(rng, B, D, dtype=dtype) for _ in range(L)]
        return nk, nv, nk + nv
    nk, nv = _values(rng, L, B, D, dtype=dtype), _values(rng, L, B, D,
                                                         dtype=dtype)
    return nk, nv, [nk, nv]


@pytest.mark.parametrize("form", ["qkv", "layers", "stacked"])
@pytest.mark.parametrize("L,B,D,dtype", [
    (3, 5, 64, torch.bfloat16), (2, 7, 32, torch.float32),
    (1, 1, 8, torch.bfloat16), (2, 3, 2080, torch.bfloat16),
    (2, 2, 16, torch.int8)])
@pytest.mark.parametrize("step", [0, 7])
def test_one_launch_per_call_with_the_plan(library, form, L, B, D, dtype,
                                           step):
    """One launch of K13's C entry: the caches, the parameter struct, L,
    B, E, step, the row's bytes, the plan's warps, words and blocks and
    the stream, as its SIGNATURES row orders them; the struct holds each
    layer's base pointers and row strides, and the copy they describe is
    the plain version's, bit for bit, with the sources untouched."""
    rng = np.random.RandomState(L * 100 + B + step)
    E = 8
    k0, v0 = _values(rng, L, B, E, D, dtype=torch.float32).to(dtype), \
        _values(rng, L, B, E, D, dtype=torch.float32).to(dtype)
    nk, nv, held = _sources(rng, form, L, B, D, dtype)
    before = [t.clone() for t in held]
    k, v = k0.clone(), v0.clone()
    n0 = cr.write_gen_slot_chunk_seqmajor.launches
    out = cr.write_gen_slot_chunk_seqmajor(k, v, nk, nv, step)
    assert cr.write_gen_slot_chunk_seqmajor.launches == n0 + 1
    assert out["k"] is k and out["v"] is v
    entry = "capdec_write_gen_slot_seqmajor"
    assert len(library.calls) == 1 and library.calls[0][0] == entry
    got = library.calls[0][1]
    item = k.element_size()
    plan = cr.seqmajor_write_plan(L, B, D, item, SMS)
    assert got[0] == k.data_ptr() and got[1] == v.data_ptr()
    assert isinstance(got[2], _build.SeqmajorSources)
    assert got[3:] == (L, B, E, step, D * item, plan["warps"],
                       plan["words"], plan["blocks"], 0)
    layers = lambda x: list(x.unbind(0)) if torch.is_tensor(x) else x
    for name, views in (("k", layers(nk)), ("v", layers(nv))):
        assert list(getattr(got[2], name)[:L]) == [t.data_ptr()
                                                   for t in views]
        assert list(getattr(got[2], name + "_row16")[:L]) == [
            t.stride(0) * item // 16 if B > 1 else 0 for t in views]
    sig = _build.SIGNATURES[entry]
    assert len(sig) == len(got)
    assert sig[:2] == [ctypes.c_void_p] * 2 and sig[-1] is ctypes.c_void_p
    assert sig[2] is ctypes.POINTER(_build.SeqmajorSources)
    assert sig[3:7] == [ctypes.c_int] * 4 and sig[7] is ctypes.c_long
    assert sig[8:11] == [ctypes.c_int] * 3
    want = cr.write_gen_slot_chunk_seqmajor_plain(k0.clone(), v0.clone(), nk,
                                                  nv, step)
    assert torch.equal(k, want["k"]) and torch.equal(v, want["v"])
    assert all(torch.equal(a, b) for a, b in zip(held, before))


def test_parameter_struct_layout():
    """The struct is csrc/cache_reorder.cu's SeqmajorSources: 64 K and 64
    V pointers, then 64 and 64 int row strides, 1536 bytes."""
    S = _build.SeqmajorSources
    assert _build.SEQ_MAX_LAYERS == 64
    assert (S.k.offset, S.v.offset, S.k_row16.offset, S.v_row16.offset) == \
        (0, 512, 1024, 1280)
    assert ctypes.sizeof(S) == 1536


def _caches(L=3, B=4, E=8, D=64, dtype=torch.bfloat16):
    k, v = (torch.zeros(L, B, E, D, dtype=dtype) for _ in range(2))
    qkv = [torch.zeros(B, 3 * D, dtype=dtype) for _ in range(L)]
    return k, v, [t[:, D:2 * D] for t in qkv], [t[:, 2 * D:] for t in qkv]


def _misaligned_base(L, B, D):
    """Views [B, D] whose base is 2 bytes past a 16-byte boundary."""
    buf = torch.zeros(L, B * D + 8, dtype=torch.bfloat16)
    return [t[1:1 + B * D].view(B, D) for t in buf]


@pytest.mark.parametrize("case", [
    "layers_65", "last_dim_strided", "row_stride_off_16", "row_stride_short",
    "base_off_16", "mixed_dtype", "mixed_device", "overlaps_k",
    "overlaps_v", "too_few_layers", "wrong_shape", "step_negative",
    "step_E"])
def test_refuses_before_any_launch(library, case):
    """Each of these is refused with a ValueError, and nothing launches."""
    k, v, nk, nv = _caches()
    L, B, E, D = k.shape
    step = 0
    if case == "layers_65":
        k, v = (torch.zeros(65, 1, 2, 8, dtype=torch.bfloat16)
                for _ in range(2))
        nk = nv = [torch.zeros(1, 8, dtype=torch.bfloat16)] * 65
    elif case == "last_dim_strided":
        nk = [t[:, ::2] for t in torch.zeros(L, B, 2 * D,
                                             dtype=torch.bfloat16)]
    elif case == "row_stride_off_16":  # rows 65 values (130 bytes) apart
        nk = [t[:, :D] for t in torch.zeros(L, B, D + 1,
                                            dtype=torch.bfloat16)]
    elif case == "row_stride_short":  # rows that overlap each other
        nk = [t.as_strided((B, D), (8, 1)) for t in torch.zeros(
            L, B * D, dtype=torch.bfloat16)]
    elif case == "base_off_16":
        nk = _misaligned_base(L, B, D)
    elif case == "mixed_dtype":
        nv = [t.float() for t in nv]
    elif case == "mixed_device":
        nk = [torch.empty(B, D, dtype=torch.bfloat16, device="meta")] * L
    elif case == "overlaps_k":
        nk = [k[l, :, E - 1] for l in range(L)]  # a slot of the cache
    elif case == "overlaps_v":
        nv = [v[l, :, 3] for l in range(L)]
    elif case == "too_few_layers":
        nk = nk[:-1]
    elif case == "wrong_shape":
        nv = [t[:-1] for t in nv]
    elif case == "step_negative":
        step = -1
    elif case == "step_E":
        step = E
    with pytest.raises(ValueError):
        cr.write_gen_slot_chunk_seqmajor(k, v, nk, nv, step)
    assert library.calls == []


def test_refuses_a_tensor_form_of_the_wrong_shape(library):
    k, v, _, _ = _caches()
    L, B, E, D = k.shape
    bad = torch.zeros(L, B, D + 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="each layer"):
        cr.write_gen_slot_chunk_seqmajor(k, v, bad, bad, 0)
    assert library.calls == []


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("step", [0, 7, 8, 23])
def test_plain_from_views_matches_jax_kernel(dtype, step):
    """The plain version (and the wrapper, which runs it on the CPU),
    given the k and v thirds of per-layer [B, 3D] arrays, against the JAX
    Pallas kernel in interpret mode given the same K/V stacked [L, B, D]:
    bit for bit, in place."""
    rng = np.random.RandomState(step)
    L, B, E, D = 3, 6, 24, 128
    k, v = rng.randn(L, B, E, D), rng.randn(L, B, E, D)
    qkv = rng.randn(L, B, 3 * D)
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    want = jax_cr.write_gen_slot_chunk_seqmajor(
        *(jnp.asarray(a, jdt) for a in (k, v, qkv[..., D:2 * D],
                                        qkv[..., 2 * D:])),
        jnp.int32(step), interpret=True)
    tq = [torch.tensor(a, dtype=tdt) for a in qkv]
    nk, nv = [t[:, D:2 * D] for t in tq], [t[:, 2 * D:] for t in tq]
    for fn in (cr.write_gen_slot_chunk_seqmajor_plain,
               cr.write_gen_slot_chunk_seqmajor):
        tk, tv = (torch.tensor(a, dtype=tdt) for a in (k, v))
        got = fn(tk, tv, nk, nv, step)
        assert got["k"] is tk and got["v"] is tv  # in place
        for name in ("k", "v"):
            np.testing.assert_array_equal(
                got[name].float().numpy(),
                np.asarray(want[name].astype(jnp.float32)))


# decode_step on a tiny GPT-2 (two layers of 128, two heads)
TINY = dict(vocab_size=64, n_positions=32, n_embd=128, n_layer=2, n_head=2)
N, K, E = 3, 4, 8


@pytest.fixture(scope="module")
def tiny():
    cfg = gpt2.GPT2Config(**TINY)
    model = gpt2.init_params(gpt2.GPT2LMHeadModel(cfg), cfg,
                             torch.Generator().manual_seed(0))
    x = np.random.RandomState(0).randn(N, K, cfg.n_embd).astype(np.float32)
    _, prefix = gpt2.prefill(model, cfg, torch.from_numpy(x))
    tok = np.random.RandomState(1).randn(N, cfg.n_embd).astype(np.float32)
    return cfg, model, prefix, torch.from_numpy(tok)


# route -> (decode_step keywords, the cache, the wrapper it writes with,
# whether that wrapper gets the layers' K/V stacked)
ROUTES = {
    "k13": (dict(rowmajor=False, chunk_slot_write=True), "seq",
            "write_gen_slot_chunk_seqmajor", False),
    "seq_plain": (dict(rowmajor=False, chunk_slot_write=False), "seq",
                  "write_gen_slot_chunk_seqmajor_plain", True),
    "seq_int8": (dict(rowmajor=False, chunk_slot_write=True), "seq_int8",
                 "write_gen_slot_chunk_q_plain", True),
    "k3": (dict(chunk_slot_write=True, e_cap=E), "row",
           "write_gen_slot_chunk", True),
    "k14": (dict(chunk_slot_write=False, slot_write_kernel=True, e_cap=E),
            "row", "write_gen_slot", True),
    "k5": (dict(chunk_slot_write=True, e_cap=E), "row_int8",
           "write_gen_slot_chunk_q", True),
}


def _gen_cache(cfg, kind):
    return {"seq": gpt2.init_gen_cache, "seq_int8": gpt2.init_gen_cache_int8,
            "row": gpt2.init_gen_cache_rowmajor,
            "row_int8": gpt2.init_gen_cache_rowmajor_int8}[kind](cfg, N, E)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_decode_step_hands_k13_the_layer_views(tiny, monkeypatch, route):
    """decode_step's K13 route passes the wrapper the lists of the layers'
    k and v thirds of their [B, 3D] qkv outputs and calls no torch.stack;
    every other route stacks twice as before. Either way the step writes
    what the plain route writes."""
    cfg, model, prefix, tok = tiny
    knobs, kind, writer, stacked = ROUTES[route]
    D, L = cfg.n_embd, cfg.n_layer
    seen, stacks = [], []
    real_write, real_stack = getattr(cr, writer), torch.stack

    def capture(*args):  # the stacks of a plain version on the CPU apart
        seen.append(args)
        return real_write(*args)

    def counting_stack(*args, **kw):
        if not seen:
            stacks.append(len(args[0]))
        return real_stack(*args, **kw)

    cache = _gen_cache(cfg, kind)
    monkeypatch.setattr(cr, writer, capture)
    monkeypatch.setattr(torch, "stack", counting_stack)
    hid = gpt2.decode_step(model, cfg, tok, prefix, cache, 3, **knobs)
    monkeypatch.undo()
    assert len(seen) == 1
    new_k, new_v = seen[0][-3:-1]
    if stacked:
        assert stacks == [L, L]
        assert torch.is_tensor(new_k) and torch.is_tensor(new_v)
    else:
        assert stacks == []
        for views in (new_k, new_v):
            assert isinstance(views, list) and len(views) == L
            for t in views:  # a third of a [B, 3D] qkv output, in place
                assert t.shape == (N, D) and t.stride() == (3 * D, 1)
                assert t._base is not None and t._base.shape == (N, 3 * D)
        assert all(a._base is b._base for a, b in zip(new_k, new_v))
    plain = _gen_cache(cfg, kind)
    want = gpt2.decode_step(model, cfg, tok, prefix, plain, 3,
                            **dict(knobs, chunk_slot_write=False))
    assert torch.equal(hid, want)
    for name in cache:
        assert torch.equal(cache[name], plain[name])

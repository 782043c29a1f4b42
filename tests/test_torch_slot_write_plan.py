"""K3 and K14, the row-major slot write from per-layer views
(csrc/cache_reorder.cu write_gen_slot_views<W, true>,
`cache_reorder.slot_write_plan`), checked on the CPU:

  * the launch plan takes every (layer, row, K|V) item with exactly one
    warp, every slot row of the row-major cache with exactly one item and
    every 16-byte word of a row with exactly one lane, at D 384 and 768
    in bf16 and f32 and at B 5, 320 and 2560; it refuses shapes its
    kernel does not take;
  * one launch per wrapper call, through K3's C entry for both K3 and
    K14 (each with its own count), its arguments in `SIGNATURES` order,
    recorded by a stand-in for the kernel library that also carries the
    kernel's copy out on the CPU from the parameter struct's pointers and
    row strides, bit-identical to the plain version, from the thirds of
    per-layer [B, 3D] qkv arrays, from L [B, D] tensors and from a
    [B, L, D] tensor (read as its L strided views);
  * the refusals, before any launch;
  * the plain version given L per-layer views equals the JAX Pallas
    kernels (write_gen_slot_chunk and write_gen_slot, interpret mode)
    given the same K/V stacked [B, L, D], bit for bit;
  * decode_step's K3 and K14 routes hand the wrapper the per-layer
    views, and the launch reads them where they lie.
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
from capdec_tpu_torch.ops import epilogue

torch.set_num_threads(2)

SMS = 132  # the H100's SMs
ITEMSIZE = {torch.bfloat16: 2, torch.float32: 4}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [384, 768])
@pytest.mark.parametrize("B", [5, 320, 2560])
def test_plan_covers_every_item_slot_row_and_word_once(B, D, dtype):
    """Items 2 (l B + b) + (0 K | 1 V) are each taken by one warp; they
    land on the row-major slot rows (b L + l) once each; each of a row's
    16-byte words is taken by one lane."""
    L = 12
    plan = cr.slot_write_plan(L, B, D, ITEMSIZE[dtype], SMS)
    row16 = D * ITEMSIZE[dtype] // 16
    W = plan["words"]
    assert plan["items"] == 2 * L * B and plan["row16"] == row16
    assert plan["threads"] == 32 * plan["warps"]
    assert W in cr.SLOT_WORDS and (32 * W >= row16 or W == 8)
    assert W == 1 or 16 * W < row16
    assert plan["warps"] == 4 or L * -(-2 * B // (2 * plan["warps"])) < SMS
    # one warp an item: warp j < 2 B of layer l (grid.y) takes row j >> 1
    # of K or V; each layer's last block's tail idle
    assert plan["blocks"] == L * plan["layer_blocks"]
    assert (plan["layer_blocks"] - 1) * plan["warps"] < 2 * B <= \
        plan["layer_blocks"] * plan["warps"]
    j = np.arange(plan["layer_blocks"] * plan["warps"])
    j = j[j < 2 * B]
    l = np.repeat(np.arange(L), len(j))
    j = np.tile(j, L)
    dest = 2 * ((j >> 1) * L + l) + (j & 1)  # the row-major slot row, K|V
    assert np.array_equal(np.sort(dest), np.arange(plan["items"]))
    lane, p, c = np.meshgrid(np.arange(32), np.arange(plan["passes"] + 1),
                             np.arange(W), indexing="ij")
    word = (lane + 32 * W * p + 32 * c).ravel()
    assert np.array_equal(np.bincount(word[word < row16], minlength=row16),
                          np.ones(row16))


def test_served_plans():
    """B 320 x L 12: at D 768 bf16 three of a lane's four words live, at a
    tp=2 rank's D 384 a lane's two words cover 48; 7680 warps in 160
    blocks of four a layer. B 5 (the demo): 120 warps, one a block."""
    assert cr.slot_write_plan(12, 320, 768, 2, SMS) == dict(
        warps=4, threads=128, words=4, layer_blocks=160, blocks=1920,
        items=7680, row16=96, passes=1)
    assert cr.slot_write_plan(12, 320, 384, 2, SMS)["words"] == 2
    assert cr.slot_write_plan(12, 5, 768, 2, SMS) == dict(
        warps=1, threads=32, words=4, layer_blocks=10, blocks=120,
        items=120, row16=96, passes=1)


@pytest.mark.parametrize("args,match", [
    ((65, 4, 64, 2), "L <= 64"), ((0, 4, 64, 2), "L <= 64"),
    ((2, 0, 64, 2), "B >= 1"), ((2, 4, 4, 2), "16 == 0"),
    ((2, 4, 38, 4), "16 == 0")])
def test_plan_refuses_a_shape_the_kernel_does_not_take(args, match):
    with pytest.raises(ValueError, match=match):
        cr.slot_write_plan(*args, SMS)


class _Library:
    """Stands in for the kernel library: records each C entry called and
    carries the row-major slot write out on the CPU as the kernel would,
    16-byte word by word, from the parameter struct."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("capdec_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            if name == "capdec_write_gen_slot":
                _emulate_k3(*args)
            return 0
        return entry


def _emulate_k3(k, v, src, L, B, E, step, row_bytes, warps, words, blocks,
                stream):
    """Warp j < 2 B of layer l (of `blocks` blocks of `warps` warps a
    layer) takes row b = j >> 1 of K (j even) or V, read from the struct,
    written to slot row (b L + l) E + step."""
    row16 = row_bytes // 16
    assert blocks == -(-2 * B // warps)
    for l in range(L):
        for j in range(min(blocks * warps, 2 * B)):
            b, is_v = j >> 1, j & 1
            base, stride = ((src.v[l], src.v_row16[l]) if is_v
                            else (src.k[l], src.k_row16[l]))
            s = base + 16 * b * stride
            d = (v if is_v else k) + 16 * (((b * L + l) * E + step) * row16)
            for lane in range(32):
                for first in range(lane, row16, 32 * words):
                    for c in range(words):
                        i = first + 32 * c
                        if i < row16:
                            ctypes.memmove(d + 16 * i, s + 16 * i, 16)


@pytest.fixture
def library(monkeypatch):
    """The wrappers' kernel route on CPU tensors, into a _Library."""
    lib = _Library()
    monkeypatch.setattr(_build, "run_plain", lambda t: False)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda device: 0)
    monkeypatch.setattr(_build, "sm_count", lambda device: SMS)
    return lib


def _values(rng, *shape, dtype=torch.bfloat16):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)


def _sources(rng, form, L, B, D, dtype):
    """new_k, new_v and the tensors holding them: per-layer views of
    [B, 3D] qkv arrays ("qkv"), L contiguous [B, D] tensors ("layers"),
    or [B, L, D] tensors ("stacked", the JAX signature)."""
    if form == "qkv":
        qkv = [_values(rng, B, 3 * D, dtype=dtype) for _ in range(L)]
        return ([t[:, D:2 * D] for t in qkv], [t[:, 2 * D:] for t in qkv],
                qkv)
    if form == "layers":
        nk = [_values(rng, B, D, dtype=dtype) for _ in range(L)]
        nv = [_values(rng, B, D, dtype=dtype) for _ in range(L)]
        return nk, nv, nk + nv
    nk, nv = _values(rng, B, L, D, dtype=dtype), _values(rng, B, L, D,
                                                         dtype=dtype)
    return nk, nv, [nk, nv]


@pytest.mark.parametrize("wrapper", ["write_gen_slot_chunk",
                                     "write_gen_slot"])
@pytest.mark.parametrize("form", ["qkv", "layers", "stacked"])
@pytest.mark.parametrize("L,B,D,dtype", [
    (3, 5, 64, torch.bfloat16), (2, 7, 32, torch.float32),
    (1, 1, 8, torch.bfloat16), (2, 3, 2080, torch.bfloat16),
    (2, 2, 16, torch.int8)])
@pytest.mark.parametrize("step", [0, 7])
def test_one_launch_per_call_with_the_plan(library, wrapper, form, L, B, D,
                                           dtype, step):
    """One launch of K3's C entry for K3 and K14 alike: the caches, the
    parameter struct, L, B, E, step, the row's bytes, the plan's warps,
    words and blocks and the stream, as its SIGNATURES row orders them;
    the struct holds each layer's base pointers and row strides (a
    [B, L, D] tensor's layer l at offset l D, rows L D apart), and the
    copy they describe is the plain version's, bit for bit, with the
    sources untouched. Only the called wrapper's count moves."""
    rng = np.random.RandomState(L * 100 + B + step)
    E = 8
    k0, v0 = (_values(rng, B, L, E, D, dtype=torch.float32).to(dtype)
              for _ in range(2))
    nk, nv, held = _sources(rng, form, L, B, D, dtype)
    before = [t.clone() for t in held]
    k, v = k0.clone(), v0.clone()
    fn = getattr(cr, wrapper)
    other = cr.write_gen_slot if fn is cr.write_gen_slot_chunk \
        else cr.write_gen_slot_chunk
    n0, m0 = fn.launches, other.launches
    out = fn(k, v, nk, nv, step)
    assert fn.launches == n0 + 1 and other.launches == m0
    assert out["k"] is k and out["v"] is v
    entry = "capdec_write_gen_slot"
    assert len(library.calls) == 1 and library.calls[0][0] == entry
    got = library.calls[0][1]
    item = k.element_size()
    plan = cr.slot_write_plan(L, B, D, item, SMS)
    assert got[0] == k.data_ptr() and got[1] == v.data_ptr()
    assert isinstance(got[2], _build.LayerSources)
    assert got[3:] == (L, B, E, step, D * item, plan["warps"],
                       plan["words"], plan["layer_blocks"], 0)
    layers = lambda x: list(x.unbind(1)) if torch.is_tensor(x) else x
    for name, views in (("k", layers(nk)), ("v", layers(nv))):
        assert list(getattr(got[2], name)[:L]) == [t.data_ptr()
                                                   for t in views]
        assert list(getattr(got[2], name + "_row16")[:L]) == [
            t.stride(0) * item // 16 if B > 1 else 0 for t in views]
    sig = _build.SIGNATURES[entry]
    assert sig == _build.SIGNATURES["capdec_write_gen_slot_seqmajor"]
    assert len(sig) == len(got) and sig[2] is ctypes.POINTER(
        _build.LayerSources)
    assert sig[3:7] == [ctypes.c_int] * 4 and sig[7] is ctypes.c_long
    want = cr.write_gen_slot_chunk_plain(k0.clone(), v0.clone(), nk, nv,
                                         step)
    assert torch.equal(k, want["k"]) and torch.equal(v, want["v"])
    assert all(torch.equal(a, b) for a, b in zip(held, before))


def _caches(B=4, L=3, E=8, D=64, dtype=torch.bfloat16):
    k, v = (torch.zeros(B, L, E, D, dtype=dtype) for _ in range(2))
    qkv = [torch.zeros(B, 3 * D, dtype=dtype) for _ in range(L)]
    return k, v, [t[:, D:2 * D] for t in qkv], [t[:, 2 * D:] for t in qkv]


@pytest.mark.parametrize("wrapper", ["write_gen_slot_chunk",
                                     "write_gen_slot"])
@pytest.mark.parametrize("case", [
    "layers_65", "last_dim_strided", "row_stride_off_16", "base_off_16",
    "mixed_dtype", "overlaps_k", "overlaps_v", "too_few_layers",
    "wrong_shape", "tensor_seqmajor", "step_negative", "step_E"])
def test_refuses_before_any_launch(library, wrapper, case):
    """Each of these is refused with a ValueError, and nothing launches."""
    k, v, nk, nv = _caches()
    B, L, E, D = k.shape
    step = 0
    if case == "layers_65":
        k, v = (torch.zeros(1, 65, 2, 8, dtype=torch.bfloat16)
                for _ in range(2))
        nk = nv = [torch.zeros(1, 8, dtype=torch.bfloat16)] * 65
    elif case == "last_dim_strided":
        nk = [t[:, ::2] for t in torch.zeros(L, B, 2 * D,
                                             dtype=torch.bfloat16)]
    elif case == "row_stride_off_16":  # rows 65 values (130 bytes) apart
        nk = [t[:, :D] for t in torch.zeros(L, B, D + 1,
                                            dtype=torch.bfloat16)]
    elif case == "base_off_16":
        buf = torch.zeros(L, B * D + 8, dtype=torch.bfloat16)
        nk = [t[1:1 + B * D].view(B, D) for t in buf]
    elif case == "mixed_dtype":
        nv = [t.float() for t in nv]
    elif case == "overlaps_k":
        nk = [k[:, l, E - 1] for l in range(L)]  # a slot of the cache
    elif case == "overlaps_v":
        nv = [v[:, l, 3] for l in range(L)]
    elif case == "too_few_layers":
        nk = nk[:-1]
    elif case == "wrong_shape":
        nv = [t[:-1] for t in nv]
    elif case == "tensor_seqmajor":  # [L, B, D] where [B, L, D] belongs
        nk = nv = torch.zeros(L, B, D, dtype=torch.bfloat16)
    elif case == "step_negative":
        step = -1
    else:
        step = E
    with pytest.raises(ValueError):
        getattr(cr, wrapper)(k, v, nk, nv, step)
    assert library.calls == []


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("step", [0, 7, 8, 23])
def test_plain_from_views_matches_jax_kernels(dtype, step):
    """The plain version (and the wrappers, which run it on the CPU),
    given the k and v thirds of per-layer [B, 3D] arrays, against the JAX
    Pallas kernels write_gen_slot_chunk (K3) and write_gen_slot (K14) in
    interpret mode given the same K/V stacked [B, L, D]: bit for bit, in
    place."""
    rng = np.random.RandomState(step)
    L, B, E, D = 3, 6, 24, 128
    k, v = rng.randn(B, L, E, D), rng.randn(B, L, E, D)
    qkv = rng.randn(L, B, 3 * D)
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    stacked = [jnp.asarray(qkv[..., D:2 * D].transpose(1, 0, 2), jdt),
               jnp.asarray(qkv[..., 2 * D:].transpose(1, 0, 2), jdt)]
    tq = [torch.tensor(a, dtype=tdt) for a in qkv]
    nk, nv = [t[:, D:2 * D] for t in tq], [t[:, 2 * D:] for t in tq]
    for jax_fn, fns in (
            (jax_cr.write_gen_slot_chunk, (cr.write_gen_slot_chunk_plain,
                                           cr.write_gen_slot_chunk)),
            (jax_cr.write_gen_slot, (cr.write_gen_slot_plain,
                                     cr.write_gen_slot))):
        want = jax_fn(jnp.asarray(k, jdt), jnp.asarray(v, jdt), *stacked,
                      jnp.int32(step), interpret=True)
        for fn in fns:
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


# route -> (decode_step keywords, the wrapper it writes with)
ROUTES = {
    "k3": (dict(chunk_slot_write=True), "write_gen_slot_chunk"),
    "k14": (dict(chunk_slot_write=False, slot_write_kernel=True),
            "write_gen_slot")}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_decode_step_launches_from_the_layer_views(tiny, library,
                                                   monkeypatch, route):
    """decode_step's K3 and K14 routes (plain attention and epilogues, so
    that only the slot write reaches the stand-in library) call no
    torch.stack and launch once; the struct's pointers are the k and v thirds of each
    layer's [B, 3D] qkv output, rows 3D apart; the step writes what the
    plain route writes."""
    cfg, model, prefix, tok = tiny
    knobs, writer = ROUTES[route]
    D, L = cfg.n_embd, cfg.n_layer
    views = []
    real_write = getattr(cr, writer)

    def capture(k, v, nk, nv, step):
        views.append((nk, nv))
        return real_write(k, v, nk, nv, step)
    capture.launches = 0  # the wrapper counts under its module name

    def no_stack(*args, **kw):
        raise AssertionError("decode_step stacked the layers' K/V")

    cache = gpt2.init_gen_cache_rowmajor(cfg, N, E)
    monkeypatch.setattr(cr, writer, capture)
    monkeypatch.setattr(torch, "stack", no_stack)
    for name in ("bias_cast", "bias_gelu_cast", "bias_residual_layernorm",
                 "embed_layernorm"):
        monkeypatch.setattr(epilogue, name, getattr(epilogue,
                                                     name + "_plain"))
    hid = gpt2.decode_step(model, cfg, tok, prefix, cache, 3, e_cap=E,
                           fused_attention=False, **knobs)
    monkeypatch.undo()
    (nk, nv), = views
    assert len(library.calls) == 1
    name, args = library.calls[0]
    assert name == "capdec_write_gen_slot"
    src = args[2]
    for side, got in (("k", nk), ("v", nv)):
        assert isinstance(got, list) and len(got) == L
        for l, t in enumerate(got):
            assert t.shape == (N, D) and t.stride() == (3 * D, 1)
            assert t._base is not None and t._base.shape == (N, 3 * D)
            assert getattr(src, side)[l] == t.data_ptr()
            assert getattr(src, side + "_row16")[l] == 3 * D * 4 // 16
    plain = gpt2.init_gen_cache_rowmajor(cfg, N, E)
    want = gpt2.decode_step(model, cfg, tok, prefix, plain, 3, e_cap=E,
                            fused_attention=False, chunk_slot_write=False)
    assert torch.equal(hid, want)
    for name in cache:
        assert torch.equal(cache[name], plain[name])

"""The launch plan of the K2/K6/K8/K9/K15 decode-attention kernel
(csrc/decode_attention_async.cu), checked on the CPU: shared memory within
a Hopper block's 227 KB (and one wave of six blocks an SM at the served
shapes), the chunks covering every generated slot and the current token
once, the grid covering every (head, row) once in row groups of at most
16, K6's value items within its consumer threads, and one launch per
wrapper call with the plan's arguments, or a refusal before any launch.
The launch itself is recorded by a stand-in for the kernel library: the
kernel runs only on the card (tests/test_torch_cuda.py).
"""
import ctypes

import pytest
import torch

from capdec_tpu_torch.ops import _build
from capdec_tpu_torch.ops import decode_attention as da

# the served shape: 64 images, 40 prefix slots, GPT-2 124M's 12 x 64 heads,
# 72 cache slots
N, K, D, HD, E = 64, 40, 768, 64, 72
BLOCK_SMEM = 227 * 1024   # shared memory one block may use on an H100
SM_SMEM = 228 * 1024      # shared memory of one SM
BLOCK_RESERVED = 1024     # the SM keeps 1 KB of it for each block
SMS = 132                 # the H100 SXM's SMs
STEPS = (0, 1, 7, 8, 9, 31, 32, 33, 39, 40, 41, 66, E - 1)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("R", [1, 2, 5, 8])
@pytest.mark.parametrize("step", STEPS)
def test_plan_fits_a_block_and_covers_the_slots(itemsize, R, step):
    plan = da.attention_plan(N, R, K, D, HD, step, itemsize)
    assert plan["smem"] <= BLOCK_SMEM
    assert plan["threads"] % 32 == 0 and 64 <= plan["threads"] <= 128
    tile, nchunks, nbuf = plan["tile"], plan["nchunks"], plan["nbuf"]
    slots = step + 1  # the generated slots below step and the current token
    assert (nchunks - 1) * tile < slots <= nchunks * tile
    # a ring of two stages: one lands while the other is consumed
    assert nbuf == 2
    # a chunk's slices about twice the prefix's, unless shrunk to fit
    assert 1 <= tile <= min(slots, 2 * -(-K // R))


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_plan_fits_every_head_dim_and_beam_count(hd, itemsize):
    for R in (1, 8, 16, 17, 24, 32, 33, 48, 64):
        plan = da.attention_plan(N, R, K, 12 * hd, hd, E - 1, itemsize)
        assert plan["smem"] <= BLOCK_SMEM
        assert plan["grid"] == (12, N, -(-R // 16))


@pytest.mark.parametrize("R", [1, 5])
def test_served_plan_is_one_wave(R):
    """bf16 at every step of the served shapes (beam 5, greedy 1): all
    N x 12 blocks fit the H100's SMs at once by shared memory and
    threads (2048 an SM)."""
    for step in range(E):
        plan = da.attention_plan(N, R, K, D, HD, step, 2)
        per_sm = min(SM_SMEM // (plan["smem"] + BLOCK_RESERVED),
                     2048 // plan["threads"])
        assert per_sm * SMS >= N * D // HD, step


@pytest.mark.parametrize("R", [1, 5, 16, 17, 24, 32, 33, 48])
def test_grid_covers_every_head_and_row_once(R):
    """Block (h, n, z) of the plan's grid serves head h of rows
    n*R + 16z .. n*R + min(R, 16z + 16) - 1 (the kernel's blockIdx
    mapping)."""
    gx, gy, gz = da.attention_plan(N, R, K, D, HD, 66, 2)["grid"]
    G = da.ATTN_ROW_GROUP
    served = [(h, n * R + r) for h in range(gx) for n in range(gy)
              for z in range(gz) for r in range(G * z, min(R, G * z + G))]
    assert sorted(served) == [(h, b) for h in range(D // HD)
                              for b in range(N * R)]
    assert gz == -(-R // G)


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
    """The wrappers' kernel route on CPU tensors, into a _Library."""
    lib = _Library()
    monkeypatch.setattr(_build, "run_plain", lambda t: False)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda device: 0)
    return lib


def _inputs(R, dtype, n=2, L=3, hd=HD, offset=0):
    """q/k_new/v_new views of one [B, 3D] row block and caches; `offset`
    values shift the caches' start (a misaligned view)."""
    d = 12 * hd
    q, kn, vn = torch.zeros(n * R, 3 * d, dtype=dtype).split(d, dim=-1)

    def cache(*shape):
        flat = torch.zeros(offset + torch.Size(shape).numel(), dtype=dtype)
        return flat[offset:].view(*shape)

    return (q, kn, vn, cache(L, n, K, d), cache(L, n, K, d),
            cache(n * R, L, E, d), cache(n * R, L, E, d))


WRAPPERS = [
    ("capdec_beam_decode_attention_rowmajor",
     da.beam_decode_attention_rowmajor, dict(e_cap=16)),
    ("capdec_beam_decode_attention_rowmajor",
     da.beam_decode_attention_rowmajor, dict(e_cap=None)),
    ("capdec_beam_decode_attention_chunked",
     da.beam_decode_attention_chunked, dict(chunk=8)),
]


@pytest.mark.parametrize("entry,wrapper,kw", WRAPPERS)
@pytest.mark.parametrize("R", [1, 5])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("step", [0, 33, 66])
def test_one_launch_per_call_with_the_plan(library, entry, wrapper, kw, R,
                                           dtype, step):
    n, L, layer = 2, 3, 1
    args = _inputs(R, dtype, n, L)
    n0 = wrapper.launches
    out = wrapper(*args, step, layer, beams_per_image=R, head_dim=HD, **kw)
    assert wrapper.launches == n0 + 1
    assert len(library.calls) == 1 and library.calls[0][0] == entry
    assert out.shape == (n * R, D) and out.dtype == torch.float32
    got = library.calls[0][1]
    n_gen = min(step, kw.get("e_cap") or E)
    plan = da.attention_plan(n, R, K, D, HD, n_gen, dtype.itemsize)
    # ... N, R, L, K, E, D, hd, layer, n_gen, tile, nbuf, threads, smem,
    # dtype, stream: as the SIGNATURES row and the C entry order them
    assert got[9:] == (n, R, L, K, E, D, HD, layer, n_gen, plan["tile"],
                       plan["nbuf"], plan["threads"], plan["smem"],
                       _build.DTYPE_CODES[dtype], 0)
    sig = _build.SIGNATURES[entry]
    assert len(sig) == len(got)
    assert all(t is ctypes.c_int for t in sig[9:-1])


@pytest.mark.parametrize("wrapper,kw", [
    (da.beam_decode_attention_rowmajor, {}),
    (da.beam_decode_attention_chunked, dict(chunk=8))])
def test_refuses_a_head_dim_or_cache_it_cannot_copy(library, wrapper, kw):
    """head_dim 96 (a head slice that is no power-of-two count of 16-byte
    words), caches or q/k_new/v_new rows that do not start on 16 bytes,
    and no beam per image are refused before any launch; 24 beams launch
    once, in two row groups, and 33 once, in three."""
    hd96 = _inputs(5, torch.bfloat16, hd=96)
    with pytest.raises(ValueError, match="head_dim"):
        wrapper(*hd96, 3, 1, beams_per_image=5, head_dim=96, **kw)
    shifted = _inputs(5, torch.bfloat16, offset=1)
    with pytest.raises(ValueError, match="aligned"):
        wrapper(*shifted, 3, 1, beams_per_image=5, head_dim=HD, **kw)
    # q/k_new/v_new rows one value off 16 bytes (a row stride of 3D + 1)
    qkv = torch.zeros(10, 3 * D + 1, dtype=torch.bfloat16)[:, 1:]
    caches = _inputs(5, torch.bfloat16)[3:]
    with pytest.raises(ValueError, match="aligned"):
        wrapper(*qkv.split(D, dim=-1), *caches, 3, 1, beams_per_image=5,
                head_dim=HD, **kw)
    with pytest.raises(ValueError, match="at least one beam"):
        wrapper(*_inputs(0, torch.bfloat16), 3, 1, beams_per_image=0,
                head_dim=HD, **kw)
    assert library.calls == []
    wrapper(*_inputs(24, torch.bfloat16), 3, 1, beams_per_image=24,
            head_dim=HD, **kw)
    assert len(library.calls) == 1 and library.calls[0][1][10] == 24
    wrapper(*_inputs(33, torch.bfloat16), 3, 1, beams_per_image=33,
            head_dim=HD, **kw)
    assert len(library.calls) == 2 and library.calls[1][1][10] == 33
    assert da.attention_plan(2, 33, K, D, HD, 3, 2)["grid"] == (12, 2, 3)


def test_plan_refuses_what_no_block_holds():
    with pytest.raises(ValueError, match="does not fit"):
        da.attention_plan(N, 32, 2048, 128 * 12, 128, 71, 4)


KINDS = [(2, 1, 2), (2, 1, 1), (4, 1, 4), (4, 1, 1), (2, 2, 2), (4, 4, 4)]


@pytest.mark.parametrize("itemsize,cache_size,prefix_size", KINDS)
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("R", [1, 2, 5, 8, 16, 17, 24, 32, 33])
def test_int8_plan_fits_a_block_and_covers_the_slots(itemsize, cache_size,
                                                     prefix_size, hd, R):
    """K9's plans (an int8 cache under a prefix of q's type or of int8
    levels) and K2's: within a block, every slot in one chunk, a chunk of
    int8 levels starting at twice the slots of one of q's type."""
    rows = min(R, da.ATTN_ROW_GROUP)
    for step in (0, 1, 33, 66, E - 1):
        plan = da.attention_plan(N, R, K, 12 * hd, hd, step, itemsize,
                                 cache_size, prefix_size)
        assert plan["smem"] <= BLOCK_SMEM
        assert plan["smem"] == da._attention_smem(
            R, K, hd, itemsize, plan["tile"], plan["nbuf"],
            plan["threads"], step, cache_size, prefix_size)
        tile, slots = plan["tile"], step + 1
        assert (plan["nchunks"] - 1) * tile < slots <= plan["nchunks"] * tile
        most = 2 * -(-K // rows) * (2 if cache_size < itemsize else 1)
        assert 1 <= tile <= min(slots, most)
        assert plan["grid"] == (12, N, -(-R // da.ATTN_ROW_GROUP))


def test_int8_layout_adds_the_widened_stage_and_the_scales():
    """The int8 layout against the bf16 one at the same tile: the ring
    holds levels (half the bytes), a widened stage of bf16 slices beside
    it, and the scales of the prefix (2 K) and of the rows' slots below
    n_gen (2 R n_gen) in f32."""
    R, tile, n_gen = 5, 16, 66
    bf16 = da._attention_smem(R, K, HD, 2, tile, 2, 128, n_gen)
    q8 = da._attention_smem(R, K, HD, 2, tile, 2, 128, n_gen, 1, 1)
    ring = 2 * max(K, R * tile) * HD * 2
    assert q8 - bf16 == (-ring // 2 + max(K, R * tile) * HD * 2
                         + (2 * K + 2 * R * n_gen) * 4)


@pytest.mark.parametrize("R", [1, 5])
@pytest.mark.parametrize("prefix_size", [2, 1])
def test_served_int8_plans_are_one_wave(R, prefix_size):
    """K9 in bf16 at every step of the served shapes ((b) R = 5 and (e)
    R = 1 with the int8 prefix; the bf16 prefix as well): six blocks an
    SM, so all N x 12 blocks are resident at once; a chunk of one row
    gives the three consumer warps ceil(cnt / 16) units."""
    for step in range(E):
        plan = da.attention_plan(N, R, K, D, HD, step, 2, 1, prefix_size)
        per_sm = min(SM_SMEM // (plan["smem"] + BLOCK_RESERVED),
                     2048 // plan["threads"])
        assert per_sm >= 6 and per_sm * SMS >= N * D // HD, step
    plan = da.attention_plan(N, R, K, D, HD, 66, 2, 1, prefix_size)
    consumers = plan["threads"] // 32 - 1
    assert R * -(-min(plan["tile"], 67) // 16) >= consumers


def _int8_inputs(R, dtype, int8_prefix, n=2, L=3, hd=HD):
    q, kn, vn, pk, pv, _, _ = _inputs(R, dtype, n, L, hd)
    d = 12 * hd
    gk, gv = (torch.zeros(n * R, L, E, d, dtype=torch.int8)
              for _ in range(2))
    gks, gvs = (torch.zeros(n * R, L, 1, E) for _ in range(2))
    pre = {}
    if int8_prefix:
        pk, pv = (torch.zeros(L, n, K, d, dtype=torch.int8)
                  for _ in range(2))
        pre = dict(pks=torch.zeros(L, n, 1, K), pvs=torch.zeros(L, n, 1, K))
    return (q, kn, vn, pk, pv, gk, gv, gks, gvs), pre


@pytest.mark.parametrize("int8_prefix", [False, True])
@pytest.mark.parametrize("R", [1, 5, 24])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("step", [0, 33, 66])
def test_int8_chunked_one_launch_per_call_with_the_plan(library, int8_prefix,
                                                       R, dtype, step):
    """K9: one launch of its C entry with the pointers in the order of its
    SIGNATURES row (the prefix scales null for a prefix of q's type) and
    the plan of an int8 cache."""
    n, L, layer = 2, 3, 1
    args, pre = _int8_inputs(R, dtype, int8_prefix, n, L)
    wrapper = da.beam_decode_attention_chunked_q
    n0 = wrapper.launches
    out = wrapper(*args, step, layer, beams_per_image=R, head_dim=HD,
                  chunk=8, **pre)
    assert wrapper.launches == n0 + 1
    entry = "capdec_beam_decode_attention_chunked_q"
    assert len(library.calls) == 1 and library.calls[0][0] == entry
    assert out.shape == (n * R, D) and out.dtype == torch.float32
    got = library.calls[0][1]
    q, kn, vn, pk, pv, gk, gv, gks, gvs = args
    ptrs = [q, kn, vn, pk, pv, pre.get("pks"), pre.get("pvs"), gk, gv, gks,
            gvs]
    assert got[:3] + got[4:13] == tuple(
        None if t is None else t.data_ptr() for t in ptrs) + (got[12],)
    plan = da.attention_plan(n, R, K, D, HD, step, dtype.itemsize, 1,
                             1 if int8_prefix else dtype.itemsize)
    assert got[13:] == (n, R, L, K, E, D, HD, layer, step, plan["tile"],
                        plan["nbuf"], plan["threads"], plan["smem"],
                        _build.DTYPE_CODES[dtype], 0)
    sig = _build.SIGNATURES[entry]
    assert len(sig) == len(got)
    assert all(t is ctypes.c_void_p for t in sig[4:13])
    assert all(t is ctypes.c_int for t in sig[13:-1])


@pytest.mark.parametrize("R", [1, 5, 24])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("step", [0, 33, 71])
def test_v1_one_launch_per_call_with_the_plan(library, R, dtype, step):
    """K15: one launch of its C entry with K2's arguments for one layer
    (L = 1, layer 0, n_gen = step) and the caches it writes in place."""
    n = 2
    q, kn, vn, pk, pv, gk, gv = _inputs(R, dtype, n, 1)
    pk, pv, gk, gv = pk[0], pv[0], gk[:, 0], gv[:, 0]
    wrapper = da.beam_decode_attention
    n0 = wrapper.launches
    out, rk, rv = wrapper(q, kn, vn, pk, pv, gk, gv, step,
                          beams_per_image=R, head_dim=HD)
    assert wrapper.launches == n0 + 1 and rk is gk and rv is gv
    entry = "capdec_beam_decode_attention"
    assert len(library.calls) == 1 and library.calls[0][0] == entry
    got = library.calls[0][1]
    assert got[6:8] == (gk.data_ptr(), gv.data_ptr())
    plan = da.attention_plan(n, R, K, D, HD, step, dtype.itemsize)
    assert got[9:] == (n, R, 1, K, E, D, HD, 0, step, plan["tile"],
                       plan["nbuf"], plan["threads"], plan["smem"],
                       _build.DTYPE_CODES[dtype], 0)
    assert _build.SIGNATURES[entry] == \
        _build.SIGNATURES["capdec_beam_decode_attention_rowmajor"]
    assert len(_build.SIGNATURES[entry]) == len(got)


@pytest.mark.parametrize("int8_prefix", [False, True])
def test_int8_chunked_refuses_what_it_cannot_copy(library, int8_prefix):
    """K9: head_dim 96, misaligned caches or rows and no beam are refused
    before any launch; 33 beams launch once."""
    kw = dict(chunk=8)
    args, pre = _int8_inputs(5, torch.bfloat16, int8_prefix, hd=96)
    wrapper = da.beam_decode_attention_chunked_q
    with pytest.raises(ValueError, match="head_dim"):
        wrapper(*args, 3, 1, beams_per_image=5, head_dim=96, **kw, **pre)
    args, pre = _int8_inputs(5, torch.bfloat16, int8_prefix)
    gk = torch.zeros(args[5].numel() + 1, dtype=torch.int8)[1:].view(
        args[5].shape)
    with pytest.raises(ValueError, match="aligned"):
        wrapper(*args[:5], gk, *args[6:], 3, 1, beams_per_image=5,
                head_dim=HD, **kw, **pre)
    qkv = torch.zeros(10, 3 * D + 1, dtype=torch.bfloat16)[:, 1:]
    with pytest.raises(ValueError, match="aligned"):
        wrapper(*qkv.split(D, dim=-1), *args[3:], 3, 1, beams_per_image=5,
                head_dim=HD, **kw, **pre)
    args, pre = _int8_inputs(0, torch.bfloat16, int8_prefix, n=1)
    with pytest.raises(ValueError, match="at least one beam"):
        wrapper(*args, 3, 1, beams_per_image=0, head_dim=HD, **kw, **pre)
    assert library.calls == []
    args, pre = _int8_inputs(33, torch.bfloat16, int8_prefix, n=1)
    wrapper(*args, 3, 1, beams_per_image=33, head_dim=HD, **kw, **pre)
    assert len(library.calls) == 1 and library.calls[0][1][14] == 33


def test_v1_refuses_what_it_cannot_copy(library):
    """K15: head_dim 96, misaligned caches or rows and no beam are
    refused before any launch; 33 beams launch once."""
    def v1(R=5, hd=HD, offset=0, qkv=None):
        q, kn, vn, pk, pv, gk, gv = _inputs(R, torch.bfloat16, 2, 1, hd,
                                            offset)
        if qkv is not None:
            q, kn, vn = qkv
        return da.beam_decode_attention(
            q, kn, vn, pk[0], pv[0], gk[:, 0], gv[:, 0], 3,
            beams_per_image=R, head_dim=hd)
    with pytest.raises(ValueError, match="head_dim"):
        v1(hd=96)
    with pytest.raises(ValueError, match="aligned"):
        v1(offset=1)
    qkv = torch.zeros(10, 3 * D + 1, dtype=torch.bfloat16)[:, 1:]
    with pytest.raises(ValueError, match="aligned"):
        v1(qkv=qkv.split(D, dim=-1))
    with pytest.raises(ValueError, match="at least one beam"):
        v1(R=0)
    assert library.calls == []
    v1(R=33)
    assert len(library.calls) == 1 and library.calls[0][1][10] == 33


# K6 (`beam_decode_attention_rowmajor_q`): an int8 cache read in place under
# a prefix of q's type (`inreg`), n_gen = min(step, e_cap)
K6_STEPS = (0, 1, 15, 16, 17, 33, 66, E - 1)


def _k6_plan(R, hd, n_gen, itemsize, n=N):
    return da.attention_plan(n, R, K, 12 * hd, hd, n_gen, itemsize, 1,
                             itemsize, True)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("R", [1, 2, 5, 8, 16, 17, 24, 32, 33])
@pytest.mark.parametrize("e_cap", [16, 72, None])
def test_k6_plan_fits_a_block_and_covers_the_slots(itemsize, hd, R, e_cap):
    """Within a block, the layout's total, every generated slot below
    n_gen and the current token in one chunk, the int8 chunk starting at
    twice the slots of one of q's type, and each consumer thread holding
    at most its kernel's value items (two for hd 128, else one)."""
    rows = min(R, da.ATTN_ROW_GROUP)
    for step in K6_STEPS:
        n_gen = min(step, e_cap or E)
        plan = _k6_plan(R, hd, n_gen, itemsize)
        assert plan["smem"] <= BLOCK_SMEM
        assert plan["smem"] == da._attention_smem(
            R, K, hd, itemsize, plan["tile"], plan["nbuf"], plan["threads"],
            n_gen, 1, itemsize, True)
        tile, slots = plan["tile"], n_gen + 1
        assert (plan["nchunks"] - 1) * tile < slots <= plan["nchunks"] * tile
        assert 1 <= tile <= min(slots, 4 * -(-K // rows))
        assert plan["grid"] == (12, N, -(-R // da.ATTN_ROW_GROUP))
        consumers = plan["threads"] - 32
        j8 = max(1, consumers // (rows * (hd // 16)))
        assert rows * j8 * (hd // 16) <= (2 if hd == 128 else 1) * consumers


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_served_k6_plan_is_one_wave(dtype):
    """The int8 path's K6 (R = 5, head_dim 64) at every n_gen it meets
    under staged growth (e_cap 16 .. 72): six blocks an SM, so all N x 12
    blocks are resident at once, with tile 32 (three chunks at step 66)
    in bf16."""
    for n_gen in range(E):
        plan = _k6_plan(5, HD, n_gen, dtype.itemsize)
        per_sm = min(SM_SMEM // (plan["smem"] + BLOCK_RESERVED),
                     2048 // plan["threads"])
        assert per_sm >= 6 and per_sm * SMS >= N * D // HD, n_gen
    assert _k6_plan(5, HD, 66, 2)["tile"] == 32


def test_k6_layout_reads_int8_stages_in_place():
    """K6's layout against K9's with a bf16 prefix at the same tile: no
    widened stage of bf16 slices, and the generated slots' value sums
    [R][J8][hd] in f32 in its place."""
    R, tile, n_gen = 5, 32, 66
    k9 = da._attention_smem(R, K, HD, 2, tile, 2, 128, n_gen, 1, 2)
    k6 = da._attention_smem(R, K, HD, 2, tile, 2, 128, n_gen, 1, 2, True)
    j8 = 96 // (R * HD // 16)
    assert k6 - k9 == -max(K, R * tile) * HD * 2 + R * j8 * HD * 4


def _k6_inputs(R, dtype, n=2, L=3, hd=HD):
    q, kn, vn, pk, pv, _, _ = _inputs(R, dtype, n, L, hd)
    d = 12 * hd
    gk, gv = (torch.zeros(n * R, L, E, d, dtype=torch.int8)
              for _ in range(2))
    gks, gvs = (torch.zeros(n * R, L, 1, E) for _ in range(2))
    return q, kn, vn, pk, pv, gk, gv, gks, gvs


@pytest.mark.parametrize("R", [1, 5, 24])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("step", [0, 16, 33, 66])
@pytest.mark.parametrize("e_cap", [16, None])
def test_k6_one_launch_per_call_with_the_plan(library, R, dtype, step,
                                              e_cap):
    """K6: one launch of its C entry with the pointers and the plan in the
    order of its SIGNATURES row (no prefix scales: the prefix is q's
    type)."""
    n, L, layer = 2, 3, 1
    args = _k6_inputs(R, dtype, n, L)
    wrapper = da.beam_decode_attention_rowmajor_q
    n0 = wrapper.launches
    out = wrapper(*args, step, layer, beams_per_image=R, head_dim=HD,
                  e_cap=e_cap)
    assert wrapper.launches == n0 + 1
    entry = "capdec_beam_decode_attention_rowmajor_q"
    assert len(library.calls) == 1 and library.calls[0][0] == entry
    assert out.shape == (n * R, D) and out.dtype == torch.float32
    got = library.calls[0][1]
    q, kn, vn, pk, pv, gk, gv, gks, gvs = args
    assert got[:3] == (q.data_ptr(), kn.data_ptr(), vn.data_ptr())
    assert got[3] == q.stride(0)
    assert got[4:10] == tuple(t.data_ptr() for t in (pk, pv, gk, gv, gks,
                                                     gvs))
    n_gen = min(step, e_cap or E)
    plan = _k6_plan(R, HD, n_gen, dtype.itemsize, n)
    assert got[11:] == (n, R, L, K, E, D, HD, layer, n_gen, plan["tile"],
                        plan["nbuf"], plan["threads"], plan["smem"],
                        _build.DTYPE_CODES[dtype], 0)
    sig = _build.SIGNATURES[entry]
    assert len(sig) == len(got)
    assert all(t is ctypes.c_void_p for t in sig[4:11])
    assert sig[3] is ctypes.c_long
    assert all(t is ctypes.c_int for t in sig[11:-1])


def test_k6_refuses_before_any_launch(library):
    """K6: scales of the wrong shape, dtype or layout, misaligned caches or
    rows, head_dim 96, an e_cap out of range, no beam and a cache that is
    not int8 are refused before any launch; 33 beams launch once."""
    wrapper = da.beam_decode_attention_rowmajor_q
    kw = dict(beams_per_image=5, head_dim=HD)
    args = _k6_inputs(5, torch.bfloat16)
    gks = args[7]
    for bad in (gks[:, :, :, :E - 1], gks.double(),
                gks.transpose(0, 1).contiguous().transpose(0, 1)):
        with pytest.raises(ValueError, match="gks/gvs"):
            wrapper(*args[:7], bad, args[8], 3, 1, **kw)
        with pytest.raises(ValueError, match="gks/gvs"):
            wrapper(*args[:8], bad, 3, 1, **kw)
    gk = torch.zeros(args[5].numel() + 1, dtype=torch.int8)[1:].view(
        args[5].shape)
    with pytest.raises(ValueError, match="aligned"):
        wrapper(*args[:5], gk, *args[6:], 3, 1, **kw)
    qkv = torch.zeros(10, 3 * D + 1, dtype=torch.bfloat16)[:, 1:]
    with pytest.raises(ValueError, match="aligned"):
        wrapper(*qkv.split(D, dim=-1), *args[3:], 3, 1, **kw)
    with pytest.raises(ValueError, match="head_dim"):
        wrapper(*_k6_inputs(5, torch.bfloat16, hd=96), 3, 1,
                beams_per_image=5, head_dim=96)
    for e_cap in (0, E + 1):
        with pytest.raises(ValueError, match="e_cap"):
            wrapper(*args, 3, 1, e_cap=e_cap, **kw)
    with pytest.raises(ValueError, match="at least one beam"):
        wrapper(*_k6_inputs(0, torch.bfloat16, n=1), 3, 1,
                beams_per_image=0, head_dim=HD)
    with pytest.raises(ValueError, match="int8"):
        wrapper(*args[:5], args[5].to(torch.bfloat16),
                args[6].to(torch.bfloat16), *args[7:], 3, 1, **kw)
    assert library.calls == []
    wrapper(*_k6_inputs(33, torch.bfloat16, n=1), 3, 1,
            beams_per_image=33, head_dim=HD)
    assert len(library.calls) == 1 and library.calls[0][1][12] == 33


# Short prefixes (ClipCap's MLP mapper serves K 10): the plan widens the
# chunk that twice the prefix's slices would give to a stage of at least
# ATTN_STAGE_DIM_BYTES of each head dimension, within six blocks an SM
SHORT_K = (1, 4, 10, 20)
SHORT_R = (1, 5, 16, 33)
# (itemsize, cache_size, prefix_size, inreg): bf16 and f32 caches (K2, K8,
# K15), K6's int8 cache read in place, K9's int8 cache under a bf16 and
# under an int8 prefix
SHORT_KINDS = [(2, None, None, False), (4, None, None, False),
               (2, 1, 2, True), (2, 1, 2, False), (2, 1, 1, False)]
CHUNK_EDGES = (0, 15, 16, 17, 33, 66, 71)


@pytest.mark.parametrize("kind", SHORT_KINDS)
@pytest.mark.parametrize("K", SHORT_K)
@pytest.mark.parametrize("R", SHORT_R)
@pytest.mark.parametrize("step", CHUNK_EDGES)
def test_short_prefix_plan_meets_the_floor_and_covers_the_slots(kind, K, R,
                                                                step):
    """A widened tile holds the floor's slots (or all G, where fewer) or
    is the largest whose block fits the six-blocks budget, and never fewer
    slots than the prefix's measure; the chunks cover every generated slot
    and the current token once; shared memory within a block's 227 KB and
    equal to the layout's total."""
    itemsize, cache_size, prefix_size, inreg = kind
    plan = da.attention_plan(N, R, K, D, HD, step, *kind)
    csize = cache_size or itemsize
    rows = min(R, da.ATTN_ROW_GROUP)
    G = step + 1
    start = 2 * -(-K // rows) * (2 if csize == 1 else 1)
    tile = plan["tile"]
    assert plan["smem"] <= BLOCK_SMEM
    assert plan["smem"] == da._attention_smem(
        R, K, HD, itemsize, tile, plan["nbuf"], plan["threads"], step,
        cache_size, prefix_size, inreg)
    assert (plan["nchunks"] - 1) * tile < G <= plan["nchunks"] * tile
    assert plan["nbuf"] == 2
    assert plan["widened"] == (rows * start * csize
                               < da.ATTN_STAGE_DIM_BYTES
                               and plan["smem"] <= da.ATTN_SMEM_BUDGETS[0]
                               and tile >= min(G, start + 1))
    if plan["widened"]:
        floor = da._chunk_floor(rows, itemsize, csize, inreg)
        assert rows * floor * csize >= da.ATTN_STAGE_DIM_BYTES
        if itemsize == 2 and not inreg:
            assert floor % da.ATTN_MMA_SLOTS == 0
        assert min(G, start + 1) <= tile <= min(G, floor)
        if tile < min(G, floor):  # the budget stopped it
            assert da._attention_smem(
                R, K, HD, itemsize, tile + 1, 2, plan["threads"], step,
                cache_size, prefix_size, inreg) > da.ATTN_SMEM_BUDGETS[0]
    else:
        assert tile <= min(G, start)


@pytest.mark.parametrize("kind", SHORT_KINDS)
def test_clipcap_served_plan_is_widened_and_keeps_six_blocks(kind):
    """ClipCap's served call (N 512 x R 5, K 10, head_dim 64) in every
    cache kind: widened at every step, six blocks an SM, and at step 66 a
    bf16 stage of the flagship's 10 KB in whole 16-slot units (K2, K8,
    K15), K6's 32 int8 slots and K9's tile cut by the budget."""
    n, K = 512, 10
    for step in range(E):
        plan = da.attention_plan(n, 5, K, D, HD, step, *kind)
        per_sm = min(SM_SMEM // (plan["smem"] + BLOCK_RESERVED),
                     2048 // plan["threads"])
        assert plan["widened"] and per_sm >= 6, step
    tile = da.attention_plan(n, 5, K, D, HD, 66, *kind)["tile"]
    assert tile == {(2, None, None, False): 16, (4, None, None, False): 8,
                    (2, 1, 2, True): 32}.get(kind, 24)


def _parent_plan(N_, R, K_, D_, hd, n_gen, itemsize, cache_size=None,
                 prefix_size=None, inreg=False):
    """The plan before short prefixes were widened: twice the prefix's
    slices a chunk, shrunk into the first budget that holds the block."""
    G = n_gen + 1
    csize = cache_size or itemsize
    rows = min(R, da.ATTN_ROW_GROUP)
    start = 2 * -(-K_ // rows) * (2 if csize == 1 else 1)
    for budget in da.ATTN_SMEM_BUDGETS:
        for tile in range(max(1, min(G, start)), 0, -1):
            smem = da._attention_smem(R, K_, hd, itemsize, tile, 2, 128,
                                      n_gen, cache_size, prefix_size, inreg)
            if smem <= budget:
                return tile, 2, smem


# every cache kind the kernel takes: (itemsize, cache_size, prefix_size,
# inreg)
ALL_KINDS = [(2, None, None, False), (4, None, None, False),
             (2, 1, 2, False), (2, 1, 1, False), (4, 1, 4, False),
             (4, 1, 1, False), (2, 1, 2, True), (4, 1, 4, True)]
# sha-256 of the JSON list of (hd, R, itemsize, cache_size, prefix_size,
# inreg, n_gen, tile, nbuf, smem) (None as -1) of the plans at K 40 before
# short prefixes were widened
K40_PLANS_SHA256 = \
    "63bb159ebd4409e997d4a25aa4c616c8e94addfa248b6f6344129b085d93d2db"


def test_every_k40_plan_is_the_parents():
    """At K 40 (the flagship, greedy, the wide beams, the int8 paths, a
    tp=2 rank's head_dim 64) no plan is widened and every (tile, nbuf,
    smem) at every step, head_dim, beam width and cache kind is the
    frozen table's: the rule before widening names the first mismatch,
    the digest of the whole table freezes its numbers."""
    import hashlib
    import json
    rows = []
    for hd in (32, 64, 128):
        for R in (1, 2, 5, 8, 16, 17, 24, 32, 33):
            for kind in ALL_KINDS:
                for n_gen in range(E):
                    plan = da.attention_plan(N, R, K, 12 * hd, hd, n_gen,
                                             *kind)
                    got = (plan["tile"], plan["nbuf"], plan["smem"])
                    assert not plan["widened"]
                    assert got == _parent_plan(N, R, K, 12 * hd, hd, n_gen,
                                               *kind), (hd, R, kind, n_gen)
                    rows.append((hd, R, *[-1 if k is None else int(k)
                                          for k in kind], n_gen, *got))
    digest = hashlib.sha256(json.dumps(rows).encode()).hexdigest()
    assert digest == K40_PLANS_SHA256


@pytest.mark.parametrize("K,widened", [(10, True), (40, False)])
@pytest.mark.parametrize("entry,wrapper,kw", WRAPPERS)
def test_widened_launches_count_the_widened_plans(library, entry, wrapper,
                                                  kw, K, widened):
    """Each wrapper counts a launch under a widened plan in
    `widened_launches` beside `launches`: at K 10 every call, at K 40
    none; the launch passes the widened plan's tile and shared memory."""
    n, R, L, d = 2, 5, 3, D
    q, kn, vn = torch.zeros(n * R, 3 * d, dtype=torch.bfloat16).split(
        d, dim=-1)
    pk, pv = (torch.zeros(L, n, K, d, dtype=torch.bfloat16)
              for _ in range(2))
    gk, gv = (torch.zeros(n * R, L, E, d, dtype=torch.bfloat16)
              for _ in range(2))
    for step in (0, 16, 66):
        n0, w0 = wrapper.launches, wrapper.widened_launches
        wrapper(q, kn, vn, pk, pv, gk, gv, step, 1, beams_per_image=R,
                head_dim=HD, **kw)
        assert wrapper.launches == n0 + 1
        assert wrapper.widened_launches == w0 + widened
        n_gen = min(step, kw.get("e_cap") or E)
        plan = da.attention_plan(n, R, K, d, HD, n_gen, 2)
        assert plan["widened"] == widened
        assert library.calls[-1][0] == entry
        assert library.calls[-1][1][18:20] == (plan["tile"], plan["nbuf"])
        assert library.calls[-1][1][21] == plan["smem"]


@pytest.mark.parametrize("K,widened", [(10, True), (40, False)])
@pytest.mark.parametrize("kernel", ["K6", "K9", "K9 int8 prefix", "K15"])
def test_widened_launches_of_the_int8_and_v1_wrappers(library, kernel, K,
                                                      widened):
    """K6, K9 (both prefix kinds) and K15 count their widened launches as
    K2 does: every call at K 10, none at K 40."""
    n, R, L = 2, 5, 3
    bf = lambda *s: torch.zeros(*s, dtype=torch.bfloat16)
    i8 = lambda *s: torch.zeros(*s, dtype=torch.int8)
    q, kn, vn = bf(n * R, 3 * D).split(D, dim=-1)
    pk, pv = bf(L, n, K, D), bf(L, n, K, D)
    gks, gvs = torch.zeros(n * R, L, 1, E), torch.zeros(n * R, L, 1, E)
    if kernel == "K6":
        wrapper = da.beam_decode_attention_rowmajor_q
        call = lambda step: wrapper(q, kn, vn, pk, pv, i8(n * R, L, E, D),
                                    i8(n * R, L, E, D), gks, gvs, step, 1,
                                    beams_per_image=R, head_dim=HD)
    elif kernel == "K15":
        wrapper = da.beam_decode_attention
        call = lambda step: wrapper(q, kn, vn, pk[0], pv[0], bf(n * R, E, D),
                                    bf(n * R, E, D), step, beams_per_image=R,
                                    head_dim=HD)
    else:
        wrapper = da.beam_decode_attention_chunked_q
        pre = {}
        if kernel.endswith("prefix"):
            pk, pv = i8(L, n, K, D), i8(L, n, K, D)
            pre = dict(pks=torch.zeros(L, n, 1, K),
                       pvs=torch.zeros(L, n, 1, K))
        call = lambda step: wrapper(q, kn, vn, pk, pv, i8(n * R, L, E, D),
                                    i8(n * R, L, E, D), gks, gvs, step, 1,
                                    beams_per_image=R, head_dim=HD, chunk=8,
                                    **pre)
    for step in (0, 16, 33, 66):
        n0, w0 = wrapper.launches, wrapper.widened_launches
        call(step)
        assert wrapper.launches == n0 + 1
        assert wrapper.widened_launches == w0 + widened

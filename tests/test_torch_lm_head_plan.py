"""The launch plan of the K1 LM-head kernel (csrc/lm_head.cu), checked on
the CPU: shared memory within a Hopper block's 227 KB, the blocks
covering every vocab entry and every row exactly once, one partial per
(row, vocab tile) as the second pass reads them, every plan up to D 832
as it was before the streamed route (a frozen digest), the streamed
route's tiling and its epilogue emulated in plain PyTorch and merged as
the second pass merges, and one launch per
wrapper call with the plan's arguments in the order of the C entry; bad
inputs are refused before any launch. The launch itself is recorded by a
stand-in for the kernel library: the kernel runs only on the card
(tests/test_torch_cuda.py).
"""
import ctypes
import hashlib
import itertools
import json

import pytest
import torch

from capdec_tpu_torch.ops import _build
from capdec_tpu_torch.ops import lm_head

D = 768           # GPT-2 124M's width
BLOCK_SMEM = 227 * 1024   # shared memory one block may use on an H100
SMS = 132                 # the H100 SXM's SMs
BS = [1, 7, 64, 320, 333]
VS = [300, 50257]
RS = [1, 5, 8]
ITEMSIZES = [2, 4]


def _tiles(plan, B, V):
    """(row, vocab entry) ranges each launch unit covers, as the kernel's
    indexing maps them: bf16, persistent block b takes vocab tiles b,
    b + blocks, ... and every 64-row tile of h over each (the row tiles
    alternating between the two consumer warpgroups); streamed,
    persistent block b takes tiles b, b + blocks, ... of the order vocab
    tile x row tiles + row tile; f32, block (x, y) takes row tile x of
    vocab chunk y."""
    tm, tn, parts = plan["tile_m"], plan["tile_n"], plan["partials"]
    units = []
    if plan["route"] == "streamed":
        rows = -(-B // tm)
        for b in range(plan["blocks"]):
            for tile in range(b, rows * parts, plan["blocks"]):
                units.append((b, tile % rows, tile // rows))
    elif plan["route"] == "wgmma":
        rows = -(-B // tm)
        for b in range(plan["blocks"]):
            g = 0  # the block's row tiles so far
            for vt in range(b, parts, plan["blocks"]):
                for t in range(rows):
                    units.append((g % 2, t, vt))
                    g += 1
    else:
        gx, gy = plan["grid"]
        units = [(0, x, y) for x in range(gx) for y in range(gy)]
    return units


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("R", RS)
@pytest.mark.parametrize("V", VS)
@pytest.mark.parametrize("B", BS)
def test_plan_fits_a_block(B, V, R, itemsize):
    plan = lm_head.lm_head_plan(B, V, D, R, itemsize)
    assert plan["smem"] <= BLOCK_SMEM
    assert R <= plan["r_max"] == min(V, plan["tile_n"])
    if plan["route"] == "wgmma":
        assert itemsize == 2 and plan["threads"] == 384
        ks = -(-D // plan["tile_k"])
        # 1 KB of alignment, the whole weight tile, the ring of h slices
        # and the mbarriers, as csrc/lm_head.cu's wgmma_smem lays them out
        assert plan["smem"] == (1024 + ks * plan["tile_n"] * 64 * 2
                                + plan["stages"] * 64 * 64 * 2
                                + (2 * ks + 2 * plan["stages"] + 2) * 8)
        # a slice in the products while the next one lands
        assert 2 <= plan["stages"] <= lm_head.MAX_STAGES
        # at GPT-2's width: 128 vocab entries a block, four ring stages
        assert (plan["tile_n"], plan["stages"]) == (128, 4)
    else:
        assert itemsize == 4 and plan["threads"] == 256
        assert plan["smem"] == 64 * (128 + 4) * 4 <= 48 * 1024


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("R", RS)
@pytest.mark.parametrize("V", VS)
@pytest.mark.parametrize("B", BS)
def test_plan_covers_every_row_and_vocab_entry_once(B, V, R, itemsize):
    """Every (row, vocab entry) pair falls in exactly one launch unit and
    every (row, partial) slot is written exactly once: pass 2 reads
    `partials` slots a row, all of them written."""
    plan = lm_head.lm_head_plan(B, V, D, R, itemsize)
    tm, tn, parts = plan["tile_m"], plan["tile_n"], plan["partials"]
    assert parts == -(-V // tn)
    units = _tiles(plan, B, V)
    covered = sorted((t, vt) for _, t, vt in units)
    assert covered == [(t, vt) for t in range(-(-B // tm))
                       for vt in range(parts)]
    # a row tile's rows: warp w of a warpgroup holds rows 16w + lane / 4
    # and 16w + lane / 4 + 8 (the wgmma accumulator layout)
    rows = sorted(16 * w + lane // 4 + 8 * half for w in range(4)
                  for lane in range(0, 32, 4) for half in range(2))
    assert rows == list(range(tm))
    written = sorted((t * tm + r) * parts + vt for t, vt in covered
                     for r in range(tm) if t * tm + r < B)
    assert written == list(range(B * parts))
    entries = sorted(e for vt in range(parts)
                     for e in range(vt * tn, min(V, vt * tn + tn)))
    assert entries == list(range(V))


@pytest.mark.parametrize("B", BS)
def test_wgmma_plan_balances_the_blocks(B):
    """The bf16 plan runs at most one persistent block an SM (its weight
    tile fills the SM's shared memory), every SM busy at the served V,
    the vocab tiles shared out within one of each other, and the row
    tiles of each block alternating between the two warpgroups."""
    plan = lm_head.lm_head_plan(B, 50257, D, 5, 2, SMS)
    assert plan["grid"] == (plan["blocks"], 1)
    assert plan["blocks"] == SMS
    assert 2 * (plan["smem"] + 1024) > 228 * 1024
    per_block = [len(range(b, plan["partials"], SMS)) for b in range(SMS)]
    assert max(per_block) - min(per_block) <= 1
    # block b's row tiles g = 0, 1, ... go to warpgroup g % 2
    for b in range(SMS):
        g = per_block[b] * -(-B // plan["tile_m"])
        assert abs((g + 1) // 2 - g // 2) <= 1


# Every bf16 and f32 plan up to D 832 over these shapes, as the parent of
# the streamed route planned them: json.dumps of [[B, V, D, R, itemsize,
# plan], ...] with sorted keys, hashed.
FROZEN_BS, FROZEN_DS = BS + [2560], [128, 384, 768, 832]
FROZEN_PLANS_SHA256 = (
    "53e14f87318a0b8372779acf77ba139ff4100a4e3370436c7a43c20fb4e5cdd6")


def test_plans_up_to_d832_are_unchanged():
    """GPT-2's D 768, a tp=2 rank's D 384 and the f32 FMA route keep the
    weight-stationary plans byte for byte."""
    rows = [[B, V, D_, R, it, lm_head.lm_head_plan(B, V, D_, R, it)]
            for B, V, R, it, D_ in itertools.product(
                FROZEN_BS, VS, RS, ITEMSIZES, FROZEN_DS)]
    digest = hashlib.sha256(json.dumps(rows, sort_keys=True).encode())
    assert len(rows) == 288
    assert digest.hexdigest() == FROZEN_PLANS_SHA256


@pytest.mark.parametrize("width,tile_n,stages",
                         [(128, 128, 8), (1024, 256, 4), (1280, 256, 4),
                          (1600, 256, 4)])
def test_wide_models_take_a_narrower_tile(width, tile_n, stages):
    """GPT-2 medium, large and XL widths: a 128-entry weight tile no
    longer fits a block, and the streamed kernel takes them (on the
    H100 it beat the 64-entry weight tile that took them before at D 1024
    and 1280: PERF.md §6)."""
    plan = lm_head.lm_head_plan(320, 50257, width, 5, 2)
    assert (plan["tile_n"], plan["stages"]) == (tile_n, stages)
    assert plan["route"] == ("wgmma" if width <= 832 else "streamed")
    assert plan["smem"] <= BLOCK_SMEM
    assert plan["partials"] == -(-50257 // tile_n)


def test_plan_refuses_what_no_block_holds_and_r_out_of_range():
    # D 2048 (Kimi-VL-A3B's) and every width past 832 take the streamed
    # kernel, which holds no weight tile whole: no width is refused
    for width in (840, 2048, 2240, 7168):
        p = lm_head.lm_head_plan(2560, 163840, width, 5, 2)
        assert (p["route"], p["partials"], p["smem"]) == (
            "streamed", 640, 197696)
    assert lm_head.lm_head_plan(2560, 163840, 832, 5, 2)["route"] == "wgmma"
    for R in (0, 129):
        with pytest.raises(ValueError, match="out of range"):
            lm_head.lm_head_plan(64, 50257, D, R, 2)
    for R in (0, 257):
        with pytest.raises(ValueError, match="out of range"):
            lm_head.lm_head_plan(64, 50257, 2048, R, 2)
    with pytest.raises(ValueError, match="out of range"):
        lm_head.lm_head_plan(64, 3, D, 4, 4)
    with pytest.raises(ValueError, match="out of range"):
        lm_head.lm_head_plan(5, 200, 2048, 201, 2)


STREAMED_DS = [840, 1024, 1280, 1600, 2048, 4096]


@pytest.mark.parametrize("width", STREAMED_DS)
@pytest.mark.parametrize("V", VS + [163840, 163840 - 37])
@pytest.mark.parametrize("B", [1, 5, 128, 513, 2560])
def test_streamed_plan_covers_every_tile_once(B, V, width):
    """Past D 832 the plan names the streamed route: 128 x 256 output
    tiles (640 partials a row at V 163840), a ring of four 48 KB stages
    within a block's shared memory, min(tiles, SMs) persistent blocks;
    every (row tile, vocab tile) falls to exactly one block, every (row,
    partial) slot is written once, and the blocks in flight share vocab
    tiles (the row tiles innermost)."""
    plan = lm_head.lm_head_plan(B, V, width, 5, 2, SMS)
    assert plan["route"] == "streamed"
    assert (plan["tile_m"], plan["tile_n"], plan["tile_k"]) == (128, 256, 64)
    assert plan["smem"] == 1024 + 4 * (128 + 256) * 64 * 2 + 2 * 4 * 8
    assert plan["stages"] == 4 and plan["smem"] <= BLOCK_SMEM
    assert plan["threads"] == 384 and plan["r_max"] == min(V, 256)
    parts = plan["partials"]
    assert parts == -(-V // 256)
    if V == 163840:
        assert parts == 640
    rows = -(-B // 128)
    assert plan["blocks"] == min(rows * parts, SMS)
    assert plan["grid"] == (plan["blocks"], 1)
    units = _tiles(plan, B, V)
    covered = sorted((t, vt) for _, t, vt in units)
    assert covered == [(t, vt) for t in range(rows) for vt in range(parts)]
    # a warpgroup's 64 rows: warp w holds rows 16w + lane / 4 (+ 8)
    written = sorted((t * 128 + 64 * wg + 16 * w + lane // 4 + 8 * half)
                     * parts + vt for t, vt in covered for wg in range(2)
                     for w in range(4) for lane in range(0, 32, 4)
                     for half in range(2)
                     if t * 128 + 64 * wg + 16 * w + lane // 4 + 8 * half
                     < B)
    assert written == list(range(B * parts))
    # the blocks' first tiles lie in the first ceil(blocks / rows) vocab
    # tiles, every row tile of each but the last
    first = {}
    for b, t, vt in units:
        first.setdefault(b, (vt, t))
    assert sorted(first.values()) == [
        (n // rows, n % rows) for n in range(plan["blocks"])]


def _ranks_before(av, ai, bv, bi):
    return av > bv or (av == bv and ai < bi)


def _streamed_partials(logits, V, R, v0):
    """csrc/lm_head.cu streamed_partials in plain PyTorch for one
    256-entry vocab tile at v0 of f32 `logits` [rows, V]: each quad
    lane q holds columns v0 + 8p + 2q + j (p < 32, j < 2); each pair is
    ordered once (head first, the second column only if strictly
    larger); a round takes each lane's first head (lowest p on a tie),
    the first of the four lanes in selection order, and pops the pick
    from its pair. Returns m, l [rows] and the top-R (v, i) [rows, R],
    an index >= V written as INT_MAX."""
    rows = logits.shape[0]
    cols = torch.arange(256)
    tile = torch.full((rows, 256), float("-inf"))
    ok = (v0 + cols) < V
    tile[:, ok] = logits[:, v0 + cols[ok]]
    # [rows, q, p, j]
    pairs = tile.view(rows, 32, 4, 2).permute(0, 2, 1, 3).clone()
    a, b = pairs[..., 0], pairs[..., 1]
    up = b > a
    head, tail = torch.where(up, b, a), torch.where(up, a, b)
    best_v = torch.empty(rows, R)
    best_i = torch.empty(rows, R, dtype=torch.int64)
    m = l = None
    for k in range(R):
        p = torch.argmax(head, dim=2)           # the first max
        hv = head.gather(2, p[..., None])[..., 0]
        hi = (v0 + 8 * p + 2 * torch.arange(4)[None, :]
              + up.gather(2, p[..., None])[..., 0].long())
        for r in range(rows):
            bv, bi = hv[r, 0].item(), hi[r, 0].item()
            for q in range(1, 4):
                if _ranks_before(hv[r, q].item(), hi[r, q].item(), bv, bi):
                    bv, bi = hv[r, q].item(), hi[r, q].item()
            best_v[r, k], best_i[r, k] = bv, bi
        if k == 0:
            m = best_v[:, 0].clone()
            l = torch.exp(tile - m[:, None]).sum(1)
        off = best_i[:, k] - v0
        q_of, p_of = (off >> 1) & 3, off >> 3
        pop = torch.zeros_like(head, dtype=torch.bool)
        pop[torch.arange(rows), q_of, p_of] = True
        head = torch.where(pop, tail, head)
        tail = torch.where(pop, torch.full_like(tail, float("-inf")), tail)
        up = up ^ pop
    best_i = torch.where(best_i < V, best_i,
                         torch.full_like(best_i, 2 ** 31 - 1))
    return m, l, best_v, best_i


def _merge(m, l, v, i, R):
    """lm_head_merge in plain PyTorch: m, l [rows, P], v, i [rows, P, R]
    -> the logsumexp and the first R candidates in selection order, the
    k-th pick taken among positions 0..k of each partial, strictly after
    the previous pick."""
    M = m.max(1).values
    lse = M + torch.log((l * torch.exp(m - M[:, None])).sum(1))
    rows = m.shape[0]
    vals = torch.empty(rows, R)
    idx = torch.empty(rows, R, dtype=torch.int64)
    for r in range(rows):
        pv, pi = float("inf"), -1
        for k in range(R):
            bv, bi = float("-inf"), 2 ** 31 - 1
            for c in range(m.shape[1]):
                for pos in range(k + 1):
                    cv, ci = v[r, c, pos].item(), i[r, c, pos].item()
                    if (_ranks_before(pv, pi, cv, ci)
                            and _ranks_before(cv, ci, bv, bi)):
                        bv, bi = cv, ci
            vals[r, k], idx[r, k] = bv, bi
            pv, pi = bv, bi
    return vals, idx, lse


# Planted copies of the largest row: at tile edges; and within a tile, on
# both columns of one lane's pair (16, 17), on the next lane (18) and on
# the same lane's next pair (24), whose order the pairs, the lane's tree
# and the quad decide
PLANTS = {"edges": (255, 256, 511, 512),
          "lanes": (24, 18, 17, 16, 256 + 24, 256 + 17, 256 + 16, 256 + 2)}


@pytest.mark.parametrize("B,V,R,planted", [
    (5, 300, 5, None), (5, 300, 1, None), (3, 219, 8, None),
    (7, 1000 - 37, 5, "edges"), (4, 1000 - 37, 1, "edges"),
    (2, 600, 30, "edges"), (3, 600, 8, "lanes"), (2, 300, 3, "lanes")])
def test_streamed_partials_merged_equal_the_plain_version(B, V, R, planted):
    """The streamed route's partials, in 256-entry vocab tiles (ragged
    last tiles of 44, 219, 207 and 88 entries), merged as lm_head_merge
    merges them, give lm_head_topk_plain's values, lowest-index ties and
    logsumexp. Operands on a coarse grid make every logit exact in f32
    and tie often; `planted` copies the largest row (PLANTS, and the last
    entry)."""
    g = torch.Generator().manual_seed(B * 1000 + V + R)
    d = 64
    h = torch.randint(0, 5, (B, d), generator=g).float() / 4
    w = torch.randint(-4, 5, (V, d), generator=g).float() / 8
    if planted:
        w[[e for e in PLANTS[planted] + (V - 1,) if e < V]] = 0.5
    logits = h @ w.t()
    parts = -(-V // 256)
    out = [_streamed_partials(logits, V, R, vt * 256) for vt in range(parts)]
    m = torch.stack([o[0] for o in out], 1)
    l = torch.stack([o[1] for o in out], 1)
    v = torch.stack([o[2] for o in out], 1)
    i = torch.stack([o[3] for o in out], 1)
    vals, idx, lse = _merge(m, l, v, i, R)
    pv, pi, pl = lm_head.lm_head_topk_plain(h, w, R)
    assert torch.equal(idx, pi)
    assert torch.equal(vals, pv)
    torch.testing.assert_close(lse, pl, atol=1e-5, rtol=1e-6)


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
    monkeypatch.setattr(_build, "run_plain", lambda t: False)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda device: 0)
    monkeypatch.setattr(_build, "sm_count", lambda device: SMS)
    return lib


def _operands(B, V, d, dtype, offset=0):
    """h [B, d] and w [V, d]; `offset` values shift both starts."""
    def mat(rows):
        flat = torch.zeros(offset + rows * d, dtype=dtype)
        return flat[offset:].view(rows, d)
    return mat(B), mat(V)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,V,R", [(320, 50257, 5), (64, 50257, 1),
                                   (7, 300, 4), (333, 300, 8)])
def test_one_launch_per_call_with_the_plan(library, dtype, B, V, R):
    h, w = _operands(B, V, D, dtype)
    n0 = lm_head.lm_head_topk.launches
    vals, idx, lse = lm_head.lm_head_topk(h, w, R)
    assert lm_head.lm_head_topk.launches == n0 + 1
    assert len(library.calls) == 1
    name, got = library.calls[0]
    assert name == "capdec_lm_head_topk"
    sig = _build.SIGNATURES[name]
    assert len(sig) == len(got)
    assert vals.shape == (B, R) and vals.dtype == torch.float32
    assert idx.shape == (B, R) and idx.dtype == torch.int64
    assert lse.shape == (B,) and lse.dtype == torch.float32
    plan = lm_head.lm_head_plan(B, V, D, R, dtype.itemsize, SMS)
    P = plan["partials"]
    # h, w, B, V, D, R, P, 4 partials, vals, idx, lse, the plan, dtype,
    # stream: as the SIGNATURES row and the C entry order them
    assert got[:7] == (h.data_ptr(), w.data_ptr(), B, V, D, R, P)
    assert got[11:14] == (vals.data_ptr(), idx.data_ptr(), lse.data_ptr())
    assert got[14:] == (plan["tile_n"], plan["stages"], plan["threads"],
                        plan["blocks"], plan["smem"],
                        _build.DTYPE_CODES[dtype], 0)
    assert all(t is ctypes.c_void_p for t in sig[7:14])
    assert all(t is ctypes.c_int for t in sig[14:20])
    # max, sum-exp [B, P] and the top-R values and indices [B, P, R],
    # back to back in 4-byte words
    m, l, v, i = got[7:11]
    assert (l - m, v - l, i - v) == (4 * B * P, 4 * B * P, 4 * B * P * R)


def test_refuses_bad_inputs_before_any_launch(library):
    """A dtype or width mismatch, non-contiguous or misaligned bf16
    operands, a width the TMA rows cannot take, and R outside the plan's
    1..r_max are refused; nothing is launched."""
    h, w = _operands(64, 300, D, torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        lm_head.lm_head_topk(h, w.float(), 1)
    with pytest.raises(ValueError, match="share D"):
        lm_head.lm_head_topk(h, w[:, :D - 8].contiguous(), 1)
    with pytest.raises(ValueError, match="contiguous"):
        lm_head.lm_head_topk(h, w.t().contiguous().t(), 1)
    mh, mw = _operands(64, 300, D, torch.bfloat16, offset=1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        lm_head.lm_head_topk(mh, mw, 1)
    nh, nw = _operands(64, 300, 12, torch.bfloat16)
    with pytest.raises(ValueError, match="D % 8"):
        lm_head.lm_head_topk(nh, nw, 1)
    for R in (0, 129):
        with pytest.raises(ValueError, match="out of range"):
            lm_head.lm_head_topk(h, w, R)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        lm_head.lm_head_topk(h.half(), w.half(), 1)
    assert library.calls == []
    # f32 operands need no alignment: the FMA kernel reads them by value
    fh, fw = _operands(64, 300, D, torch.float32, offset=1)
    lm_head.lm_head_topk(fh, fw, 128)
    assert len(library.calls) == 1

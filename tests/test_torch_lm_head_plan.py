"""The launch plan of the K1 LM-head kernel (csrc/lm_head.cu), checked on
the CPU: shared memory within a Hopper block's 227 KB, the blocks
covering every vocab entry and every row exactly once, one partial per
(row, vocab tile) as the second pass reads them, and one launch per
wrapper call with the plan's arguments in the order of the C entry; bad
inputs are refused before any launch. The launch itself is recorded by a
stand-in for the kernel library: the kernel runs only on the card
(tests/test_torch_cuda.py).
"""
import ctypes

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
    alternating between the two consumer warpgroups); f32, block (x, y)
    takes row tile x of vocab chunk y."""
    tm, tn, parts = plan["tile_m"], plan["tile_n"], plan["partials"]
    units = []
    if plan["route"] == "wgmma":
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


@pytest.mark.parametrize("width,tile_n,stages",
                         [(128, 128, 8), (1024, 64, 8), (1280, 64, 8),
                          (1600, 64, 3)])
def test_wide_models_take_a_narrower_tile(width, tile_n, stages):
    """GPT-2 medium, large and XL widths: a 128-entry weight tile no
    longer fits, the kernel's 64-entry instance does."""
    plan = lm_head.lm_head_plan(320, 50257, width, 5, 2)
    assert (plan["tile_n"], plan["stages"]) == (tile_n, stages)
    assert plan["smem"] <= BLOCK_SMEM
    assert plan["partials"] == -(-50257 // tile_n)


def test_plan_refuses_what_no_block_holds_and_r_out_of_range():
    # D 2048 (Kimi-VL-A3B's) takes a 48-entry tile; 2240 fits none
    assert lm_head.lm_head_plan(64, 50257, 2048, 1, 2)["tile_n"] == 48
    with pytest.raises(ValueError, match="does not fit"):
        lm_head.lm_head_plan(64, 50257, 2240, 1, 2)
    for R in (0, 129):
        with pytest.raises(ValueError, match="out of range"):
            lm_head.lm_head_plan(64, 50257, D, R, 2)
    with pytest.raises(ValueError, match="out of range"):
        lm_head.lm_head_plan(64, 3, D, 4, 4)


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

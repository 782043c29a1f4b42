"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here needs an NVIDIA GPU (sm_90a) and skips without
one; run them there with

    python -m pytest tests/test_torch_cuda.py -q

Tolerances: K1 indices identical and values/lse within 2e-3 (bf16) or
1e-4 (f32) on operands whose sums are exact in f32, at B 1-333, V 257,
300 and 50257, R 1, 5 and 8, with exact ties placed across the edges of
its vocab tiles and of its persistent blocks' ranges; the attention kernels
K2, K6, K8 and K9 within 2e-2 (bf16) or 1e-4 (f32), with NaN in the slots
(K2, K8) or scales (K6, K9) they must not read; K2, K8, K9 and K15 (one
kernel) at R = 1, 2, 5 and 8, in two row groups (R = 17, 24, 32; K9
up to 24) and, with K6, in three and four (R = 33, 48), steps at the ends and at its chunk tile's edges,
at a prefix of 10 slots (N 8 and 512 x R 5) under the widened plans, each
call counted in `widened_launches` (and decode_step's K2 calls widened at
K 10, none at K 40), e_cap below
the step, head_dim 32, 64 and 128, NaN also in the next layer's slot 0
(K9: scale), both K9 prefix kinds, one launch per call; K6 (the
in-register int8 policy of the same kernel) at R = 1, 2, 5, 8, 16, 17 and
32, head_dim 32, 64 and 128, its tile's edges, step 0, e_cap below the
step and step = e_cap, NaN scales at and above n_gen; K3/K4/K7
bit-exact; K13 bit-exact from per-layer views of qkv buffers and from
[L, B, D] tensors at L up to 64, B up to 320 and D up to 1600; K3 and
K14 the same from views and from [B, L, D] tensors at B 1 to 2560, D 384
to 1600; K4 bit-exact on the beam engine's fork sources (R 1, 3, 5 and
33, one image to batch 512, D 384 to 1600, f32, bf16 and int8), on
sources that cross images; K5 bit-exact at D 64, 768, 1024 and 2048, item counts not a
multiple of a block's warps, grids with fewer warps than items, exact
ties (x / s = k + 0.5) and an amax outside [2^-60, 2^100] (the division
route); the gathers K10-K12 and the slot write K14
bit-exact in f32, bf16 and int8, and the gathers refuse an output that
overlaps their input and assert on a source outside the batch; K15 (v1
attention with the fused slot write) within K2's tolerances, its slot
write bit-exact, every other slot untouched, NaN tails unread, and bad
shapes, dtypes and overlapping caches refused; tiny beam searches (bf16/f32 cache, int8 cache with
staged growth, the slot-bounded v3 paths, the non-lane, seq-major, K14,
ancestry and temperature paths, and a beam of 33 on the K2, K6 and K8
routes) and greedy searches (every route) in f32 give identical tokens through the kernels and through the plain versions
(int8: a token share of at least 0.98). The CLIP towers (no hand-written
kernel) at full width, RN50x4 and ViT-B/32, text and image, card against
CPU in f32 within 1e-4 relative L2. The program's spans
(utils/profiling.py) and the profiler's device events on one clock: a
kernel launched inside a span that ends in a synchronise runs inside it.
"""
import pathlib
import subprocess
import sys

import pytest
import torch

from capdec_tpu_torch.decode import beam
from capdec_tpu_torch.models import caption_model, gpt2
from capdec_tpu_torch.ops import cache_reorder, decode_attention, lm_head
from capdec_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

DTYPES = [(torch.bfloat16, 2e-3, 2e-2), (torch.float32, 1e-4, 1e-4)]
REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.fixture
def gen(dev):
    return torch.Generator(device=dev).manual_seed(0)


# K1 at the served shapes (B 320, R 5 and B 64, R 1), one row, ragged row
# tiles (7, 333) and vocabularies whose last tile holds 1, 44 and 81
# entries (257, 300, 50257)
LM_BS, LM_VS = [1, 7, 64, 320, 333], [257, 300, 50257]
LM_CASES = [(B, V, 768, r) for B in LM_BS for V in LM_VS for r in (1, 5)]


@pytest.mark.parametrize("dtype,tol,_", DTYPES)
@pytest.mark.parametrize("B,V,D,r", LM_CASES + [
    (7, 300, 128, 4),
    # GPT-2 medium's and XL's widths: the plan's 64-entry weight tile
    (64, 50257, 1024, 5), (333, 300, 1600, 8)])
def test_lm_head_kernel(dev, gen, dtype, tol, _, B, V, D, r):
    h = (torch.randint(-4, 5, (B, D), generator=gen, device=dev) / 4).to(dtype)
    w = (torch.randint(-4, 5, (V, D), generator=gen, device=dev) / 8).to(dtype)
    n0 = lm_head.lm_head_topk.launches
    kv, ki, kl = lm_head.lm_head_topk(h, w, r)
    pv, pi, pl = lm_head.lm_head_topk_plain(h, w, r)
    assert lm_head.lm_head_topk.launches == n0 + 1
    assert torch.equal(ki, pi)
    torch.testing.assert_close(kv, pv, atol=tol, rtol=0)
    torch.testing.assert_close(kl, pl, atol=tol, rtol=0)
    ties = lm_head.lm_head_topk(torch.zeros_like(h), torch.ones_like(w), r)[1]
    assert torch.equal(ties.cpu(), torch.arange(r).expand(B, r))


def _planted(V):
    """Entries that straddle the edges of the plan's 128-entry vocab tiles
    and of the persistent blocks' ranges (on 132 SMs block b takes tiles
    b, b + 132, b + 264: tile 131 is block 131's, tile 132 block 0's
    second, tile 263 block 131's second and 264 block 0's third), and the
    last entry of the ragged last tile."""
    edges = (127, 128, 255, 256, 131 * 128 - 1, 131 * 128, 132 * 128 - 1,
             132 * 128, 264 * 128 - 1, 264 * 128, V - 1)
    return sorted({e for e in edges if e < V})


@pytest.mark.parametrize("dtype,tol,_", DTYPES)
@pytest.mark.parametrize("V", LM_VS)
@pytest.mark.parametrize("B,r", [(320, 5), (64, 1), (333, 8)])
@pytest.mark.parametrize("first", [0, 3])
def test_lm_head_ties_across_tile_and_block_edges(dev, gen, dtype, tol, _,
                                                  V, B, r, first):
    """Duplicated rows of w give exactly equal logits (h >= 0 on a coarse
    grid, so h . w is largest, and tied, on every copy of the row of 0.5s)
    at the vocab tile and persistent block edges; the lowest indices win,
    in order, as in the plain version. `first` drops the first planted
    copies, so the later edges decide."""
    D = 768
    h = (torch.randint(0, 5, (B, D), generator=gen, device=dev) / 4).to(dtype)
    w = (torch.randint(-4, 5, (V, D), generator=gen, device=dev) / 8).to(dtype)
    planted = _planted(V)[first:]
    w[planted] = 0.5
    kv, ki, kl = lm_head.lm_head_topk(h, w, r)
    pv, pi, pl = lm_head.lm_head_topk_plain(h, w, r)
    assert torch.equal(ki, pi)
    n = min(r, len(planted))
    assert torch.equal(ki[:, :n].cpu(),
                       torch.tensor(planted[:n]).expand(B, n))
    torch.testing.assert_close(kv, pv, atol=tol, rtol=0)
    torch.testing.assert_close(kl, pl, atol=tol, rtol=0)


# K2/K8/K9/K15 (8 images, K = 40 prefix slots, E = 72): for each R, the
# steps at the ends, at the edges of the plan's chunk (tile = 2 ceil(40 /
# rows), twice that for K9's int8 cache: cache_size 1) and the served
# paths' last step (66)
def _async_steps(R, cache_size=None, inreg=False):
    tile = decode_attention.attention_plan(8, R, 40, 768, 64, 71, 2,
                                           cache_size, None, inreg)["tile"]
    return sorted({s for s in (0, 1, tile - 1, tile, tile + 1, 66, 71)
                   if 0 <= s < 72})


# R 17-32: two row groups of at most 16 rows
ASYNC_CASES = [(R, s) for R in (1, 2, 5, 8, 17, 24, 32)
               for s in _async_steps(R)]


def _async_inputs(gen, dev, dtype, N, R, hd, step, L=3, K=40, E=72):
    """Inputs of K2/K8 at layer 1 of L with NaN in every slot at or above
    `step` and in slot 0 of the next layer (the bytes after layer 1's
    slot E - 1): no copy may reach them."""
    D = 12 * hd
    B = N * R
    r = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)
    q, kn, vn = r(B, 3 * D).split(D, dim=-1)
    pk, pv, gk, gv = r(L, N, K, D), r(L, N, K, D), r(B, L, E, D), r(B, L, E, D)
    for g in (gk, gv):
        g[:, :, step:] = float("nan")
        g[:, 2, 0] = float("nan")
    return q, kn, vn, pk, pv, gk, gv, step, 1


@pytest.mark.parametrize("dtype,_,tol", DTYPES)
@pytest.mark.parametrize("R,step,e_cap", [(R, s, 72) for R, s in ASYNC_CASES]
                         + [(R, s, c) for R in (1, 5)
                            for s, c in ((0, 16), (17, 16), (33, 32),
                                         (66, 16))])
def test_decode_attention_kernel(dev, gen, dtype, _, tol, R, step, e_cap):
    args = _async_inputs(gen, dev, dtype, 8, R, 64, step)
    kw = dict(beams_per_image=R, head_dim=64, e_cap=e_cap)
    n0 = decode_attention.beam_decode_attention_rowmajor.launches
    out = decode_attention.beam_decode_attention_rowmajor(*args, **kw)
    assert decode_attention.beam_decode_attention_rowmajor.launches == n0 + 1
    ref = decode_attention.beam_decode_attention_rowmajor_plain(*args, **kw)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,_,tol", DTYPES)
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("R", [1, 8, 16, 24, 32])
@pytest.mark.parametrize("step", [33, 71])
def test_async_attention_kernel_head_dims(dev, gen, dtype, _, tol, hd, R,
                                          step):
    """K2 and K8 at every head_dim they take (a head slice of 4 to 32
    16-byte words), with two tensor-core row tiles (R = 16) and two row
    groups (R = 24, 32)."""
    args = _async_inputs(gen, dev, dtype, 4, R, hd, step)
    for fn, plain, kw in (
            (decode_attention.beam_decode_attention_rowmajor,
             decode_attention.beam_decode_attention_rowmajor_plain, {}),
            (decode_attention.beam_decode_attention_chunked,
             decode_attention.beam_decode_attention_chunked_plain,
             dict(chunk=8))):
        kw.update(beams_per_image=R, head_dim=hd)
        out, ref = fn(*args, **kw), plain(*args, **kw)
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out, ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cache_kernels_bit_exact(dev, gen, dtype):
    B, L, E, D, R = 40, 3, 24, 768, 5
    r = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)
    k, v, nk, nv = r(B, L, E, D), r(B, L, E, D), r(B, L, D), r(B, L, D)
    a = cache_reorder.write_gen_slot_chunk(k.clone(), v.clone(), nk, nv, 9)
    b = cache_reorder.write_gen_slot_chunk_plain(k.clone(), v.clone(), nk,
                                                 nv, 9)
    assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
    # lanes 0 and 2 of each image keep their beam; the others copy them
    src = torch.arange(B, device=dev).reshape(-1, R)
    src[:, 1], src[:, 3], src[:, 4] = src[:, 0], src[:, 2], src[:, 0]
    src = src.reshape(-1)
    a = cache_reorder.copy_forked_rows_bounded(k.clone(), v.clone(), src, 13)
    b = cache_reorder.copy_forked_rows_bounded_plain(k.clone(), v.clone(),
                                                     src, 13)
    assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
    assert torch.equal(a["k"][:, :, 13:], k[:, :, 13:])


# K5 at the served width, at D 64, 1024 and 2048 (its limit; 4 and 8
# units a lane), and with 2 B L items not a multiple of a block's 4 warps
# (42, 1998, 3330); `blocks`: a grid of fewer warps than items, each warp
# looping over items (3 blocks: 12 warps over 42 items; 5: 20 over 3330)
QUANT_SHAPES = [(40, 3, 768, None), (7, 3, 64, None), (33, 3, 2048, None),
                (333, 3, 1024, None), (333, 5, 768, None),
                (333, 5, 2048, None), (7, 3, 64, 3), (333, 5, 768, 5)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("step", [0, 7, 8, 66])
@pytest.mark.parametrize("B,L,D,blocks", QUANT_SHAPES)
def test_quantising_slot_write_kernel_bit_exact(dev, gen, monkeypatch,
                                                dtype, step, B, L, D, blocks):
    if blocks:
        plan = cache_reorder.quant_write_plan
        monkeypatch.setattr(cache_reorder, "quant_write_plan",
                            lambda *a: dict(plan(*a), blocks=blocks))
    E = 72
    k, v = (torch.randint(-127, 128, (B, L, E, D), generator=gen,
                          device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(B, L, 1, E, generator=gen, device=dev)
              for _ in range(2))
    nk, nv = (torch.randn(B, L, D, generator=gen, device=dev).to(dtype)
              for _ in range(2))
    nk[0, 1] = 0  # a zero row takes scale 1
    nk[1, 1] *= 1e-30  # amax below 2^-60 and above 2^100: the division
    nk[2, 2] *= 1e35
    m = min(D, 128) - 1  # x / s = k + .5 under amax 127
    nv[1, 0, :m] = torch.arange(-(m // 2), m - m // 2, device=dev) + 0.5
    nv[1, 0, m:] = 127
    n0 = cache_reorder.write_gen_slot_chunk_q.launches
    a = cache_reorder.write_gen_slot_chunk_q(k.clone(), v.clone(), ks.clone(),
                                             vs.clone(), nk, nv, step)
    b = cache_reorder.write_gen_slot_chunk_q_plain(
        k.clone(), v.clone(), ks.clone(), vs.clone(), nk, nv, step)
    assert cache_reorder.write_gen_slot_chunk_q.launches == n0 + 1
    for name in ("k", "v", "ks", "vs"):
        assert torch.equal(a[name], b[name]), name
    other = torch.arange(E, device=dev) != step
    assert torch.equal(a["k"][:, :, other], k[:, :, other])
    assert torch.equal(a["v"][:, :, other], v[:, :, other])
    assert torch.equal(a["ks"][..., other], ks[..., other])
    assert torch.equal(a["vs"][..., other], vs[..., other])


# K6 (8 images, K = 40, E = 72, layer 1 of 3): for each R (two row groups
# from 17), the steps at the ends and at its chunk tile's edges under e_cap
# 72; at R 1 and 5 also step 0, e_cap below the step and step = e_cap
K6_CASES = ([(R, s, 72) for R in (1, 5, 16, 17, 32)
             for s in _async_steps(R, 1, inreg=True)]
            + [(R, s, c) for R in (1, 5)
               for s, c in ((0, 16), (1, 16), (16, 16), (17, 16), (17, 72),
                            (32, 32), (66, 72))])


@pytest.mark.parametrize("dtype,_,tol", DTYPES)
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("R,step,e_cap", K6_CASES)
def test_int8_decode_attention_kernel(dev, gen, dtype, _, tol, hd, R, step,
                                      e_cap):
    """K6 within the attention kernels' tolerances, NaN scales at and
    above n_gen = min(step, e_cap) and in the next layer's slot 0, one
    launch per call."""
    N, L, K, E, D = 8, 3, 40, 72, 12 * hd
    B = N * R
    r = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)
    q, kn, vn = r(B, 3 * D).split(D, dim=-1)
    pk, pv = r(L, N, K, D), r(L, N, K, D)
    gk, gv = (torch.randint(-127, 128, (B, L, E, D), generator=gen,
                            device=dev, dtype=torch.int8) for _ in range(2))
    gks, gvs = (torch.rand(B, L, 1, E, generator=gen, device=dev) * 3 / 127
                for _ in range(2))
    for s in (gks, gvs):
        s[..., min(step, e_cap):] = float("nan")
        s[:, 2, 0, 0] = float("nan")
    args = (q, kn, vn, pk, pv, gk, gv, gks, gvs, step, 1)
    kw = dict(beams_per_image=R, head_dim=hd, e_cap=e_cap)
    n0 = decode_attention.beam_decode_attention_rowmajor_q.launches
    out = decode_attention.beam_decode_attention_rowmajor_q(*args, **kw)
    assert decode_attention.beam_decode_attention_rowmajor_q.launches == n0 + 1
    ref = decode_attention.beam_decode_attention_rowmajor_q_plain(*args, **kw)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_whole_row_fork_copy_kernel_bit_exact(dev, gen, dtype):
    B, L, E, D, R = 40, 3, 24, 768, 5
    k, v = (torch.randint(-127, 128, (B, L, E, D), generator=gen,
                          device=dev).to(dtype) for _ in range(2))
    src = torch.arange(B, device=dev).reshape(-1, R)
    src[:, 1], src[:, 3], src[:, 4] = src[:, 0], src[:, 2], src[:, 0]
    src = src.reshape(-1)
    a = cache_reorder.copy_forked_rows(k.clone(), v.clone(), src)
    b = cache_reorder.copy_forked_rows_plain(k.clone(), v.clone(), src)
    assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
    kept = src == torch.arange(B, device=dev)
    assert torch.equal(a["k"][kept], k[kept])
    assert torch.equal(a["k"][~kept], k[src[~kept]])


@pytest.mark.parametrize("int8", [False, True])
def test_beam_search_kernels_match_plain_path(dev, gen, int8):
    cfg = caption_model.CaptionModelConfig(
        prefix_length=5, clip_length=5, prefix_size=32, num_layers=2,
        gpt2=gpt2.GPT2Config(vocab_size=300, n_positions=64, n_embd=128,
                             n_layer=2, n_head=2))
    model = caption_model.init_params(cfg, gen, device=dev)
    prefix = torch.randn(3, 5, 128, generator=gen, device=dev)
    bc = beam.BeamConfig(beam_size=4, entry_length=20, stop_token=-1,
                         kv_cache_int8=int8)
    a = beam.beam_search(model.gpt, cfg.gpt2, prefix, bc)
    b = beam.beam_search(model.gpt, cfg.gpt2, prefix, bc.plain())
    if int8:
        # a level that rounds the other way may move a near-tie: the
        # tokens must agree almost everywhere, not necessarily exactly
        assert torch.isfinite(a[2]).all()
        assert (a[0] == b[0]).float().mean() >= 0.98
        return
    for name, x, y in zip(("tokens", "lengths", "scores", "order"), a, b):
        if name == "scores":
            torch.testing.assert_close(x, y, atol=1e-4, rtol=0)
        else:
            assert torch.equal(x, y), name


@pytest.mark.parametrize("dtype,_,tol", DTYPES)
@pytest.mark.parametrize("R,step", ASYNC_CASES + [(5, 17), (1, 17)])
def test_chunked_decode_attention_kernel(dev, gen, dtype, _, tol, R, step):
    args = _async_inputs(gen, dev, dtype, 8, R, 64, step)
    kw = dict(beams_per_image=R, head_dim=64, chunk=8)
    n0 = decode_attention.beam_decode_attention_chunked.launches
    out = decode_attention.beam_decode_attention_chunked(*args, **kw)
    ref = decode_attention.beam_decode_attention_chunked_plain(*args, **kw)
    assert decode_attention.beam_decode_attention_chunked.launches == n0 + 1
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=tol, rtol=tol)


def _int8_inputs(gen, dev, dtype, N, R, hd, step, int8_prefix, L=3, K=40,
                 E=72):
    """K9's inputs at layer 1 of L: int8 levels, NaN scales at and above
    `step` and in slot 0 of the next layer (the scales after layer 1's
    slot E - 1): no copy may reach them."""
    D, B = 12 * hd, N * R
    r = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)
    lev = lambda *s: torch.randint(-127, 128, s, generator=gen, device=dev,
                                   dtype=torch.int8)
    sc = lambda *s: torch.rand(*s, generator=gen, device=dev) * 3 / 127
    q, kn, vn = r(B, 3 * D).split(D, dim=-1)
    pk, pv = r(L, N, K, D), r(L, N, K, D)
    pre = {}
    if int8_prefix:
        pk, pv = lev(L, N, K, D), lev(L, N, K, D)
        pre = dict(pks=sc(L, N, 1, K), pvs=sc(L, N, 1, K))
    gk, gv = lev(B, L, E, D), lev(B, L, E, D)
    gks, gvs = sc(B, L, 1, E), sc(B, L, 1, E)
    for s in (gks, gvs):
        s[..., step:] = float("nan")
        s[:, 2, 0, 0] = float("nan")
    return (q, kn, vn, pk, pv, gk, gv, gks, gvs, step, 1), pre


INT8_CASES = sorted({(R, s) for R in (1, 2, 5, 8, 16, 24)
                     for s in _async_steps(R, 1)}
                    | {(R, s) for R in (1, 5) for s in (1, 17, 66)})


@pytest.mark.parametrize("dtype,_,tol", DTYPES)
@pytest.mark.parametrize("int8_prefix", [False, True])
@pytest.mark.parametrize("R,step", INT8_CASES)
def test_chunked_int8_decode_attention_kernel(dev, gen, dtype, _, tol,
                                              int8_prefix, R, step):
    args, pre = _int8_inputs(gen, dev, dtype, 8, R, 64, step, int8_prefix)
    kw = dict(beams_per_image=R, head_dim=64, chunk=8, **pre)
    n0 = decode_attention.beam_decode_attention_chunked_q.launches
    out = decode_attention.beam_decode_attention_chunked_q(*args, **kw)
    assert decode_attention.beam_decode_attention_chunked_q.launches == n0 + 1
    ref = decode_attention.beam_decode_attention_chunked_q_plain(*args, **kw)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,_,tol", DTYPES)
@pytest.mark.parametrize("int8_prefix", [False, True])
@pytest.mark.parametrize("hd", [32, 128])
@pytest.mark.parametrize("R", [1, 5, 16, 24])
@pytest.mark.parametrize("step", [33, 71])
def test_chunked_int8_kernel_head_dims(dev, gen, dtype, _, tol, int8_prefix,
                                       hd, R, step):
    """K9 at the other head_dims (an int8 head slice of 2 or 8 16-byte
    words)."""
    args, pre = _int8_inputs(gen, dev, dtype, 4, R, hd, step, int8_prefix)
    kw = dict(beams_per_image=R, head_dim=hd, chunk=8, **pre)
    out = decode_attention.beam_decode_attention_chunked_q(*args, **kw)
    ref = decode_attention.beam_decode_attention_chunked_q_plain(*args, **kw)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=tol, rtol=tol)


# K13 at the limits of its plan: L up to 64 layers, B up to 320 rows, D
# up to GPT-2 XL's 1600 (bf16 rows of 1, 2, 4 and 8 words a lane; f32 rows
# of 2 passes), E 16; and the shape this test had first
SEQ_CASES = [(L, B, 16, D) for L in (1, 12, 48, 64) for B in (1, 7, 64, 320)
             for D in (64, 768, 1024, 1600)] + [(3, 40, 24, 768)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("L,B,E,D", SEQ_CASES)
def test_seqmajor_slot_write_kernel_bit_exact(dev, gen, dtype, L, B, E, D):
    """K13 from per-layer views (the k and v thirds of [B, 3D] qkv
    buffers) and from [L, B, D] tensors: bit-identical to the plain
    version at steps 0, 7, 8, 9 and E-1, every other slot and the sources
    untouched, one launch a call."""
    r = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)
    k, v, qkv = r(L, B, E, D), r(L, B, E, D), r(L, B, 3 * D)
    held = qkv.clone()
    views = ([t[:, D:2 * D] for t in qkv], [t[:, 2 * D:] for t in qkv])
    stacked = (qkv[:, :, D:2 * D].contiguous(), qkv[:, :, 2 * D:].contiguous())
    for step in (0, 7, 8, 9, E - 1):
        for nk, nv in (views, stacked):
            n0 = cache_reorder.write_gen_slot_chunk_seqmajor.launches
            a = cache_reorder.write_gen_slot_chunk_seqmajor(
                k.clone(), v.clone(), nk, nv, step)
            b = cache_reorder.write_gen_slot_chunk_seqmajor_plain(
                k.clone(), v.clone(), nk, nv, step)
            assert cache_reorder.write_gen_slot_chunk_seqmajor.launches == \
                n0 + 1
            assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
            other = torch.arange(E, device=dev) != step
            assert torch.equal(a["k"][:, :, other], k[:, :, other])
            assert torch.equal(a["v"][:, :, other], v[:, :, other])
            del a, b
    assert torch.equal(qkv, held)


@pytest.mark.parametrize("B", LM_BS)
def test_lm_head_kernel_top1(dev, gen, B):
    """Greedy's R = 1 over GPT-2's vocabulary, both dtypes: the argmax
    (the lowest index among equal maxima) and its value and lse."""
    h = (torch.randint(-4, 5, (B, 768), generator=gen, device=dev) / 4)
    w = (torch.randint(-4, 5, (50257, 768), generator=gen, device=dev) / 8)
    for dtype, tol, _ in DTYPES:
        kv, ki, kl = lm_head.lm_head_topk(h.to(dtype), w.to(dtype), 1)
        pv, pi, pl = lm_head.lm_head_topk_plain(h.to(dtype), w.to(dtype), 1)
        assert torch.equal(ki, pi)
        torch.testing.assert_close(kv, pv, atol=tol, rtol=0)
        torch.testing.assert_close(kl, pl, atol=tol, rtol=0)


def _tiny(dev, gen):
    cfg = caption_model.CaptionModelConfig(
        prefix_length=5, clip_length=5, prefix_size=32, num_layers=2,
        gpt2=gpt2.GPT2Config(vocab_size=300, n_positions=64, n_embd=128,
                             n_layer=2, n_head=2))
    model = caption_model.init_params(cfg, gen, device=dev)
    return cfg, model, torch.randn(3, 5, 128, generator=gen, device=dev)


@pytest.mark.parametrize("int8", [False, True])
def test_v3_beam_search_kernels_match_plain_path(dev, gen, int8):
    cfg, model, prefix = _tiny(dev, gen)
    bc = beam.BeamConfig(beam_size=4, entry_length=20, stop_token=-1,
                         fused_slot_chunks=8, kv_cache_int8=int8)
    a = beam.beam_search(model.gpt, cfg.gpt2, prefix, bc)
    b = beam.beam_search(model.gpt, cfg.gpt2, prefix, bc.plain())
    if int8:  # a level that rounds the other way may move a near-tie
        assert torch.isfinite(a[2]).all()
        assert (a[0] == b[0]).float().mean() >= 0.98
        return
    for name, x, y in zip(("tokens", "lengths", "scores", "order"), a, b):
        if name == "scores":
            torch.testing.assert_close(x, y, atol=1e-4, rtol=0)
        else:
            assert torch.equal(x, y), name


@pytest.mark.parametrize("knobs", [
    {}, dict(chunk_slot_write=True), dict(fused_attention=True),
    dict(fused_attention=True, fused_slot_chunks=8),
    dict(fused_attention=True, fused_slot_chunks=8, kv_cache_int8=True)])
def test_greedy_kernels_match_plain_path(dev, gen, knobs):
    from capdec_tpu_torch.decode import topp
    cfg, model, prefix = _tiny(dev, gen)
    tc = topp.ToppConfig(entry_length=20, stop_token=-1, extra_stop_token=-1,
                         **knobs)
    a = topp.greedy_topp_search(model.gpt, cfg.gpt2, prefix, tc)
    b = topp.greedy_topp_search(model.gpt, cfg.gpt2, prefix, tc.plain())
    if knobs.get("kv_cache_int8"):
        assert (a[0] == b[0]).float().mean() >= 0.98
        return
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


MOVABLE = [torch.float32, torch.bfloat16, torch.int8]


def _rand_cache(gen, dev, dtype, *shape):
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)
    return torch.randn(*shape, generator=gen, device=dev).to(dtype)


# B = 41 (odd); several rows read one source, some sources are read by none
GATHER_SRC = [(7 * b + 3) % 41 if b % 3 else 5 for b in range(41)]


# K3/K14 (the row-major twin of K13's kernel): L up to 48, B from one
# image (5) to batch 512 (2560) and odd counts, D 384 (a tp=2 rank), 768
# and 1600, E 16 (B 2560: E 8)
ROW_CASES = [(L, B, 16, D) for L in (1, 12, 48) for B in (1, 5, 7, 320)
             for D in (384, 768, 1600)] + [(12, 2560, 8, 768),
                                           (12, 2560, 8, 384)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("L,B,E,D", ROW_CASES)
def test_rowmajor_slot_write_kernel_bit_exact(dev, gen, dtype, L, B, E, D):
    """K3 and K14 from per-layer views (the k and v thirds of [B, 3D] qkv
    buffers) and from [B, L, D] tensors: bit-identical to the plain
    version at steps 0, 7 and E-1, every other slot and the sources
    untouched, one launch a call, each on its own count."""
    if B * L * D > 2560 * 12 * 768 // 2 and dtype == torch.float32:
        pytest.skip("f32 at batch 512 repeats the bf16 case at twice the "
                    "memory")
    r = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)
    k, v, qkv = r(B, L, E, D), r(B, L, E, D), r(L, B, 3 * D)
    held = qkv.clone()
    views = ([t[:, D:2 * D] for t in qkv], [t[:, 2 * D:] for t in qkv])
    stacked = tuple(torch.stack(s, dim=1) for s in views)
    for fn in (cache_reorder.write_gen_slot_chunk,
               cache_reorder.write_gen_slot):
        for step in (0, 7, E - 1):
            for nk, nv in (views, stacked):
                n0 = fn.launches
                a = fn(k.clone(), v.clone(), nk, nv, step)
                b = cache_reorder.write_gen_slot_chunk_plain(
                    k.clone(), v.clone(), nk, nv, step)
                assert fn.launches == n0 + 1
                assert torch.equal(a["k"], b["k"]) and \
                    torch.equal(a["v"], b["v"])
                other = torch.arange(E, device=dev) != step
                assert torch.equal(a["k"][:, :, other], k[:, :, other])
                assert torch.equal(a["v"][:, :, other], v[:, :, other])
                del a, b
    assert torch.equal(qkv, held)


def _engine_src(gen, N, R, dev):
    """Fork sources as the beam engine makes them: ranked winners' source
    lanes, given lanes by beam._assign_lanes, as flat rows."""
    winners = torch.randint(0, R, (N, R), generator=gen, device=dev)
    lanes = beam._assign_lanes(winners, R)
    base = torch.arange(N, device=dev)[:, None] * R
    return (base + beam._to_lane(winners, lanes)).reshape(-1)


def _spread_src(gen, B, dev):
    """Fork sources that keep the lane invariant across the whole batch."""
    keep = torch.randperm(B, generator=gen, device=dev)[:max(1, B // 2)]
    pick = torch.randint(len(keep), (B,), generator=gen, device=dev)
    src = keep[pick]
    src[keep] = keep
    return src


# K4: (images N, beams R, D) from one image to batch 512 and beams of 33,
# at D 384 (a tp=2 rank) and 768, and the live slots below `count`
FORK_CASES = [(1, 5, 768), (3, 1, 768), (64, 5, 768), (64, 5, 384),
              (512, 5, 768), (4, 33, 768), (7, 3, 1600)]


@pytest.mark.parametrize("dtype", MOVABLE)
@pytest.mark.parametrize("N,R,D", FORK_CASES)
@pytest.mark.parametrize("count", [1, 13, 66])
def test_fork_copy_kernel_bit_exact(dev, gen, dtype, N, R, D, count):
    """K4 bit-identical to its plain version on the engine's fork sources
    and on sources that cross images; rows that keep their lane and slots
    at or above count untouched; one launch a call."""
    B, L, E = N * R, 12, 72
    if B * D > 2560 * 768 // 2 and dtype == torch.float32:
        pytest.skip("f32 at batch 512 repeats the bf16 case at twice the "
                    "memory")
    k, v = (_rand_cache(gen, dev, dtype, B, L, E, D) for _ in range(2))
    fn = cache_reorder.copy_forked_rows_bounded
    for src in (_engine_src(gen, N, R, dev), _spread_src(gen, B, dev)):
        forked = src != torch.arange(B, device=dev)
        n0 = fn.launches
        a = fn(k.clone(), v.clone(), src, count)
        b = cache_reorder.copy_forked_rows_bounded_plain(k.clone(), v.clone(),
                                                         src, count)
        assert fn.launches == n0 + 1
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
        assert torch.equal(a["k"][~forked], k[~forked])
        assert torch.equal(a["v"][:, :, count:], v[:, :, count:])
        del a, b


@pytest.mark.parametrize("dtype", MOVABLE)
def test_gather_kernels_bit_exact(dev, gen, dtype):
    L, B, E, D = 3, len(GATHER_SRC), 40, 768
    src = torch.tensor(GATHER_SRC, device=dev)
    k, v = (_rand_cache(gen, dev, dtype, B, L, E, D) for _ in range(2))
    n0 = cache_reorder.reorder_rows_leading.launches
    a = cache_reorder.reorder_rows_leading(k, v, src)
    b = cache_reorder.reorder_rows_leading_plain(k, v, src)
    assert cache_reorder.reorder_rows_leading.launches == n0 + 1
    assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
    assert torch.equal(a["k"], k[src])
    k, v = (_rand_cache(gen, dev, dtype, L, B, E, D) for _ in range(2))
    n0 = cache_reorder.reorder_cache_rows.launches
    a = cache_reorder.reorder_cache_rows(k, v, src)
    b = cache_reorder.reorder_cache_rows_plain(k, v, src)
    assert cache_reorder.reorder_cache_rows.launches == n0 + 1
    assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
    assert torch.equal(a["v"], v[:, src])
    for count in (0, 1, 16, 17, 33, 40):
        fill = _rand_cache(gen, dev, dtype, 2, L, B, E, D)
        n0 = cache_reorder.reorder_cache_rows_bounded.launches
        a = cache_reorder.reorder_cache_rows_bounded(
            k, v, src, count, out_k=fill[0].clone(), out_v=fill[1].clone())
        b = cache_reorder.reorder_cache_rows_bounded_plain(
            k, v, src, count, out_k=fill[0].clone(), out_v=fill[1].clone())
        assert cache_reorder.reorder_cache_rows_bounded.launches == \
            n0 + (count > 0)
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
        assert torch.equal(a["k"][:, :, count:], fill[0][:, :, count:])


@pytest.mark.parametrize("gather,args", [
    (cache_reorder.reorder_rows_leading, ()),
    (cache_reorder.reorder_cache_rows, ()),
    (cache_reorder.reorder_cache_rows_bounded, (5,))])
def test_gather_kernels_refuse_an_overlapping_output(dev, gen, gather, args):
    k, v = (_rand_cache(gen, dev, torch.bfloat16, 6, 6, 8, 128)
            for _ in range(2))
    src = torch.tensor([1, 1, 0, 5, 4, 4], device=dev)
    n0 = gather.launches
    for out_k, out_v in ((k, torch.empty_like(v)), (torch.empty_like(k), v),
                         (k[1:], torch.empty_like(v))):
        with pytest.raises(ValueError, match="overlap|match"):
            gather(k, v, src, *args, out_k=out_k, out_v=out_v)
    both = torch.empty(2, *k.shape, dtype=k.dtype, device=dev)
    with pytest.raises(ValueError, match="overlap"):
        gather(k, v, src, *args, out_k=both[0], out_v=both[0])
    assert gather.launches == n0
    gather(k, v, src, *args, out_k=both[0], out_v=both[1])
    assert gather.launches == n0 + 1


@pytest.mark.parametrize("dtype", MOVABLE)
@pytest.mark.parametrize("step", [0, 9, 10, 23])
def test_single_slot_write_kernel_bit_exact(dev, gen, dtype, step):
    B, L, E, D = 41, 3, 24, 768
    k, v = (_rand_cache(gen, dev, dtype, B, L, E, D) for _ in range(2))
    nk, nv = (_rand_cache(gen, dev, dtype, B, L, D) for _ in range(2))
    n0 = cache_reorder.write_gen_slot.launches
    a = cache_reorder.write_gen_slot(k.clone(), v.clone(), nk, nv, step)
    b = cache_reorder.write_gen_slot_plain(k.clone(), v.clone(), nk, nv, step)
    assert cache_reorder.write_gen_slot.launches == n0 + 1
    assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
    other = torch.arange(E, device=dev) != step
    assert torch.equal(a["v"][:, :, other], v[:, :, other])


@pytest.mark.parametrize("knobs", [
    dict(lane_beams=False), dict(lane_beams=False, fused_slot_chunks=8),
    dict(rowmajor_cache=False), dict(rowmajor_cache=False, lane_beams=False),
    dict(chunk_slot_write=False, pallas_slot_write=True),
    dict(ancestry=True), dict(ancestry=True, rowmajor_cache=False),
    dict(temperature=0.7)])
def test_new_beam_paths_kernels_match_plain_path(dev, gen, knobs):
    cfg, model, prefix = _tiny(dev, gen)
    bc = beam.BeamConfig(beam_size=4, entry_length=20, stop_token=-1,
                         **knobs)
    a = beam.beam_search(model.gpt, cfg.gpt2, prefix, bc)
    b = beam.beam_search(model.gpt, cfg.gpt2, prefix, bc.plain())
    for name, x, y in zip(("tokens", "lengths", "scores", "order"), a, b):
        if name == "scores":
            torch.testing.assert_close(x, y, atol=1e-4, rtol=0)
        else:
            assert torch.equal(x, y), name


@pytest.mark.parametrize("gather,shape", [
    ("reorder_rows_leading", (6, 2, 8, 128)),
    ("reorder_cache_rows", (2, 6, 8, 128))])
def test_gather_kernels_assert_on_a_source_outside_the_batch(dev, gather,
                                                             shape):
    """A source outside [0, B) trips the kernel's device-side assert, as
    index_select's does on the card (in a process of its own: the assert
    ends the process's CUDA context)."""
    code = (
        "import torch\n"
        "from capdec_tpu_torch.ops import cache_reorder as cr\n"
        f"k = torch.zeros({shape}, device='cuda', dtype=torch.bfloat16)\n"
        "src = torch.tensor([0, 1, 2, 3, 4, 6], device='cuda')\n"
        f"cr.{gather}(k, k.clone(), src)\n"
        "torch.cuda.synchronize()\n")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert run.returncode != 0
    assert "device-side assert" in run.stderr, run.stderr[-2000:]


V1_CASES = sorted({(5, 0), (5, 17), (5, 66), (5, 71), (1, 30), (24, 5)}
                  | {(R, s) for R in (1, 5, 24) for s in _async_steps(R)})


@pytest.mark.parametrize("dtype,_,tol", DTYPES)
@pytest.mark.parametrize("R,step,hd", [(R, s, 64) for R, s in V1_CASES]
                         + [(R, s, hd) for hd in (32, 128) for R in (1, 5, 24)
                            for s in (33, 71)])
def test_v1_attention_kernel(dev, gen, dtype, _, tol, R, step, hd):
    """K15 against its plain version: the same output, slot `step` of the
    caches equal to k_new/v_new bit for bit, every other slot untouched,
    NaN in the slots above `step` never read."""
    N, K, E, D = 8, 40, 72, 12 * hd
    B = N * R
    r = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)
    q, kn, vn = r(B, 3 * D).split(D, dim=-1)
    pk, pv, gk0, gv0 = r(N, K, D), r(N, K, D), r(B, E, D), r(B, E, D)
    gk0[:, step + 1:] = float("nan")
    gv0[:, step + 1:] = float("nan")
    kw = dict(beams_per_image=R, head_dim=hd)
    n0 = decode_attention.beam_decode_attention.launches
    gk, gv = gk0.clone(), gv0.clone()
    out, gk2, gv2 = decode_attention.beam_decode_attention(
        q, kn, vn, pk, pv, gk, gv, step, **kw)
    assert gk2 is gk and gv2 is gv
    assert decode_attention.beam_decode_attention.launches == n0 + 1
    ref, rk, rv = decode_attention.beam_decode_attention_plain(
        q, kn, vn, pk, pv, gk0.clone(), gv0.clone(), step, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=tol, rtol=tol)
    assert torch.equal(gk[:, step], kn) and torch.equal(gv[:, step], vn)
    other = torch.arange(E, device=dev) != step
    # NaN != NaN: compare the bits of the untouched slots
    for a, b in ((gk, gk0), (gv, gv0), (rk, gk0)):
        assert torch.equal(a[:, other].view(torch.int16 if dtype ==
                                              torch.bfloat16 else torch.int32),
                           b[:, other].view(torch.int16 if dtype ==
                                            torch.bfloat16 else torch.int32))


def test_v1_attention_kernel_refuses_bad_arguments(dev, gen):
    N, R, K, E, D = 2, 5, 8, 16, 256
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    q, kn, vn = r(N * R, D), r(N * R, D), r(N * R, D)
    pk, pv, gk, gv = r(N, K, D), r(N, K, D), r(N * R, E, D), r(N * R, E, D)
    kw = dict(beams_per_image=R, head_dim=64)
    v1 = decode_attention.beam_decode_attention
    n0 = v1.launches
    with pytest.raises(ValueError, match="step"):
        v1(q, kn, vn, pk, pv, gk, gv, E, **kw)
    with pytest.raises(ValueError, match="dtype"):
        v1(q, kn, vn, pk, pv, gk.bfloat16(), gv.bfloat16(), 3, **kw)
    with pytest.raises(ValueError, match="shape"):
        v1(q, kn, vn, pk, pv, gk[:-1], gv[:-1], 3, **kw)
    with pytest.raises(ValueError, match="gk/gv"):
        v1(q, kn, vn, pk, pv, gk[:, None], gv[:, None], 3, **kw)
    with pytest.raises(ValueError, match="overlap"):
        v1(q, kn, vn, pk, pv, gk, gk, 3, **kw)
    with pytest.raises(ValueError, match="overlap"):
        v1(gk[:, 0], gk[:, 1], gk[:, 2], pk, pv, gk, gv, 3, **kw)
    assert v1.launches == n0


# R > 32: three and four row groups of 16, the last one partial at R 33
WIDE_R = [33, 48]


@pytest.mark.parametrize("dtype,_,tol", DTYPES)
@pytest.mark.parametrize("R", WIDE_R)
@pytest.mark.parametrize("step", [0, 33, 71])
@pytest.mark.parametrize("kernel", ["K2", "K6", "K8", "K9", "K9 int8 prefix",
                                    "K15"])
def test_attention_kernels_beyond_32_beams(dev, gen, dtype, _, tol, R, step,
                                           kernel):
    """K2, K6, K8, K9 (both prefix kinds) and K15 at more than 32 beams per
    image, against their plain versions, one launch per call."""
    da = decode_attention
    kw = dict(beams_per_image=R, head_dim=64)
    if kernel in ("K2", "K8", "K15"):
        args = _async_inputs(gen, dev, dtype, 2, R, 64, step)
        if kernel == "K15":
            q, kn, vn, pk, pv, gk, gv, _, _ = args
            args = (q, kn, vn, pk[1], pv[1], gk[:, 1].contiguous(),
                    gv[:, 1].contiguous(), step)
        fn, plain, more = {
            "K2": (da.beam_decode_attention_rowmajor,
                   da.beam_decode_attention_rowmajor_plain, {}),
            "K8": (da.beam_decode_attention_chunked,
                   da.beam_decode_attention_chunked_plain, dict(chunk=8)),
            "K15": (da.beam_decode_attention, da.beam_decode_attention_plain,
                    {})}[kernel]
    elif kernel == "K6":
        args, _pre = _int8_inputs(gen, dev, dtype, 2, R, 64, step, False)
        fn, plain, more = (da.beam_decode_attention_rowmajor_q,
                           da.beam_decode_attention_rowmajor_q_plain, {})
    else:
        args, more = _int8_inputs(gen, dev, dtype, 2, R, 64, step,
                                  kernel.endswith("prefix"))
        more = dict(chunk=8, **more)
        fn, plain = (da.beam_decode_attention_chunked_q,
                     da.beam_decode_attention_chunked_q_plain)
    n0 = fn.launches
    if kernel == "K15":
        out = fn(*args[:5], args[5].clone(), args[6].clone(), step, **kw)[0]
        ref = plain(*args[:5], args[5].clone(), args[6].clone(), step,
                    **kw)[0]
    else:
        out = fn(*args, **kw, **more)
        ref = plain(*args, **kw, **more)
    assert fn.launches == n0 + 1
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=tol, rtol=tol)


# K 10 (ClipCap's MLP prefix) at R 5: each kernel's widened plan (tile 16
# for K2/K8/K15 in bf16, 8 in f32, 32 for K6, 24 for K9), at its chunk's
# edges; N 512 is ClipCap's served batch
SHORT_KERNELS = ["K2", "K6", "K8", "K9", "K9 int8 prefix", "K15"]


def _short_steps(N, dtype, kernel):
    cache = None if kernel in ("K2", "K8", "K15") else 1
    prefix = 1 if kernel.endswith("prefix") else None
    tile = decode_attention.attention_plan(
        N, 5, 10, 768, 64, 71, dtype.itemsize, cache, prefix,
        kernel == "K6")["tile"]
    return sorted({s for s in (0, 1, tile - 1, tile, tile + 1, 2 * tile,
                               2 * tile + 1, 33, 66, 71) if 0 <= s < 72})


@pytest.mark.parametrize("dtype,_,tol", DTYPES)
@pytest.mark.parametrize("N", [8, 512])
@pytest.mark.parametrize("kernel", SHORT_KERNELS)
def test_attention_kernels_at_a_short_prefix(dev, gen, dtype, _, tol, N,
                                             kernel):
    """K2, K6, K8, K9 (both prefix kinds) and K15 at a prefix of 10 slots,
    R 5, under their widened plans: against their plain versions at the
    plan's chunk edges, NaN in the slots (K2, K8, K15) or scales (K6, K9)
    they must not read, one widened launch per call; K15's slot write bit
    for bit, every other slot untouched."""
    da, R, K = decode_attention, 5, 10
    kw = dict(beams_per_image=R, head_dim=64)
    for step in _short_steps(N, dtype, kernel):
        more = {}
        if kernel in ("K2", "K8", "K15"):
            args = _async_inputs(gen, dev, dtype, N, R, 64, step, K=K)
            fn, plain, more = {
                "K2": (da.beam_decode_attention_rowmajor,
                       da.beam_decode_attention_rowmajor_plain, {}),
                "K8": (da.beam_decode_attention_chunked,
                       da.beam_decode_attention_chunked_plain,
                       dict(chunk=8)),
                "K15": (da.beam_decode_attention,
                        da.beam_decode_attention_plain, {})}[kernel]
        else:
            args, more = _int8_inputs(gen, dev, dtype, N, R, 64, step,
                                      kernel.endswith("prefix"), K=K)
            if kernel == "K6":
                fn, plain = (da.beam_decode_attention_rowmajor_q,
                             da.beam_decode_attention_rowmajor_q_plain)
            else:
                more = dict(chunk=8, **more)
                fn, plain = (da.beam_decode_attention_chunked_q,
                             da.beam_decode_attention_chunked_q_plain)
        n0, w0 = fn.launches, fn.widened_launches
        if kernel == "K15":
            q, kn, vn, pk, pv, gk, gv, _, _ = args
            gk0, gv0 = gk[:, 1].contiguous(), gv[:, 1].contiguous()
            wk, wv = gk0.clone(), gv0.clone()
            out = fn(q, kn, vn, pk[1], pv[1], wk, wv, step, **kw)[0]
            ref, rk, rv = plain(q, kn, vn, pk[1], pv[1], gk0.clone(),
                                gv0.clone(), step, **kw)
            torch.cuda.synchronize()
            assert torch.equal(wk[:, step], kn) and \
                torch.equal(wv[:, step], vn)
            other = torch.arange(72, device=dev) != step
            bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
            for a, b in ((wk, gk0), (wv, gv0), (rk, gk0)):
                assert torch.equal(a[:, other].view(bits),
                                   b[:, other].view(bits))
        else:
            out = fn(*args, **kw, **more)
            ref = plain(*args, **kw, **more)
        assert fn.launches == n0 + 1 and fn.widened_launches == w0 + 1
        assert torch.isfinite(out).all(), step
        torch.testing.assert_close(out, ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("K,widened", [(10, True), (40, False)])
def test_decode_step_takes_the_widened_plan_at_a_short_prefix(dev, gen, K,
                                                              widened):
    """decode_step at N 512 x R 5 in bf16 (GPT-2 124M's widths, two
    layers): at ClipCap's prefix of 10 every K2 launch runs a widened
    plan, at the flagship's 40 none does."""
    cfg = gpt2.GPT2Config(vocab_size=1000, n_layer=2,
                          compute_dtype=torch.bfloat16)
    model = beam.cast_params_for_decode(gpt2.init_params(
        gpt2.GPT2LMHeadModel(cfg, device=dev), cfg, gen), cfg)
    N, R, E = 512, 5, 72
    _, pc = gpt2.prefill(model, cfg, torch.randn(N, K, cfg.n_embd,
                                                 generator=gen, device=dev))
    cache = gpt2.init_gen_cache_rowmajor(cfg, N * R, E, device=dev)
    tok = model.transformer.wte.weight[torch.randint(
        0, cfg.vocab_size, (N * R,), generator=gen, device=dev)]
    k2 = decode_attention.beam_decode_attention_rowmajor
    for step in (0, 16, 33, 66):
        n0, w0 = k2.launches, k2.widened_launches
        gpt2.decode_step(model, cfg, tok, pc, cache, step, e_cap=E)
        assert k2.launches == n0 + cfg.n_layer
        assert k2.widened_launches == w0 + widened * cfg.n_layer


@pytest.mark.parametrize("knobs", [{}, dict(kv_cache_int8=True),
                                   dict(fused_slot_chunks=8)])
def test_beam_search_beyond_32_beams_matches_plain_path(dev, gen, knobs):
    """A beam of 33 through the fused routes (K2, K6 or K8) in f32 gives
    the plain path's tokens (int8: a share of at least 0.98)."""
    cfg, model, prefix = _tiny(dev, gen)
    bc = beam.BeamConfig(beam_size=33, entry_length=20, stop_token=-1,
                         **knobs)
    assert beam.resolve_config(bc).fused_attention
    a = beam.beam_search(model.gpt, cfg.gpt2, prefix, bc)
    b = beam.beam_search(model.gpt, cfg.gpt2, prefix, bc.plain())
    if knobs.get("kv_cache_int8"):
        assert torch.isfinite(a[2]).all()
        assert (a[0] == b[0]).float().mean() >= 0.98
        return
    for name, x, y in zip(("tokens", "lengths", "scores", "order"), a, b):
        if name == "scores":
            torch.testing.assert_close(x, y, atol=1e-4, rtol=0)
        else:
            assert torch.equal(x, y), name


@pytest.mark.parametrize("tower", ["text", "image"])
@pytest.mark.parametrize("name", ["RN50x4", "ViT-B/32"])
def test_clip_towers_full_width_card_matches_cpu(dev, name, tower):
    """Each CLIP tower at full width (random weights from seed 0), f32
    with TF32 off, on the card against the CPU: within 1e-4 relative L2."""
    from capdec_tpu_torch.models import clip
    from capdec_tpu_torch.utils.torch_setup import setup_torch
    setup_torch()
    cfg = clip.MODEL_CONFIGS[name]
    cpu = clip.build_model(cfg, torch.Generator().manual_seed(0))
    card = clip.CLIP(cfg, dev).eval()
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(1)
    if tower == "text":
        x = torch.randint(1, cfg.text.vocab_size - 1, (2, 77), generator=g)
        x[:, 20] = cfg.text.vocab_size - 1  # EOT
    else:
        R = cfg.vision.image_resolution
        x = torch.randn(2, R, R, 3, generator=g)
    encode = f"encode_{tower}"
    want = getattr(cpu, encode)(x).double()
    got = getattr(card, encode)(x.to(dev)).cpu().double()
    assert torch.isfinite(got).all()
    assert float((got - want).norm() / want.norm()) <= 1e-4


def test_kernel_runs_inside_the_span_that_issued_and_synchronised_it(dev):
    a = torch.randn(2048, 2048, device=dev)
    torch.cuda.synchronize()
    profiling.clear()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            with profiling.span("issue"):
                (a @ a).relu_()
                torch.cuda.synchronize()
        sp, = profiling.spans()
    finally:
        profiling.clear()
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert len(kernels) >= 2
    for e in kernels:
        assert sp.start_ns <= e.start_ns() <= e.end_ns() <= sp.end_ns, \
            e.name()

"""The MLA-MoE decoder's kernels on the card (csrc/mla_attention.cu,
csrc/moe.cu, csrc/rmsnorm.cu, K1 at D 2048 in csrc/lm_head.cu, K3/K4 on a
cache of one tensor in csrc/cache_reorder.cu, and the grouped expert
products through `torch._grouped_mm`), each against its plain version.
Every test needs an NVIDIA GPU (sm_90a) and skips without one; run them
there with

    python -m pytest tests/test_torch_mla_moe_cuda.py -q

Tolerances (bf16 operands; "scale" is the largest magnitude of the plain
output):
  * K16: within 2 % of the scale. The kernel rounds the softmax's
    numerators to bf16 (2^-9 relative, each chunk's against its running
    max) before the value product, the plain version keeps them in f32;
    both sum in f32 in other orders.
  * mla_prep, residual_rmsnorm, swiglu: at most one bf16 unit in the last
    place (the f32 math is the plain version's; rsqrtf and expf may
    differ in their last bit), the residual x bit-exact.
  * route: the same experts, weights within 1e-6 relative (expf).
  * dispatch: the same offsets and per-expert row sets; every pair's row
    holds its token.
  * combine: within 1e-5 of the scale (the sum's order).
  * the grouped products against the per-expert loop: within 1 % of the
    scale (both products sum in f32 and round to bf16, in other tilings).
  * K1 at D 2048: the top-R values and the logsumexp within 1e-4 of the
    plain f32 values' scale, the indices equal wherever the plain values
    are apart by more than that.
  * K3/K4 on the latent cache: bit-exact (they move bytes).
"""
import pytest
import torch

from capdec_tpu_torch.ops import cache_reorder as cr
from capdec_tpu_torch.ops import lm_head, mla_attention as ma, moe, rmsnorm

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def bf(shape, dev, scale=1.0, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(
        torch.bfloat16)


def within(got, want, frac):
    torch.cuda.synchronize()
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= frac * scale, (err, scale)


def ulp1(got, want):
    """At most one bf16 unit in the last place apart."""
    a, b = got.view(torch.int16).long(), want.view(torch.int16).long()
    a = torch.where(a < 0, -(a & 0x7FFF), a)
    b = torch.where(b < 0, -(b & 0x7FFF), b)
    assert (a - b).abs().max().item() <= 1


@pytest.mark.parametrize("N,K,step", [(512, 40, 0), (512, 40, 33),
                                      (512, 40, 66), (512, 40, 71),
                                      (1, 40, 66), (1, 40, 0), (3, 10, 30)])
def test_k16_matches_plain(dev, N, K, step):
    R, L, E, layer = 5, 2, 72, 1
    B = N * R
    q = bf((B, 16 * 192), dev, 1.0, 1)
    q_lat = bf((16, B, 512), dev, 1.0, 2)
    lat_new = bf((B, 576), dev, 1.0, 3)
    prefix = bf((L, N, K, 576), dev, 1.0, 4)
    gen = bf((B, L, E, 576), dev, 1.0, 5)
    q_pe = q.view(B, 16, 192)[..., 128:]
    kw = dict(beams_per_image=R, scale=ma.softmax_scale(192))
    got = ma.mla_decode_attention(q_lat, q_pe, lat_new, prefix, gen, step,
                                  layer, **kw)
    want = ma.mla_decode_attention_plain(q_lat, q_pe, lat_new, prefix, gen,
                                         step, layer, **kw)
    within(got, want, 0.02)


def test_k16_refuses(dev):
    q_lat = bf((8, 5, 512), dev)      # 8 heads: the kernel takes 16
    q_pe = bf((5, 8, 64), dev)
    with pytest.raises(ValueError):
        ma.mla_decode_attention(q_lat, q_pe, bf((5, 576), dev),
                                bf((1, 1, 40, 576), dev),
                                bf((5, 1, 72, 576), dev), 40, 0,
                                beams_per_image=5, scale=0.1)


def test_mla_prep_matches_plain(dev):
    B = 2560
    q = bf((B, 16 * 192), dev, 2.0, 1)
    kv = bf((B, 576), dev, 2.0, 2)
    w = torch.rand(512, device=dev) + 0.5
    cos, sin = ma.rope_tables(256, 64, 800000.0, dev)
    q2 = q.clone()
    got = ma.mla_prep(q, kv, w, cos[77], sin[77], 1e-6, 192)
    want = ma.mla_prep_plain(q2, kv, w, cos[77], sin[77], 1e-6, 192)
    ulp1(got, want)
    ulp1(q, q2)


def test_residual_rmsnorm_matches_plain(dev):
    B, D = 2560, 2048
    x = torch.randn(B, D, device=dev) * 3
    y = bf((B, D), dev, 1.0, 1)
    w = torch.rand(D, device=dev) + 0.5
    for assign in (False, True):
        x1, x2 = x.clone(), x.clone()
        got = rmsnorm.residual_rmsnorm(x1, y, w, 1e-5, torch.bfloat16, assign)
        want = rmsnorm.residual_rmsnorm_plain(x2, y.float(), w, 1e-5,
                                              torch.bfloat16, assign)
        torch.cuda.synchronize()
        assert torch.equal(x1, x2)
        ulp1(got, want)


def test_route_dispatch_combine_match_plain(dev):
    T, E, k, D = 2560, 64, 6, 2048
    logits = torch.randn(T, E, device=dev)
    bias = torch.randn(E, device=dev) * 0.1
    idx, w = moe.route(logits, bias, k, True, 2.446)
    idx_p, w_p = moe.route_plain(logits, bias, k, True, 2.446)
    s, o = idx.sort(-1)
    s_p, o_p = idx_p.sort(-1)
    assert torch.equal(s, s_p)
    torch.testing.assert_close(w.gather(-1, o), w_p.gather(-1, o_p),
                               rtol=1e-6, atol=0)
    counter = torch.zeros(E, dtype=torch.int32, device=dev)
    offs, pos, token_of = moe.dispatch(idx, E, counter)
    offs_p, pos_p, tok_p = moe.dispatch_plain(idx, E)
    assert torch.equal(offs, offs_p)
    assert torch.equal(counter, torch.diff(offs, prepend=offs[:1] * 0))
    flat = torch.arange(T * k, device=dev)
    assert torch.equal(token_of[pos.long()].long(), flat // k)
    assert torch.equal(torch.sort(pos).values.long(), flat)
    y = bf((T * k, D), dev, 1.0, 3)
    x1 = torch.randn(T, D, device=dev)
    x2 = x1.clone()
    moe.combine(x1, y, pos, w)
    moe.combine_plain(x2, y, pos, w)
    within(x1, x2, 1e-5)


def test_swiglu_matches_plain(dev):
    gu = bf((3000, 2816), dev, 2.0, 1)
    g, u = gu[:, :1408], gu[:, 1408:]
    ulp1(moe.swiglu(g, u), moe.swiglu_plain(g, u))


def test_grouped_products_match_loop(dev):
    E, D, I, M = 64, 2048, 1408, 15360
    g = torch.Generator(device=dev).manual_seed(0)
    counts = torch.multinomial(torch.ones(E, device=dev), M, True,
                               generator=g).bincount(minlength=E)
    counts[3] = 0                         # an expert no row chose
    offs = counts.cumsum(0).to(torch.int32)
    x = bf((int(offs[-1]), D), dev, 1.0, 1)
    wgu = bf((E, 2 * I, D), dev, 0.03, 2)
    wd = bf((E, D, I), dev, 0.03, 3)
    got = moe.expert_products(x, wgu, wd, offs)
    want = moe.expert_products_plain(x, wgu, wd, offs)
    within(got, want, 0.01)


@pytest.mark.parametrize("B", [2560, 5])
def test_k1_d2048_matches_plain(dev, B):
    V, D, R = 163840, 2048, 5
    h = bf((B, D), dev, 1.0, 1)
    w = bf((V, D), dev, 0.03, 2)
    assert lm_head.lm_head_plan(B, V, D, R, 2)["tile_n"] == 48
    vals, idx, lse = lm_head.lm_head_topk(h, w, R)
    pv, pi, pl = lm_head.lm_head_topk_plain(h, w, R)
    torch.cuda.synchronize()
    tol = 1e-4 * pv.abs().max().item()
    assert (vals - pv).abs().max().item() <= tol
    assert (lse - pl).abs().max().item() <= tol
    apart = torch.ones_like(pv, dtype=torch.bool)
    apart[:, 1:] &= (pv[:, :-1] - pv[:, 1:]) > tol
    apart[:, :-1] &= (pv[:, :-1] - pv[:, 1:]) > tol
    assert torch.equal(idx[apart], pi[apart])


@pytest.mark.parametrize("B,step", [(2560, 33), (5, 66)])
def test_k3_k4_on_the_latent(dev, B, step):
    L, E = 27, 72
    c1 = bf((B, L, E, 576), dev, 1.0, 1)
    c2 = c1.clone()
    new = bf((L, B, 576), dev, 1.0, 2)
    cr.write_gen_slot_chunk(c1, None, new.unbind(0), None, step)
    cr.write_gen_slot_chunk_plain(c2, None, new.unbind(0), None, step)
    torch.cuda.synchronize()
    assert torch.equal(c1, c2)
    g = torch.Generator(device=dev).manual_seed(3)
    src = torch.arange(B, device=dev)
    fork = torch.randperm(B, generator=g, device=dev)[:B // 3]
    keep = torch.ones(B, dtype=torch.bool, device=dev)
    keep[fork] = False
    sources = src[keep]
    src[fork] = sources[torch.randint(len(sources), (len(fork),),
                                      generator=g, device=dev)]
    cr.copy_forked_rows_bounded(c1, None, src, step + 1)
    cr.copy_forked_rows_bounded_plain(c2, None, src, step + 1)
    torch.cuda.synchronize()
    assert torch.equal(c1, c2)

"""The MLA-MoE decoder (capdec_tpu_torch/models/mla_moe.py) against the
benchmark's plain float32 reference (benchmark/reference/mla_moe.py) on
seeded random weights at a small size, on the CPU, in float32 with the
plain versions of every op: hidden 64, 3 layers (one dense, two with 8
routed experts top-2 and one shared), 4 heads, kv_lora 32, qk_nope 16,
qk_rope 8, v_head 16, vocab 256, behind a 2-layer TransformerMapper.

Tolerances: logits within 2e-5 of their scale (the largest magnitude).
Both sides compute the same f32 math in other orders (the port's
absorbed attention multiplies q_nope by W_UK before the latent, the
reference expands k_nope first; the experts' rows are summed in other
orders), so they differ by f32 rounding, about 1e-6 of the scale here;
a dropped rope part, a skipped slot write or a wrong expert moves them
by a tenth or more.

Also the decoder's interface (models/decoders.py): GPT-2's beam search
issues the same sequence of operations as before it (2373 ATen ops at a
tiny size, counted on the parent tree of this interface); the paths the
MLA-MoE decoder does not take raise; and the plans of K16, K1 at D 2048
and K3/K4 on a cache of one tensor.
"""
import hashlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import weights  # noqa: E402
from benchmark.decoders import mla_moe as dec  # noqa: E402
from benchmark.reference import mla_moe as ref  # noqa: E402
from capdec_tpu_torch import serve as serve_lib  # noqa: E402
from capdec_tpu_torch.decode import beam, topp  # noqa: E402
from capdec_tpu_torch.models import caption_model, decoders, gpt2, mla_moe  # noqa: E402
from capdec_tpu_torch.ops import cache_reorder as cr  # noqa: E402
from capdec_tpu_torch.ops import lm_head, mla_attention as ma, moe  # noqa: E402

TEXT = dict(vocab_size=256, hidden_size=64, intermediate_size=96,
            moe_intermediate_size=32, num_hidden_layers=3,
            num_attention_heads=4, n_shared_experts=1, n_routed_experts=8,
            num_experts_per_tok=2, first_k_dense_replace=1, kv_lora_rank=32,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            rms_norm_eps=1e-5, rope_theta=800000.0,
            routed_scaling_factor=2.446, norm_topk_prob=True,
            q_lora_rank=None, scoring_func="sigmoid", topk_method="noaux_tc",
            n_group=1, topk_group=1, tie_word_embeddings=False)
MODEL = {"mla_moe": TEXT,
         "mapper": {"type": "transformer", "prefix_size": 24,
                    "prefix_length": 8, "clip_length": 8, "num_layers": 2,
                    "num_heads": 8, "mlp_ratio": 2.0}}
CFG = {"model": MODEL,
       "weights": {"embed": 1.0, "attn_in": 0.15, "kv_b": 0.2,
                   "attn_out": 0.15, "mlp_in": 0.15, "mlp_out": 0.15,
                   "expert_in": 0.15, "expert_out": 0.15,
                   "router": 0.3, "router_bias": 0.1, "head": 0.15,
                   "normal": 1.0}}
SEEDS = [0, 1, 2]
TOL = 2e-5
CPU = torch.device("cpu")


def _setup(seed):
    sd = weights.state_dict(CFG, seed, CPU)
    mcfg = dec.model_config(MODEL, "f32")
    model = dec.load_model(sd, mcfg, CPU)
    emb = torch.randn(3, 24, generator=torch.Generator().manual_seed(seed))
    return sd, mcfg, model, emb


def _close(got, want):
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= TOL * scale


def _prefix(model, mcfg, emb):
    x = emb / emb.norm(dim=-1, keepdim=True)
    return caption_model.map_prefix(model, mcfg, x)


@pytest.mark.parametrize("seed", SEEDS)
def test_prefill_logits_match_the_reference(seed):
    sd, mcfg, model, emb = _setup(seed)
    logits0, cache = mla_moe.prefill(model.gpt, mcfg.mla_moe,
                                     _prefix(model, mcfg, emb))
    toks = torch.zeros(3, 1, dtype=torch.long)
    _close(logits0, ref.caption_logits(sd, MODEL, emb, toks)[:, 0])
    assert cache["k"].shape == (3, 3, 8, 40)   # [L, N, K, 32 + 8]
    assert cache["expert_rows"].shape == (2, 8)


@pytest.mark.parametrize("seed", SEEDS)
def test_decode_through_the_latent_cache_matches_the_full_forward(seed):
    """Two images of three beam rows each, every row its own tokens:
    each step's logits against the reference's full forward over the
    prefix and the row's tokens so far."""
    sd, mcfg, model, emb = _setup(seed)
    c = mcfg.mla_moe
    N, R, steps = 2, 3, 6
    _, cache = mla_moe.prefill(model.gpt, c, _prefix(model, mcfg, emb[:N]))
    gen = mla_moe.init_gen_cache_rowmajor(c, N * R, 8)
    toks = torch.randint(0, 256, (N * R, steps),
                         generator=torch.Generator().manual_seed(seed + 7))
    want = ref.caption_logits(sd, MODEL, emb[:N].repeat_interleave(R, 0),
                              torch.cat([toks, toks[:, :1]], 1))
    for s in range(steps):
        got = mla_moe.decode_step(model.gpt, c,
                                  mla_moe.embed_tokens(model.gpt, toks[:, s]),
                                  cache, gen, s, return_hidden=False)
        _close(got, want[:, s + 1])
    # every decode row took k experts in each routed layer
    assert cache["expert_rows"].sum(1).tolist() == [N * R * steps * 2] * 2


@pytest.mark.parametrize("seed", SEEDS)
def test_absorbed_attention_equals_the_expanded(seed):
    """K16's plain version on q_lat = q_nope W_UK[h], mapped by W_UV[h],
    against softmax((q_nope.k_nope + q_pe.k_pe) scale) v with per-head
    k_nope and v expanded from the latent rows."""
    g = torch.Generator().manual_seed(seed)
    H, nope, rope, r, vd = 4, 16, 8, 32, 16
    N, R, K, L, E, step = 2, 3, 5, 2, 6, 4
    B = N * R
    wkvb = torch.randn(H, nope + vd, r, generator=g)
    q = torch.randn(B, H, nope + rope, generator=g)
    prefix = torch.randn(L, N, K, r + rope, generator=g)
    gen = torch.randn(B, L, E, r + rope, generator=g)
    new = torch.randn(B, r + rope, generator=g)
    scale = ma.softmax_scale(nope + rope)
    q_lat = torch.bmm(q[..., :nope].transpose(0, 1), wkvb[:, :nope])
    o_lat = ma.mla_decode_attention_plain(q_lat, q[..., nope:], new, prefix,
                                          gen, step, 1, beams_per_image=R,
                                          scale=scale)
    got = torch.bmm(o_lat, wkvb[:, nope:].transpose(1, 2)).transpose(0, 1)
    rows = torch.cat([prefix[1].repeat_interleave(R, 0), gen[:, 1, :step],
                      new[:, None]], 1)                         # [B, S, C]
    kv = torch.einsum("bsc,hdc->bhsd", rows[..., :r], wkvb)
    k = torch.cat([kv[..., :nope],
                   rows[:, None, :, r:].expand(B, H, -1, rope)], -1)
    p = torch.softmax(torch.einsum("bhd,bhsd->bhs", q, k) * scale, -1)
    want = torch.einsum("bhs,bhsd->bhd", p, kv[..., nope:])
    _close(got, want)


def test_routing_chooses_by_the_biased_score_and_weights_by_the_unbiased():
    logits = torch.tensor([[2.0, 1.9, 0.0, -1.0]])
    bias = torch.tensor([0.0, 0.0, 0.5, 0.0])
    idx, w = moe.route_plain(logits, bias, 2, True, 2.446)
    assert sorted(idx[0].tolist()) == [0, 2]     # 2 only by its bias
    s = torch.sigmoid(logits[0])
    want = torch.stack([s[i] for i in idx[0].tolist()])
    torch.testing.assert_close(w[0], want / want.sum() * 2.446)
    r_idx, r_w = ref.route(TEXT | {"num_experts_per_tok": 2}, logits, bias)
    assert torch.equal(r_idx.sort(-1).values, idx.long().sort(-1).values)
    torch.testing.assert_close(r_w.sort(-1).values, w.sort(-1).values)
    no_norm, w2 = moe.route_plain(logits, bias, 2, False, 2.0)
    torch.testing.assert_close(w2[0], torch.stack(
        [s[i] for i in no_norm[0].tolist()]) * 2.0)


def test_dispatch_products_and_combine_equal_a_per_token_loop():
    g = torch.Generator().manual_seed(3)
    T, E, k, D, I = 7, 4, 2, 8, 6
    h = torch.randn(T, D, generator=g)
    idx = torch.stack([torch.randperm(E, generator=g)[:k] for _ in range(T)]
                      ).to(torch.int32)
    w = torch.rand(T, k, generator=g)
    wgu = torch.randn(E, 2 * I, D, generator=g)
    wd = torch.randn(E, D, I, generator=g)
    counter = torch.zeros(E, dtype=torch.int32)
    offs, pos, token_of = moe.dispatch_plain(idx, E, counter)
    assert counter.tolist() == torch.bincount(idx.flatten().long(),
                                              minlength=E).tolist()
    ys = moe.expert_products_plain(h[token_of.long()], wgu, wd, offs)
    x = torch.zeros(T, D)
    moe.combine_plain(x, ys, pos, w)
    want = torch.zeros(T, D)
    for t in range(T):
        for j in range(k):
            e = int(idx[t, j])
            gu = wgu[e] @ h[t]
            want[t] += w[t, j] * (wd[e] @ (torch.nn.functional.silu(gu[:I])
                                           * gu[I:]))
    torch.testing.assert_close(x, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", SEEDS)
def test_beam_search_gives_the_reference_beams(seed):
    sd, mcfg, model, emb = _setup(seed)
    bc = beam.BeamConfig(beam_size=3, entry_length=6, stop_token=5)
    tk, ln, sc, order = beam.beam_search(model.gpt, mcfg.mla_moe,
                                         _prefix(model, mcfg, emb), bc)
    top, lens = beam.beam_top_select(tk, ln, order)
    caps, best = ref.beam_search(sd, MODEL, emb, 3, 6, 5)
    assert [top[i, :int(lens[i])].tolist() for i in range(3)] == caps
    _close(sc.gather(1, order[:, :1])[:, 0], best)


class _Ids:
    def decode(self, ids):
        return ",".join(map(str, ids.tolist()))


def test_caption_server_serves_the_reference_captions():
    sd, mcfg, model, emb = _setup(5)
    bc = beam.BeamConfig(beam_size=3, entry_length=6, stop_token=5)
    server = serve_lib.CaptionServer(
        model, mcfg, _Ids(),
        serve_lib.ServeConfig(batch_size=4, beam=True, beam_config=bc),
        device="cpu")
    got = dict(server.serve(enumerate(emb.numpy())))
    caps, _ = ref.beam_search(sd, MODEL, emb, 3, 6, 5)
    assert [got[i] for i in range(3)] == [",".join(map(str, c))
                                          for c in caps]
    rows = np.asarray(server.stats["expert_rows"])
    # one padded batch of 4 images: 4 x 3 rows, 5 steps, 2 experts each
    assert rows.shape == (2, 8) and rows.sum(1).tolist() == [120, 120]


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def test_gpt2_beam_search_issues_the_same_ops_as_before_the_interface():
    """A tiny GPT-2 beam search (3 images, beam 3, 9 tokens) issues the
    same 2373 ATen ops, in the same order (their names' hash), as on the
    tree before decode/beam.py reached its decoder through
    models/decoders.py: the interface adds no launch on the card."""
    cfg = gpt2.GPT2Config(vocab_size=64, n_positions=32, n_embd=64,
                          n_layer=2, n_head=2, compute_dtype=torch.float32)
    model = gpt2.init_params(gpt2.GPT2LMHeadModel(cfg), cfg,
                             torch.Generator().manual_seed(0))
    x = torch.randn(3, 4, 64, generator=torch.Generator().manual_seed(1))
    bc = beam.BeamConfig(beam_size=3, entry_length=9, stop_token=63)
    with _Ops() as ops:
        out = beam.beam_search(model, cfg, x, bc)
    assert len(ops.names) == 2373
    assert hashlib.sha256("\n".join(ops.names).encode()).hexdigest()[
        :16] == "992dfdf3d2de040e"
    assert int(out[0].sum()) == 1666
    assert decoders.of(cfg) is gpt2


@pytest.mark.parametrize("knobs", [
    dict(kv_cache_int8=True), dict(rowmajor_cache=False),
    dict(lane_beams=False), dict(ancestry=True),
    dict(fused_slot_chunks=8), dict(bounded_fork_copy=False)])
def test_paths_the_decoder_does_not_take_raise(knobs):
    _, mcfg, model, emb = _setup(0)
    bc = beam.BeamConfig(beam_size=3, entry_length=6, stop_token=5, **knobs)
    with pytest.raises(NotImplementedError):
        beam.beam_search(model.gpt, mcfg.mla_moe, _prefix(model, mcfg, emb),
                         bc)


def test_greedy_and_training_raise():
    _, mcfg, model, emb = _setup(0)
    with pytest.raises(NotImplementedError):
        topp.greedy_topp_search(model.gpt, mcfg.mla_moe,
                                _prefix(model, mcfg, emb), topp.ToppConfig())
    toks = torch.ones(3, 4, dtype=torch.long)
    with pytest.raises(NotImplementedError):
        caption_model.loss_forward(model, mcfg, toks, emb)
    with pytest.raises(ValueError):        # a setting it does not implement
        dec.model_config({**MODEL, "mla_moe": {**TEXT, "q_lora_rank": 64}},
                         "f32")


def test_loading_holds_the_state_dicts_tensors():
    sd, mcfg, model, _ = _setup(0)
    w = sd["gpt.model.layers.1.mlp.experts.gate_up_proj"]
    assert model.gpt.model.layers[1].mlp.experts.gate_up_proj.data_ptr() \
        == w.data_ptr()
    assert mla_moe.cast_params_for_decode(model.gpt, mcfg.mla_moe) \
        is model.gpt
    assert model.clip_project.linear.weight.dtype == torch.float32


def test_one_tensor_cache_write_and_fork():
    g = torch.Generator().manual_seed(0)
    B, L, E, C = 6, 2, 5, 16
    c = torch.randn(B, L, E, C, generator=g)
    new = [torch.randn(B, C, generator=g) for _ in range(L)]
    cr.write_gen_slot_chunk(c, None, new, None, 3)
    assert torch.equal(c[:, :, 3], torch.stack(new, 1))
    before = c.clone()
    src = torch.tensor([0, 0, 2, 2, 4, 5])
    cr.copy_forked_rows_bounded(c, None, src, 3)
    assert torch.equal(c[1, :, :3], before[0, :, :3])
    assert torch.equal(c[3, :, :3], before[2, :, :3])
    assert torch.equal(c[1, :, 3:], before[1, :, 3:])
    assert torch.equal(c[[0, 2, 4, 5]], before[[0, 2, 4, 5]])


def test_kernel_plans_for_the_latent_and_d2048():
    assert cr.fork_copy_plan(2560, 27, 66, 1152, parts=1)["items"] == \
        cr.fork_copy_plan(2560, 27, 66, 1152)["items"] // 2
    plan = cr.slot_write_plan(27, 2560, 576, 2, 132, parts=1)
    assert plan["items"] == 27 * 2560 and plan["layer_blocks"] == 640
    assert cr.slot_write_plan(12, 2560, 768, 2, 132) == \
        cr.slot_write_plan(12, 2560, 768, 2, 132, parts=2)
    p = lm_head.lm_head_plan(2560, 163840, 2048, 5, 2)
    assert (p["route"], p["tile_n"], p["stages"], p["smem"],
            p["blocks"]) == ("wgmma", 48, 4, 230992, 132)
    # every plan accepted before tile_n 48 is unchanged: 128 entries and
    # the deepest ring up to D 832, then 64
    for D in range(8, 1665, 8):
        q = lm_head.lm_head_plan(2560, 163840, D, 5, 2)
        assert q["tile_n"] == (128 if D <= 832 else 64)
    # K16: a block a beam row, the slots in chunks of 32 through two
    # buffers, 96960 bytes of shared memory: two blocks an SM
    k16 = ma.mla_attention_plan(2560, 5, 40, 66)
    assert k16 == dict(grid=2560, threads=128, slots=107, chunks=4,
                       smem=96960)
    assert 2 * k16["smem"] <= 228 * 1024
    assert ma.mla_attention_plan(5, 5, 10, 0)["chunks"] == 1
    with pytest.raises(ValueError):
        ma.mla_attention_plan(2560, 5, 40, 66, H=8)
    with pytest.raises(ValueError):
        ma.mla_attention_plan(2561, 5, 40, 66)

"""The frozen operation and byte counts against counts made by hand."""
from __future__ import annotations

import pytest

from h100bench_helpers import common

from benchmark.roofline import decode_attention, decode_model, lm_head, peaks
from benchmark.roofline import train_model


@pytest.mark.parametrize("B,D,V,R", [(2560, 768, 50257, 5), (64, 128, 256, 1)])
def test_lm_head(B, D, V, R):
    assert lm_head.flops(B, D, V) == 2 * B * D * V
    # bf16 hidden rows and weights read once; f32 values, int32 indices,
    # f32 logsumexp written once
    hand = B * D * 2 + V * D * 2 + B * R * 4 + B * R * 4 + B * 4
    assert lm_head.nbytes(B, D, V, R) == hand


def test_lm_head_bound_at_the_offline_shape():
    # PERF.md's kernel table: K1 at B 2560, R 5 is bound by its
    # operations at 0.1998165 ms
    b = peaks.bound_s(lm_head.flops(2560, 768, 50257),
                      lm_head.nbytes(2560, 768, 50257, 5))
    assert abs(b * 1e3 - 0.1998165) < 1e-6


@pytest.mark.parametrize("N,R,K,D,step", [(64, 5, 40, 768, 66),
                                          (512, 5, 10, 768, 3)])
def test_decode_attention(N, R, K, D, step):
    B = N * R
    hand = (B * D * 2 * 3          # q, k_new, v_new
            + N * K * D * 2 * 2    # the prefix's K and V, once an image
            + B * step * D * 2 * 2  # the slots below the step
            + B * D * 4)           # the f32 output
    assert decode_attention.nbytes(N, R, K, D, step) == hand
    assert decode_attention.flops(N, R, K, D, step) == 4 * B * D * (K + step + 1)


def test_decode_attention_matches_the_kernel_table():
    # PERF.md: K2 at N 64 x R 5, K 40, step 66 is bound by bytes at
    # 0.022449 ms
    b = peaks.bound_s(decode_attention.flops(64, 5, 40, 768, 66),
                      decode_attention.nbytes(64, 5, 40, 768, 66))
    assert abs(b * 1e3 - 0.022449) < 1e-6


def _cfg(name):
    bench = common.benchmark()
    return common.config_file(bench, name)["model"]


def test_caption_flops_flagship_by_hand():
    cfg = _cfg("capdec-rn50x4-transformer-gpt2")
    D, V, L, K = 768, 50257, 12, 40
    dense = 24 * D * D
    mapper = 2 * 640 * 40 * D + 80 * 8 * (16 * D * D + 4 * D * 80)
    prefill = sum(L * (dense + 4 * D * (p + 1)) for p in range(K)) + 2 * D * V
    steps = sum(5 * (L * (dense + 4 * D * (K + s + 1)) + 2 * D * V)
                for s in range(66))
    assert decode_model.caption_flops(cfg, 5, 67) == pytest.approx(
        mapper + prefill + steps, rel=1e-12)
    # about 95 GFLOP a caption
    assert 90e9 < decode_model.caption_flops(cfg, 5, 67) < 100e9


def test_caption_flops_mlp_by_hand():
    cfg = _cfg("clipcap-vitb32-mlp-gpt2")
    D, K = 768, 10
    H = D * K // 2
    assert decode_model.mapper_flops(cfg["mapper"], D) == \
        2 * (512 * H + H * D * K)


@pytest.mark.parametrize("batch,T", [(30, 40), (4, 8)])
def test_train_flops_against_the_program(batch, T):
    """The frozen copy counts what the program's own accounting counts."""
    from capdec_tpu_torch.utils import flops
    from benchmark import port
    for name in ("capdec-rn50x4-transformer-gpt2", "clipcap-vitb32-mlp-gpt2"):
        cfg = common.config_file(common.benchmark(), name)
        mcfg = port.model_config(cfg, "bf16")
        assert train_model.train_step_flops(cfg["model"], batch, T) == \
            pytest.approx(flops.train_step_matmul_flops(mcfg, batch, T),
                          rel=1e-12)

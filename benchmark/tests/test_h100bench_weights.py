"""The weights the benchmark makes from the seed (weights.py): in float32,
the configuration's default, bit for bit the tensors the benchmark made
before its configurations could name a dtype; in bf16, drawn in bf16 a
chunk at a time, with no float32 draw."""
from __future__ import annotations

import math

import pytest
import torch

from h100bench_helpers import tiny_config

from benchmark import weights
from benchmark.reference import model as ref_model

CPU = torch.device("cpu")
CELLS = ["flagship-beam-offline", "clipcap-mlp-beam-offline"]


def weights_before(cfg, seed, device):
    """weights.state_dict as it stood before `weights_dtype`."""
    spec = ref_model.layout(cfg["model"])
    scales = cfg["weights"]
    shapes = {k: s for k, s, _ in spec}
    uniform_kinds = ("linear", "linear_bias")
    n_normal = sum(math.prod(s) for _, s, kind in spec
                   if kind not in uniform_kinds + ("one", "zero"))
    n_uniform = sum(math.prod(s) for _, s, kind in spec
                    if kind in uniform_kinds)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    sd, i, j = {}, 0, 0
    for key, shape, kind in spec:
        n = math.prod(shape)
        if kind == "one":
            sd[key] = torch.ones(shape, device=device)
        elif kind == "zero":
            sd[key] = torch.zeros(shape, device=device)
        elif kind in uniform_kinds:
            w = key if kind == "linear" else key[:-len("bias")] + "weight"
            bound = shapes[w][-1] ** -0.5
            if kind == "linear":
                bound *= math.sqrt(3.0)
            sd[key] = uniform[j:j + n].view(shape).mul_(2).sub_(1).mul_(bound)
            j += n
        else:
            sd[key] = normal[i:i + n].view(shape).mul_(float(scales[kind]))
            i += n
    return sd


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("dtype", [None, "f32"])
def test_f32_weights_are_unchanged(cell, dtype):
    cfg = tiny_config(cell)
    if dtype:
        cfg["weights_dtype"] = dtype
    seed = 2**31 + 11
    got, want = weights.state_dict(cfg, seed, CPU), \
        weights_before(cfg, seed, CPU)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("cell", CELLS)
def test_bf16_weights_are_drawn_in_bf16(cell, monkeypatch):
    cfg = dict(tiny_config(cell), weights_dtype="bf16")
    seed = 2**31 + 12
    want = weights_before(cfg, seed, CPU)

    def refused(*a, **k):
        raise AssertionError("a float32 draw")
    monkeypatch.setattr(torch, "randn", refused)
    monkeypatch.setattr(torch, "rand", refused)
    monkeypatch.setattr(weights, "CHUNK", 4096)   # several chunks a draw
    got = weights.state_dict(cfg, seed, CPU)
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == torch.bfloat16 and got[k].shape == w.shape
    again = weights.state_dict(cfg, seed, CPU)
    assert all(torch.equal(got[k], again[k]) for k in got)
    other = weights.state_dict(cfg, seed + 1, CPU)
    assert not torch.equal(got["gpt.transformer.wte.weight"],
                           other["gpt.transformer.wte.weight"])
    # the scales hold: each kind's spread as in float32
    for key in ("gpt.transformer.wte.weight",
                "gpt.transformer.h.0.attn.c_attn.weight"):
        assert float(got[key].float().std()) == pytest.approx(
            float(want[key].std()), rel=0.05)
    lin = [k for k, _, kind in ref_model.layout(cfg["model"])
           if kind == "linear"][0]
    assert float(got[lin].float().abs().max()) <= float(
        want[lin].abs().max()) * 1.02
    for key, _, kind in ref_model.layout(cfg["model"]):
        if kind == "one":
            assert bool((got[key] == 1).all())

"""The decode step's fused epilogues (csrc/epilogue.cu) on the card,
against their plain versions. Every test here needs an NVIDIA GPU (sm_90a)
and skips without one; run them there with

    python -m pytest tests/test_torch_epilogue_cuda.py -q

Tolerances, at the served shapes (B 2560 rows: batch 512 x beam 5; B 5:
one image; and a ragged 333 and 1) and GPT-2's widths 768, 2304 and 3072,
in bf16 and f32, and at other widths (64 and 128, the card tests' tiny
models; 1024 and 1600, GPT-2 medium's and XL's; a tp rank's 1152 and
1536):
  * bias_cast and every residual x' (bias_residual_layernorm's and the
    entry's): bit-exact. They add and round as the chain does, and IEEE
    addition and round-to-nearest-even leave no freedom.
  * bias_gelu_cast: bf16 at most one unit in the last place on at most
    0.1 % of the outputs; f32 within 1e-6. The kernel computes PyTorch's
    tanh form with its constants in its order, so only tanhf's last bit
    may differ (the toolkits may differ), and in f32 that bit is scaled
    where 1 + tanh cancels.
  * the layernorm outputs h: bf16 at most one unit in the last place, or
    2^-20 where g (x - mean) and beta cancel to near zero (there a unit
    is tiny and a last bit of the statistics spans several), on at most
    0.1 % of the outputs; f32 within 1e-6 (relative 1e-6 above 1). The
    kernel takes the mean and variance in two passes over the row in
    registers, PyTorch's kernel by Welford's update: rstd may differ in
    its last bit, and h by that bit, which in bf16 moves a rounding only
    where the f32 value lies within a few 2^-24 of a rounding edge.
Also: each wrapper launches once a call; decode_step at N 512 x R 5
launches at most 11 kernels a block (10: four products, K2, the cast of
K2's output, four epilogues; plus the entry and the slot write); a beam
search and greedy decode in f32 at N 64 give the same tokens through the
kernels and through `plain_ops`; a row not of whole 16-byte vectors, a
layernorm row wider than the kernel holds, another dtype, a strided
operand or a refused launch raises.
"""
import pytest
import torch

from capdec_tpu_torch.decode import beam, topp
from capdec_tpu_torch.models import gpt2
from capdec_tpu_torch.ops import epilogue as ep

pytestmark = pytest.mark.cuda

D = 768
ULP_SHARE = 1e-3
ATOL = 2.0 ** -20


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.fixture
def gen(dev):
    return torch.Generator(device=dev).manual_seed(0)


def ulps(a, b):
    """Units in the last place of a's dtype between a and b."""
    bits, mask = {torch.bfloat16: (torch.int16, 0x7FFF),
                  torch.float32: (torch.int32, 0x7FFFFFFF)}[a.dtype]

    def ordered(t):
        m = t.view(bits).long()
        return torch.where(m < 0, -(m & mask), m)
    return (ordered(a) - ordered(b)).abs()


def close(got, want, exact=False):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    if exact:
        assert torch.equal(got, want)
    elif got.dtype == torch.bfloat16:
        u = ulps(got, want)
        far = (u > 1) & ((got.float() - want.float()).abs() > ATOL)
        assert not bool(far.any())
        assert float((u > 0).float().mean()) <= ULP_SHARE
    else:
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def inputs(gen, dev, B, dtype, D=D):
    rand = lambda *s: torch.randn(*s, generator=gen, device=dev)
    return dict(qkv=rand(B, 3 * D).to(dtype), fc=(2 * rand(B, 4 * D)).to(
        dtype), proj=rand(B, D).to(dtype), x=(3 * rand(B, D)).to(dtype),
        e=rand(B, D).to(dtype), p=rand(D).to(dtype), b3=rand(3 * D),
        b4=rand(4 * D), b1=rand(D), g=1 + 0.1 * rand(D), beta=0.1 * rand(D))


CALLS = {  # name -> (arguments from inputs(), bit-exact?)
    "bias_cast": (lambda i: (i["qkv"], i["b3"]), True),
    "bias_gelu_cast": (lambda i: (i["fc"], i["b4"]), False),
    "bias_residual_layernorm": (
        lambda i: (i["x"], i["proj"], i["b1"], i["g"], i["beta"], 1e-5),
        False),
    "embed_layernorm": (
        lambda i: (i["e"], i["p"], i["g"], i["beta"], 1e-5, i["e"].dtype),
        False),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B", [2560, 5, 333, 1])
@pytest.mark.parametrize("name", sorted(CALLS))
def test_epilogue_kernel_matches_plain(dev, gen, name, B, dtype):
    args, exact = CALLS[name]
    a = args(inputs(gen, dev, B, dtype))
    fn = getattr(ep, name)
    n0 = fn.launches
    got = fn(*a)
    assert fn.launches == n0 + 1
    want = getattr(ep, name + "_plain")(*a)
    if isinstance(got, tuple):
        close(got[0], want[0], exact=True)  # the residual x'
        close(got[1], want[1])              # its layernorm h
    else:
        close(got, want, exact=exact)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("width", [64, 128, 1024, 1600])
@pytest.mark.parametrize("name", sorted(CALLS))
def test_epilogue_kernels_at_other_widths(dev, gen, name, width, dtype):
    """The kernels at rows of other widths (the bias kernels at 3 and 4
    times them), 333 rows, with the tolerances of GPT-2's width."""
    args, exact = CALLS[name]
    a = args(inputs(gen, dev, 333, dtype, D=width))
    got = getattr(ep, name)(*a)
    want = getattr(ep, name + "_plain")(*a)
    if isinstance(got, tuple):
        close(got[0], want[0], exact=True)
        close(got[1], want[1])
    else:
        close(got, want, exact=exact)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("width", [1152, 1536])
def test_bias_kernels_at_a_tp_ranks_widths(dev, gen, width, dtype):
    """A tp rank's c_attn (1152 at tp 2) and c_fc (1536) outputs."""
    rand = lambda *s: torch.randn(*s, generator=gen, device=dev)
    y, b = rand(2560, width).to(dtype), rand(width)
    close(ep.bias_cast(y, b), ep.bias_cast_plain(y, b), exact=True)
    close(ep.bias_gelu_cast(y, b), ep.bias_gelu_cast_plain(y, b))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B", [2560, 5])
def test_out_in_place(dev, gen, B, dtype):
    """decode_step's use: the residual x' written over x, h into a buffer
    reused from block to block, a GELU into a reused buffer."""
    i = inputs(gen, dev, B, dtype)
    x = i["x"].clone()
    want = ep.bias_residual_layernorm_plain(i["x"], i["proj"], i["b1"],
                                            i["g"], i["beta"], 1e-5)
    h = torch.empty_like(x)
    got = ep.bias_residual_layernorm(x, i["proj"], i["b1"], i["g"],
                                     i["beta"], 1e-5, out=(x, h))
    assert got[0] is x and got[1] is h
    close(x, want[0], exact=True)
    close(h, want[1])
    a = torch.empty_like(i["fc"])
    assert ep.bias_gelu_cast(i["fc"], i["b4"], out=a) is a
    close(a, ep.bias_gelu_cast_plain(i["fc"], i["b4"]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gelu_over_its_range(dev, dtype):
    """bias_gelu_cast on every bf16 value in [-12, 12] (zero bias), where
    tanh saturates and where 1 + tanh cancels."""
    y = torch.arange(-12 * 256, 12 * 256 + 1, device=dev) / 256
    y = y[:y.numel() // 768 * 768].to(dtype).reshape(-1, 768)
    b = torch.zeros(768, device=dev)
    close(ep.bias_gelu_cast(y, b), ep.bias_gelu_cast_plain(y, b))


def _gpt2(dev, dtype, n_layer, vocab=50257):
    cfg = gpt2.GPT2Config(vocab_size=vocab, n_layer=n_layer,
                          compute_dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = gpt2.init_params(gpt2.GPT2LMHeadModel(cfg, device=dev), cfg, gen)
    with torch.no_grad():  # biases and layernorms away from 0 and 1
        for p in model.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen, device=dev))
    return cfg, beam.cast_params_for_decode(model, cfg), gen


def test_decode_step_launches_at_most_11_a_block(dev, monkeypatch):
    """decode_step at N 512 x R 5 (B 2560), full-width GPT-2 124M in
    bf16: its kernels over its blocks, from torch.profiler; its hidden
    state within a unit in the last place of the chain's on most rows
    (the step with the epilogues' plain versions, the chain's bits, and
    K2 and the slot write as launched)."""
    N, R, K, E = 512, 5, 40, 72
    cfg, model, gen = _gpt2(dev, torch.bfloat16, 12)
    _, pc = gpt2.prefill(model, cfg, torch.randn(N, K, D, generator=gen,
                                                 device=dev))
    tok = model.transformer.wte.weight[torch.randint(
        0, cfg.vocab_size, (N * R,), generator=gen, device=dev)]
    cache = gpt2.init_gen_cache_rowmajor(cfg, N * R, E, device=dev)
    step = lambda **kw: gpt2.decode_step(model, cfg, tok, pc, cache, 33,
                                         e_cap=E, **kw)
    with monkeypatch.context() as m:
        for name in ("bias_cast", "bias_gelu_cast",
                     "bias_residual_layernorm", "embed_layernorm"):
            m.setattr(ep, name, getattr(ep, name + "_plain"))
        chain = step()
    n0 = ep.bias_residual_layernorm.launches
    hid = step()
    torch.cuda.synchronize()
    assert ep.bias_residual_layernorm.launches == n0 + 2 * cfg.n_layer
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    assert len(kernels) <= 11 * cfg.n_layer, sorted(e.name for e in kernels)
    # 12 blocks of bf16 rounding apart: most values equal, a few an ulp or
    # more (a last bit of a layernorm carried through later products)
    u = ulps(hid, chain)
    assert float((u > 0).float().mean()) < 0.2
    assert float((hid.float() - chain.float()).abs().max()) < 0.1


def test_f32_beam_and_greedy_tokens_match_plain_ops(dev):
    """Full-width blocks (four of them) in f32 at N 64: the beam search's
    and greedy decode's tokens through the kernels equal `plain_ops`'s."""
    cfg, model, gen = _gpt2(dev, torch.float32, 4, vocab=2000)
    prefix = torch.randn(64, 10, D, generator=gen, device=dev)
    bc = beam.BeamConfig(beam_size=5, entry_length=20, stop_token=-1)
    a = beam.beam_search(model, cfg, prefix, bc)
    b = beam.beam_search(model, cfg, prefix, bc.plain())
    for name, x, y in zip(("tokens", "lengths", "scores", "order"), a, b):
        if name == "scores":
            torch.testing.assert_close(x, y, atol=1e-4, rtol=0)
        else:
            assert torch.equal(x, y), name
    tc = topp.ToppConfig(entry_length=20, stop_token=-1, extra_stop_token=-1)
    g1 = topp.greedy_topp_search(model, cfg, prefix, tc)
    g2 = topp.greedy_topp_search(model, cfg, prefix, tc.plain())
    assert torch.equal(g1[0], g2[0]) and torch.equal(g1[1], g2[1])


@pytest.mark.parametrize("name,mutate", [
    ("bias_cast", lambda a: (a[0][:, :636].contiguous(), a[1][:636])),
    ("bias_cast", lambda a: (a[0].half(), a[1])),
    ("bias_cast", lambda a: (a[0][:, 1:2305 - 768], a[1][:1536])),
    ("bias_cast", lambda a: (a[0], a[1].cpu())),
    ("bias_gelu_cast", lambda a: (a[0], a[1].to(torch.bfloat16))),
    ("bias_residual_layernorm",
     lambda a: (a[0][:, :508].contiguous(), a[1][:, :508].contiguous(),
                *(t[:508] for t in a[2:5]), a[5])),
    ("embed_layernorm", lambda a: (a[0], a[1].float(), *a[2:])),
    ("embed_layernorm", lambda a: (a[0].float(), *a[1:])),
])
def test_wrappers_raise_on_what_the_kernels_do_not_take(dev, gen, name,
                                                        mutate):
    args, _ = CALLS[name]
    a = mutate(args(inputs(gen, dev, 5, torch.bfloat16)))
    with pytest.raises((ValueError, TypeError)):
        getattr(ep, name)(*a)


def test_a_refused_launch_raises(dev, gen, monkeypatch):
    """A plan the C entry refuses (1024 threads a block) raises at once."""
    y, b = CALLS["bias_cast"][0](inputs(gen, dev, 5, torch.bfloat16))
    monkeypatch.setattr(ep, "bias_plan", lambda *a: dict(
        threads=1024, blocks=1, vectors=1))
    with pytest.raises(RuntimeError, match="bias_cast: CUDA error"):
        ep.bias_cast(y, b)

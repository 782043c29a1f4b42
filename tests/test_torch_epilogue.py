"""The decode step's fused epilogues (ops/epilogue.py, csrc/epilogue.cu),
checked on the CPU:

  * each plain version is bit-identical to the op chain of gpt2's blocks
    it replaces (`_dense`, `gelu_new`, the residual sum, `_layer_norm`),
    in bf16 and f32, at small widths and ragged row counts;
  * decode_step through the epilogues equals the op chain (`_chain_blocks`,
    `_block`'s ops in decode_step's place) bit for bit on the CPU on every
    cache route, with the hidden state and with the logits, and writes the
    same K/V;
  * the route: the blocks call the epilogues (one entry, then four a
    block), which launch outside a `_build.plain_ops` scope and not inside
    one; a tp rank's c_projs keep the chain, its c_attn and c_fc take the
    epilogues; on the card the blocks launch them at any width of whole
    16-byte vectors and raise for a width or dtype the kernels do not
    take; the beam and greedy engines run decode_step inside the scope
    exactly under `plain_ops`;
  * the launch plans and their refusals;
  * through a stand-in for the kernel library that records each C entry
    and carries its arithmetic out on the CPU from the pointers it is
    given, one launch a wrapper call with the plan's block, and
    decode_step at GPT-2's width 768 launching one entry and four
    epilogues a block, its hidden state and cache equal to the chain's;
  * `out`: the residual written over x, h and the GELU into buffers of
    their own, as decode_step reuses them; an h that overlaps x, y or x'
    refused;
  * the wrappers' refusals, before any launch, and a refused launch's
    code raised.
"""
import ctypes
from unittest import mock

import numpy as np
import pytest
import torch

from capdec_tpu_torch.decode import beam, topp
from capdec_tpu_torch.models import gpt2
from capdec_tpu_torch.ops import _build
from capdec_tpu_torch.ops import epilogue as ep

torch.set_num_threads(2)

SMS = 132  # the H100's SMs
DTYPES = [torch.bfloat16, torch.float32]
ITEMSIZE = {torch.bfloat16: 2, torch.float32: 4}


def _rand(gen, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(*shape, generator=gen) * scale).to(dtype)


def _conv(gen, d_in, d_out):
    layer = gpt2.Conv1D(d_in, d_out)
    with torch.no_grad():
        layer.weight.copy_(_rand(gen, d_in, d_out, scale=0.2))
        layer.bias.copy_(_rand(gen, d_out))
    return layer


def _ln(gen, D):
    ln = torch.nn.LayerNorm(D, eps=1e-5)
    with torch.no_grad():
        ln.weight.copy_(1 + _rand(gen, D, scale=0.1))
        ln.bias.copy_(_rand(gen, D, scale=0.1))
    return ln


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,D", [(1, 8), (7, 16), (13, 24), (5, 768)])
def test_plain_versions_are_the_op_chain(dtype, rows, D):
    """bias_cast, bias_gelu_cast, bias_residual_layernorm and
    embed_layernorm's plain versions give the chain's bits: `_dense` then
    `.to(cdt)` (c_attn), `gelu_new` of `_dense` then `.to(cdt)` (c_fc),
    `x + _dense(..).to(x.dtype)` then `_layer_norm` (the c_projs), and
    `(e + p).to(cdt)` then `_layer_norm` (the entry)."""
    gen = torch.Generator().manual_seed(rows * D)
    cdt = dtype
    h = _rand(gen, rows, D, dtype=cdt)
    x = _rand(gen, rows, D, dtype=cdt)
    ln = _ln(gen, D)
    c_attn, c_fc, c_proj = _conv(gen, D, 3 * D), _conv(gen, D, 4 * D), \
        _conv(gen, 4 * D, D)
    mm = lambda a, layer: torch.matmul(a, layer.weight.to(cdt))
    assert torch.equal(ep.bias_cast_plain(mm(h, c_attn), c_attn.bias),
                       gpt2._dense(h, c_attn, cdt).to(cdt))
    a = ep.bias_gelu_cast_plain(mm(h, c_fc), c_fc.bias)
    assert torch.equal(a, gpt2.gelu_new(gpt2._dense(h, c_fc, cdt)).to(cdt))
    got_x, got_h = ep.bias_residual_layernorm_plain(
        x, mm(a, c_proj), c_proj.bias, ln.weight, ln.bias, ln.eps)
    want_x = x + gpt2._dense(a, c_proj, cdt).to(x.dtype)
    assert torch.equal(got_x, want_x)
    assert torch.equal(got_h, gpt2._layer_norm(want_x, ln))
    for e_dtype in {cdt, torch.float32}:  # the token embeddings, a wpe row
        e, p = _rand(gen, rows, D, dtype=e_dtype), _rand(gen, D,
                                                         dtype=e_dtype)
        got_x, got_h = ep.embed_layernorm_plain(e, p, ln.weight, ln.bias,
                                                ln.eps, cdt)
        want_x = (e + p).to(cdt)
        assert torch.equal(got_x, want_x)
        assert torch.equal(got_h, gpt2._layer_norm(want_x, ln))


# decode_step on a tiny GPT-2 (two layers of 64, two heads)
TINY = dict(vocab_size=64, n_positions=32, n_embd=64, n_layer=2, n_head=2)
N, R, K, E = 3, 2, 4, 8


def _setup(dtype, D=64, n_layer=2, seed=0):
    cfg = gpt2.GPT2Config(**dict(TINY, n_embd=D, n_layer=n_layer,
                                 n_head=D // 32), compute_dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    model = gpt2.init_params(gpt2.GPT2LMHeadModel(cfg), cfg, gen)
    with torch.no_grad():  # biases and layernorms away from 0 and 1
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.add_(_rand(gen, *p.shape, scale=0.1))
    model = beam.cast_params_for_decode(model, cfg)
    x = _rand(gen, N, K, D)
    _, prefix = gpt2.prefill(model, cfg, x)
    tok = model.transformer.wte.weight[torch.randint(
        0, cfg.vocab_size, (N * R,), generator=gen)]
    return cfg, model, prefix, tok, gen


def _cache(cfg, gen, route):
    B, L, D = N * R, cfg.n_layer, cfg.n_embd
    if route in ("int8", "v3_int8"):
        c = gpt2.init_gen_cache_rowmajor_int8(cfg, B, E)
        c["k"].copy_(torch.randint(-127, 128, c["k"].shape, generator=gen))
        c["v"].copy_(torch.randint(-127, 128, c["v"].shape, generator=gen))
        c["ks"].copy_(torch.rand(c["ks"].shape, generator=gen) / 127)
        c["vs"].copy_(torch.rand(c["vs"].shape, generator=gen) / 127)
        return c
    make = (gpt2.init_gen_cache if route == "seqmajor"
            else gpt2.init_gen_cache_rowmajor)
    c = make(cfg, B, E)
    for name in c:
        c[name].copy_(_rand(gen, *c[name].shape, dtype=c[name].dtype))
    return c


# route -> decode_step keywords (the kernels' wrappers, plain on the CPU)
ROUTES = {
    "k2": dict(e_cap=E),
    "k14": dict(e_cap=E, chunk_slot_write=False, slot_write_kernel=True),
    "v3": dict(fused_slot_chunks=4),
    "int8": dict(e_cap=E),
    "v3_int8": dict(fused_slot_chunks=4),
    "seqmajor": dict(rowmajor=False, fused_attention=False),
    "ancestry": dict(e_cap=E, fused_attention=False),
}


def _chain_blocks(t, cdt, token_embed, position, attention):
    """decode_step's blocks as `_block`'s op chain (`_layer_norm`,
    `_dense_in`, `_dense_out`, `_block_mlp`), the reference the epilogues
    are held to: (ln_f's output, the layers' k, their v), as
    gpt2._decode_blocks returns them."""
    x = (token_embed + t.wpe.weight[position]).to(cdt)
    ks, vs = [], []
    for layer, blk in enumerate(t.h):
        h = gpt2._layer_norm(x, blk.ln_1)
        qkv = gpt2._dense_in(h, blk.attn.c_attn, cdt, blk.tp).to(cdt)
        q, k_new, v_new = qkv.split(qkv.shape[-1] // 3, dim=-1)
        out = attention(q, k_new, v_new, layer)
        out = gpt2._dense_out(out.to(cdt), blk.attn.c_proj, cdt, blk.tp)
        x = gpt2._block_mlp(x + out.to(x.dtype), blk, cdt)
        ks.append(k_new)
        vs.append(v_new)
    return gpt2._layer_norm(x, t.ln_f), ks, vs


def _step(cfg, model, prefix, tok, cache, route, chain=False, **kw):
    """decode_step on `route`; with `chain`, through `_chain_blocks`."""
    knobs = dict(ROUTES[route], **kw)
    if route == "ancestry":
        knobs["anc_rows"] = (torch.arange(N * R)[:, None] // R * R
                             + torch.arange(E)[None, :] % R)
    if route == "v3_int8":
        prefix = gpt2.quantize_prefix_cache(prefix)
    blocks = _chain_blocks if chain else gpt2._decode_blocks
    with mock.patch.object(gpt2, "_decode_blocks", blocks):
        return gpt2.decode_step(model, cfg, tok, prefix, cache, 5, **knobs)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_decode_step_equals_the_chain_bit_for_bit(dtype, route):
    cfg, model, prefix, tok, gen = _setup(dtype)
    c0 = _cache(cfg, gen, route)
    c1 = {k: v.clone() for k, v in c0.items()}
    got = _step(cfg, model, prefix, tok, c0, route)
    want = _step(cfg, model, prefix, tok, c1, route, chain=True)
    assert got.dtype == dtype and torch.equal(got, want)
    for name in c0:
        assert torch.equal(c0[name], c1[name]), name


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_step_logits_equal_the_chain(dtype):
    cfg, model, prefix, tok, gen = _setup(dtype, n_layer=3)
    c0 = _cache(cfg, gen, "k2")
    c1 = {k: v.clone() for k, v in c0.items()}
    got = _step(cfg, model, prefix, tok, c0, "k2", return_hidden=False)
    want = _step(cfg, model, prefix, tok, c1, "k2", return_hidden=False,
                 chain=True)
    assert got.dtype == torch.float32 and got.shape == (N * R,
                                                        cfg.vocab_size)
    assert torch.equal(got, want)


def test_decode_step_of_an_uncast_model_equals_the_chain(monkeypatch):
    """A float32 model decoded in bf16 without the decode cast: on the CPU
    the plain versions give the chain's bits (the entry adds the float32
    embeddings before it rounds); on the card the entry's kernel, which
    reads them in the compute dtype, refuses them before any launch (the
    engines cast the model once for decode)."""
    cfg = gpt2.GPT2Config(**TINY, compute_dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(3)
    model = gpt2.init_params(gpt2.GPT2LMHeadModel(cfg), cfg, gen)
    _, prefix = gpt2.prefill(model, cfg, _rand(gen, N, K, 64))
    tok = _rand(gen, N * R, 64)
    c0 = _cache(cfg, gen, "k2")
    c1 = {k: v.clone() for k, v in c0.items()}
    got = _step(cfg, model, prefix, tok, c0, "k2")
    want = _step(cfg, model, prefix, tok, c1, "k2", chain=True)
    assert torch.equal(got, want)
    lib = _card_route(monkeypatch)
    with pytest.raises(ValueError, match="embed_layernorm"):
        _step(cfg, model, prefix, tok, c0, "k2", fused_attention=False,
              chunk_slot_write=False)
    assert lib.calls == []


def _counting(monkeypatch):
    """Count the calls of each epilogue wrapper (their plain versions
    run on the CPU)."""
    seen = {}
    for name in ("bias_cast", "bias_gelu_cast", "bias_residual_layernorm",
                 "embed_layernorm"):
        real = getattr(ep, name)

        def counted(*args, _real=real, _name=name, **kw):
            seen[_name] = seen.get(_name, 0) + 1
            return _real(*args, **kw)
        counted.launches = 0  # the wrapper counts its launches by name
        monkeypatch.setattr(ep, name, counted)
    return seen


@pytest.mark.parametrize("plain", [False, True])
def test_the_blocks_call_the_epilogues(monkeypatch, plain):
    """The blocks call the epilogue wrappers by default and under
    `_build.plain_ops` alike; only outside the scope do they launch (here
    into the stand-in library, the attention and slot write plain)."""
    cfg, model, prefix, tok, gen = _setup(torch.bfloat16, n_layer=3)
    c0 = _cache(cfg, gen, "k2")
    c1 = {k: v.clone() for k, v in c0.items()}
    want = _step(cfg, model, prefix, tok, c1, "k2", chain=True)
    lib = _card_route(monkeypatch)
    seen = _counting(monkeypatch)
    with _build.plain_ops(plain):
        got = _step(cfg, model, prefix, tok, c0, "k2",
                    fused_attention=False, chunk_slot_write=False)
    L = cfg.n_layer
    assert seen == {"embed_layernorm": 1, "bias_cast": L,
                    "bias_gelu_cast": L, "bias_residual_layernorm": 2 * L}
    assert len(lib.calls) == (0 if plain else 1 + 4 * L)
    assert torch.equal(got, want)


def test_a_tp_rank_keeps_the_chain(monkeypatch):
    """A tp rank's c_proj bias follows the tp sum, in float32: its c_projs
    keep the chain (the residual sum and the layernorm after it), while
    its c_attn and c_fc, whose outputs are its share of the columns, take
    bias_cast and bias_gelu_cast, and the step's entry embed_layernorm
    (here a stand-in group of one rank, whose sums are the identity);
    the chain's bits, in bf16 and f32."""
    class OneRank:
        def __init__(self):
            self.copied = 0

        def copy_in(self, x):
            self.copied += 1
            return x

        def reduce_out(self, y):
            return y
    seen = _counting(monkeypatch)
    for dtype in DTYPES:
        cfg, model, prefix, tok, gen = _setup(dtype)
        c0 = _cache(cfg, gen, "k2")
        c1 = {k: v.clone() for k, v in c0.items()}
        want = _step(cfg, model, prefix, tok,
                     {k: v.clone() for k, v in c0.items()}, "k2",
                     chain=True)
        for blk in model.transformer.h:
            blk.tp = OneRank()
        chain = _step(cfg, model, prefix, tok, c1, "k2",
                      chain=True)
        seen.clear()
        got = _step(cfg, model, prefix, tok, c0, "k2")
        L = cfg.n_layer
        assert seen == {"embed_layernorm": 1, "bias_cast": L,
                        "bias_gelu_cast": L}
        # c_attn's and c_fc's inputs, in the chain's step and in this one
        assert all(blk.tp.copied == 4 for blk in model.transformer.h)
        assert torch.equal(got, want) and torch.equal(got, chain)
        for name in c0:
            assert torch.equal(c0[name], c1[name])


def test_the_card_route_takes_gpt2_width_only(monkeypatch):
    """On the card (here the stand-in library) decode_step's blocks launch
    the epilogues at any width of whole 16-byte vectors up to the
    layernorm's widest, GPT-2's 768-1600 and the tests' 64 alike, with
    the chain's bits; a dtype the kernels do not take raises before any
    launch, where the chain would have run."""
    for dtype in DTYPES:
        cfg, model, prefix, tok, gen = _setup(dtype)  # D 64
        c0 = _cache(cfg, gen, "k2")
        c1 = {k: v.clone() for k, v in c0.items()}
        knobs = dict(fused_attention=False, chunk_slot_write=False)
        want = _step(cfg, model, prefix, tok, c1, "k2",
                     chain=True, **knobs)
        with monkeypatch.context() as m:
            lib = _card_route(m)
            got = _step(cfg, model, prefix, tok, c0, "k2", **knobs)
        assert len(lib.calls) == 1 + 4 * cfg.n_layer
        assert torch.equal(got, want)
    for width in (64, 768, 1024, 1280, 1600, ep.MAX_WIDTH):
        for itemsize in (2, 4):
            assert ep.layernorm_plan(5, width, itemsize, SMS)["warps"] == 1
    cfg, model, prefix, tok, gen = _setup(torch.float16)
    lib = _card_route(monkeypatch)
    with pytest.raises(TypeError, match="compute dtype"):
        _step(cfg, model, prefix, tok, _cache(cfg, gen, "k2"), "k2",
              fused_attention=False, chunk_slot_write=False)
    assert lib.calls == []


@pytest.mark.parametrize("engine", ["beam", "greedy"])
@pytest.mark.parametrize("plain", [False, True])
def test_plain_ops_reaches_decode_step(monkeypatch, engine, plain):
    cfg, model, prefix, tok, gen = _setup(torch.float32)
    got = []
    real = gpt2.decode_step

    def spy(*args, **kw):
        got.append(_build.in_plain_ops())
        return real(*args, **kw)
    monkeypatch.setattr(gpt2, "decode_step", spy)
    embeds = _rand(gen, N, K, cfg.n_embd)
    if engine == "beam":
        bc = beam.BeamConfig(beam_size=R, entry_length=4, stop_token=-1)
        beam.beam_search(model, cfg, embeds, bc.plain() if plain else bc)
    else:
        tc = topp.ToppConfig(entry_length=4, stop_token=-1,
                             extra_stop_token=-1)
        topp.greedy_topp_search(model, cfg, embeds,
                                tc.plain() if plain else tc)
    assert got and set(got) == {plain}
    assert not _build.in_plain_ops()


@pytest.mark.parametrize("rows,width,itemsize,threads,blocks", [
    (2560, 2304, 2, 256, 2880), (2560, 3072, 2, 256, 3840),
    (2560, 768, 4, 256, 1920), (5, 2304, 2, 32, 45), (5, 3072, 4, 32, 120),
    (1, 768, 2, 32, 3), (320, 2304, 2, 256, 360), (64, 3072, 2, 128, 192),
    (2560, 1152, 2, 256, 1440), (5, 1536, 2, 32, 30), (3, 64, 4, 32, 2)])
def test_bias_plan(rows, width, itemsize, threads, blocks):
    """A thread a 16-byte vector; blocks of 256 threads, halved while the
    grid would leave an SM without a block."""
    plan = ep.bias_plan(rows, width, itemsize, SMS)
    assert plan == dict(threads=threads, blocks=blocks,
                        vectors=rows * width * itemsize // 16)
    assert (plan["blocks"] - 1) * threads < plan["vectors"] <= \
        plan["blocks"] * threads


@pytest.mark.parametrize("rows,warps,blocks", [
    (2560, 4, 640), (320, 2, 160), (5, 1, 5), (1, 1, 1), (527, 4, 132),
    (333, 2, 167)])
def test_layernorm_plan(rows, warps, blocks):
    """A warp a row; blocks of 4 warps, halved while the grid would leave
    an SM without a block."""
    for width, itemsize in ((768, 2), (768, 4), (64, 2), (1600, 4)):
        assert ep.layernorm_plan(rows, width, itemsize, SMS) == dict(
            warps=warps, threads=32 * warps, blocks=blocks)


@pytest.mark.parametrize("plan,args", [
    (ep.bias_plan, (4, 636, 2)), (ep.bias_plan, (4, 1026, 4)),
    (ep.bias_plan, (0, 768, 2)), (ep.bias_plan, (2 ** 20, 2 ** 17 * 3, 4)),
    (ep.layernorm_plan, (4, 1800, 2)), (ep.layernorm_plan, (4, 2304, 4)),
    (ep.layernorm_plan, (0, 768, 2)), (ep.layernorm_plan, (4, 762, 4))])
def test_plans_refuse_shapes_the_kernels_do_not_take(plan, args):
    with pytest.raises(ValueError):
        plan(*args, SMS)


def _at(addr, shape, dtype):
    """The tensor at a raw address (a stand-in kernel's view of a
    pointer it was given)."""
    n = int(np.prod(shape)) * ITEMSIZE[dtype]
    return torch.frombuffer((ctypes.c_char * n).from_address(addr),
                            dtype=dtype).view(*shape)


class _Library:
    """Stands in for the kernel library: records each C entry called and
    carries the epilogue out on the CPU by the plain versions, from the
    pointers, sizes, dtype code and flags the wrapper passes, after
    checking the block against the plan."""

    def __init__(self, code=0):
        self.calls = []
        self.code = code  # what each C entry returns

    def __getattr__(self, name):
        if not name.startswith("capdec_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            getattr(self, "_" + name[len("capdec_"):])(*args)
            return self.code
        return entry

    @staticmethod
    def _bias_act(y, b, out, rows, width, dtype, gelu, threads, stream):
        T = {0: torch.float32, 1: torch.bfloat16}[dtype]
        assert threads == ep.bias_plan(rows, width, ITEMSIZE[T],
                                       SMS)["threads"]
        plain = ep.bias_gelu_cast_plain if gelu else ep.bias_cast_plain
        _at(out, (rows, width), T).copy_(plain(
            _at(y, (rows, width), T), _at(b, (width,), torch.float32)))

    @staticmethod
    def _residual_layernorm(x, y, add, g, beta, x_out, h_out, rows, width,
                            eps, dtype, entry, warps, stream):
        T = {0: torch.float32, 1: torch.bfloat16}[dtype]
        assert warps == ep.layernorm_plan(rows, width, ITEMSIZE[T],
                                          SMS)["warps"]
        assert isinstance(eps, float) and (x is None) == bool(entry)
        f32 = lambda p: _at(p, (width,), torch.float32)
        yt = _at(y, (rows, width), T)
        if entry:
            got = ep.embed_layernorm_plain(yt, _at(add, (width,), T), f32(g),
                                           f32(beta), eps, T)
        else:
            got = ep.bias_residual_layernorm_plain(
                _at(x, (rows, width), T), yt, f32(add), f32(g), f32(beta),
                eps)
        _at(x_out, (rows, width), T).copy_(got[0])
        _at(h_out, (rows, width), T).copy_(got[1])


def _card_route(monkeypatch):
    """The wrappers' kernel route on CPU tensors, into a new _Library."""
    lib = _Library()
    monkeypatch.setattr(_build, "run_plain",
                        lambda t: _build.in_plain_ops())
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda device: 0)
    monkeypatch.setattr(_build, "sm_count", lambda device: SMS)
    return lib


@pytest.fixture
def library(monkeypatch):
    return _card_route(monkeypatch)


def _calls(gen, rows, dtype):
    D = 768
    y3, y4, y1 = (_rand(gen, rows, w, dtype=dtype) for w in
                  (3 * D, 4 * D, D))
    x = _rand(gen, rows, D, dtype=dtype)
    b3, b4, b1, g, beta = (_rand(gen, w) for w in (3 * D, 4 * D, D, D, D))
    p = _rand(gen, D, dtype=dtype)
    return {
        "bias_cast": ((y3, b3), "capdec_bias_act"),
        "bias_gelu_cast": ((y4, b4), "capdec_bias_act"),
        "bias_residual_layernorm": ((x, y1, b1, g, beta, 1e-5),
                                    "capdec_residual_layernorm"),
        "embed_layernorm": ((x, p, g, beta, 1e-5, dtype),
                            "capdec_residual_layernorm")}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [1, 5, 7])
def test_one_launch_per_call_computing_the_plain_version(library, dtype,
                                                         rows):
    gen = torch.Generator().manual_seed(rows)
    for name, (args, entry) in _calls(gen, rows, dtype).items():
        fn, plain = getattr(ep, name), getattr(ep, name + "_plain")
        n0, before = fn.launches, len(library.calls)
        got = fn(*args)
        assert fn.launches == n0 + 1
        assert [c[0] for c in library.calls[before:]] == [entry]
        want = plain(*args)
        for a, b in zip(*((got, want) if isinstance(got, tuple)
                          else ((got,), (want,)))):
            assert a.dtype == dtype and torch.equal(a, b), name


@pytest.mark.parametrize("dtype", DTYPES)
def test_out_takes_the_results_in_place(library, dtype):
    """With `out`, the kernels write there: the residual x' into x itself
    and h into a buffer of its own, a GELU into a reused buffer; the
    values are the plain versions'. An h that is x, y or x' is refused."""
    gen = torch.Generator().manual_seed(1)
    calls = _calls(gen, 7, dtype)
    x, y, b, g, beta, eps = calls["bias_residual_layernorm"][0]
    want = ep.bias_residual_layernorm_plain(x, y, b, g, beta, eps)
    h = torch.empty_like(x)
    got = ep.bias_residual_layernorm(x, y, b, g, beta, eps, out=(x, h))
    assert got[0] is x and got[1] is h
    assert torch.equal(x, want[0]) and torch.equal(h, want[1])
    for bad in ((x, x), (x, y), (h, h)):
        with pytest.raises(ValueError, match="h must not"):
            ep.bias_residual_layernorm(x, y, b, g, beta, eps, out=bad)
    y4, b4 = calls["bias_gelu_cast"][0]
    a = torch.empty_like(y4)
    assert ep.bias_gelu_cast(y4, b4, out=a) is a
    assert torch.equal(a, ep.bias_gelu_cast_plain(y4, b4))
    with pytest.raises(ValueError):
        ep.bias_gelu_cast(y4, b4, out=a[:, :768])
    # the plain versions take `out` alike
    out = (torch.empty_like(x), torch.empty_like(x))
    assert ep.bias_residual_layernorm_plain(x, y, b, g, beta, eps,
                                            out=out) is out
    assert torch.equal(out[1], ep.bias_residual_layernorm_plain(
        x, y, b, g, beta, eps)[1])


@pytest.mark.parametrize("name,mutate", [
    ("bias_cast", lambda a: (a[0][:, :636].contiguous(), a[1][:636])),
    ("bias_cast", lambda a: (a[0].half(), a[1])),
    ("bias_cast", lambda a: (a[0], a[1].to(torch.bfloat16))),
    ("bias_cast", lambda a: (a[0], a[1][:768])),
    ("bias_cast", lambda a: (a[0].t(), a[1])),
    ("bias_gelu_cast", lambda a: (a[0][:, 1:3073 - 768], a[1][:2304])),
    ("bias_residual_layernorm",
     lambda a: (a[0][:, :508].contiguous(), a[1][:, :508].contiguous(),
                *(t[:508] for t in a[2:5]), a[5])),
    ("bias_residual_layernorm",
     lambda a: (a[0].float(), *a[1:])),
    ("bias_residual_layernorm",
     lambda a: (a[0], a[1], a[2], a[3].double(), *a[4:])),
    ("embed_layernorm", lambda a: (a[0], a[1].float(), *a[2:])),
    ("embed_layernorm", lambda a: (a[0].float(), *a[1:])),
])
def test_wrappers_refuse_before_launching(library, name, mutate):
    gen = torch.Generator().manual_seed(0)
    args, _ = _calls(gen, 5, torch.bfloat16)[name]
    with pytest.raises((ValueError, TypeError)):
        getattr(ep, name)(*mutate(args))
    assert library.calls == []


def test_a_launch_error_raises(library, monkeypatch):
    """A C entry's non-zero code (a launch refused) raises."""
    gen = torch.Generator().manual_seed(0)
    monkeypatch.setattr(_build, "library", lambda: _Library(code=1))
    for name, (args, _) in _calls(gen, 5, torch.bfloat16).items():
        with pytest.raises(RuntimeError, match=f"{name}: CUDA error 1"):
            getattr(ep, name)(*args)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_step_at_gpt2_width_launches_five_a_block(library, dtype):
    """decode_step at D 768 on the kernels' route (the attention and the
    slot write plain, so that only the epilogues reach the stand-in):
    one entry, then per block bias_cast, bias_residual_layernorm,
    bias_gelu_cast, bias_residual_layernorm; the hidden state and the
    cache equal the chain's."""
    cfg, model, prefix, tok, gen = _setup(dtype, D=768)
    c0 = _cache(cfg, gen, "k2")
    c1 = {k: v.clone() for k, v in c0.items()}
    knobs = dict(fused_attention=False, chunk_slot_write=False)
    got = _step(cfg, model, prefix, tok, c0, "k2", **knobs)
    names = [c[0][len("capdec_"):] for c in library.calls]
    assert names == ["residual_layernorm"] + [
        "bias_act", "residual_layernorm", "bias_act",
        "residual_layernorm"] * cfg.n_layer
    assert [c[1][11] for c in library.calls
            if c[0] == "capdec_residual_layernorm"] == \
        [1] + [0] * 2 * cfg.n_layer  # the entry flag
    assert [c[1][6] for c in library.calls
            if c[0] == "capdec_bias_act"] == [0, 1] * cfg.n_layer  # gelu
    want = _step(cfg, model, prefix, tok, c1, "k2", chain=True,
                 **knobs)
    assert torch.equal(got, want)
    for name in c0:
        assert torch.equal(c0[name], c1[name])

"""The launch plan of the K2/K8 decode-attention kernel
(csrc/decode_attention_async.cu), checked on the CPU: shared memory within
a Hopper block's 227 KB (and two blocks to an SM at the served shape), the
chunks covering every generated slot and the current token once, the grid
covering every (head, row) once, and one launch per wrapper call with the
plan's arguments. The launch itself is recorded by a stand-in for the
kernel library: the kernel runs only on the card (tests/test_torch_cuda.py).
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
    for R in (1, 8, 16):
        plan = da.attention_plan(N, R, K, 12 * hd, hd, E - 1, itemsize)
        assert plan["smem"] <= BLOCK_SMEM
        assert plan["grid"] == (12, N)


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


@pytest.mark.parametrize("R", [1, 5])
def test_grid_covers_every_head_and_row_once(R):
    """Block (h, n) of the plan's grid serves head h of rows n*R .. n*R+R-1
    (the kernel's blockIdx mapping)."""
    gx, gy = da.attention_plan(N, R, K, D, HD, 66, 2)["grid"]
    served = [(h, n * R + r) for h in range(gx) for n in range(gy)
              for r in range(R)]
    assert sorted(served) == [(h, b) for h in range(D // HD)
                              for b in range(N * R)]


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
    monkeypatch.setattr(_build, "on_cpu", lambda t: False)
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
    and more than 16 beams per image (two tensor-core row tiles) are
    refused before any launch."""
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
    with pytest.raises(ValueError, match="1..16 beams"):
        wrapper(*_inputs(17, torch.bfloat16), 3, 1, beams_per_image=17,
                head_dim=HD, **kw)
    assert library.calls == []


def test_plan_refuses_what_no_block_holds():
    with pytest.raises(ValueError, match="does not fit"):
        da.attention_plan(N, 32, 2048, 128 * 12, 128, 71, 4)

"""The decode step's block epilogues: the bias adds, casts, GELU, residual
sums and layernorms that `gpt2.decode_step` runs between a block's
products, each as one kernel (csrc/epilogue.cu, whose note says what
bounds them on the H100 and how the design answers). No TPU kernel: XLA
fused this work inside the jitted step.

  * `bias_cast(y, b)`: T(f32(y) + b), c_attn's epilogue;
  * `bias_gelu_cast(y, b)`: T(gelu_tanh(f32(y) + b)), c_fc's;
  * `bias_residual_layernorm(x, y, b, weight, bias, eps)`: the residual
    x' = x + T(f32(y) + b) and h = T(layernorm_f32(x')), both c_projs'
    (with ln_2, or the next block's ln_1, or ln_f);
  * `embed_layernorm(e, p, weight, bias, eps, dtype)`: the step's entry,
    x = T(e + p) (token embeddings plus a row of wpe) and its layernorm.

T is the compute dtype of y (float32 or bfloat16); b, weight and bias are
float32. Each plain version is the op chain the kernel replaces, as
`gpt2._block` runs it, and rounds where it rounds. A wrapper checks
its arguments and launches the kernel, one launch a call, counted in
`launches`, or runs its plain version where `_build.run_plain` says so.
The kernels take rows of whole 16-byte vectors (a multiple of 8 values in
bfloat16, of 4 in float32), the layernorms up to MAX_WIDTH values (GPT-2
XL's 1600 fits); they raise on anything else. An `out` (bias_gelu_cast's
tensor, or the residual layernorm's pair) takes the results in place of
new tensors, so that decode_step updates its residual in place and reuses
its buffers from block to block.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

MAX_WIDTH = 1792   # the layernorm kernel's widest row (csrc kMaxWidth)
MAX_THREADS = 256  # a bias kernel's block
MAX_WARPS = 4      # a layernorm block: one warp a row


# ---------------------------------------------------------------------------
# Plain versions: the op chains of gpt2._block, verbatim
# ---------------------------------------------------------------------------


def _into(out, values):
    """values (a tensor or a pair), or copied into `out` and out."""
    if out is None:
        return values
    if torch.is_tensor(values):
        return out.copy_(values)
    for o, v in zip(out, values):
        o.copy_(v)
    return out


def bias_cast_plain(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (y.float() + b.float()).to(y.dtype)


def bias_gelu_cast_plain(y: torch.Tensor, b: torch.Tensor,
                         out: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    return _into(out, F.gelu(y.float() + b.float(),
                             approximate="tanh").to(y.dtype))


def _layer_norm(x, weight, bias, eps):
    return F.layer_norm(x.float(), (x.shape[-1],), weight.float(),
                        bias.float(), eps).to(x.dtype)


def bias_residual_layernorm_plain(x: torch.Tensor, y: torch.Tensor,
                                  b: torch.Tensor, weight: torch.Tensor,
                                  bias: torch.Tensor, eps: float,
                                  out: Optional[Tuple[torch.Tensor,
                                                      torch.Tensor]] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    x = x + (y.float() + b.float()).to(x.dtype)
    return _into(out, (x, _layer_norm(x, weight, bias, eps)))


def embed_layernorm_plain(e: torch.Tensor, p: torch.Tensor,
                          weight: torch.Tensor, bias: torch.Tensor,
                          eps: float, dtype: torch.dtype
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    x = (e + p).to(dtype)
    return x, _layer_norm(x, weight, bias, eps)


# ---------------------------------------------------------------------------
# Launch plans and checks
# ---------------------------------------------------------------------------


def _whole_vectors(rows, width, itemsize):
    return rows >= 1 and width >= 1 and width * itemsize % 16 == 0


@functools.lru_cache(maxsize=256)
def bias_plan(rows: int, width: int, itemsize: int, sms: int) -> dict:
    """The bias kernels' launch for [rows, width] of `itemsize` bytes on a
    card of `sms` SMs: a thread a 16-byte vector, blocks of `threads` (256,
    halved down to 32 while the grid would leave SMs without a block).
    Raises for a shape the kernel does not take."""
    if not _whole_vectors(rows, width, itemsize):
        raise ValueError(f"the bias kernels take rows >= 1 of whole 16-byte "
                         f"vectors, got [{rows}, {width}] of {itemsize} "
                         f"bytes")
    vectors = rows * width * itemsize // 16
    if vectors >= 2 ** 31:
        raise ValueError(f"[{rows}, {width}] has too many 16-byte vectors")
    threads = MAX_THREADS
    while threads > 32 and -(-vectors // threads) < sms:
        threads //= 2
    return dict(threads=threads, blocks=-(-vectors // threads),
                vectors=vectors)


@functools.lru_cache(maxsize=256)
def layernorm_plan(rows: int, width: int, itemsize: int, sms: int) -> dict:
    """The layernorm kernel's launch for [rows, width] of `itemsize` bytes:
    a warp a row, in blocks of `warps` (4, halved down to 1 while the grid
    would leave SMs without a block). Raises for a shape the kernel does
    not take."""
    if not _whole_vectors(rows, width, itemsize) or width > MAX_WIDTH:
        raise ValueError(f"the layernorm kernel takes rows >= 1 of whole "
                         f"16-byte vectors, at most {MAX_WIDTH} values, got "
                         f"[{rows}, {width}] of {itemsize} bytes")
    warps = MAX_WARPS
    while warps > 1 and -(-rows // warps) < sms:
        warps //= 2
    return dict(warps=warps, threads=32 * warps, blocks=-(-rows // warps))


def _refuse(name, what):
    raise ValueError(f"{name}: {what}")


def _operand(name, t, dtype, shape, index) -> int:
    """t's address, once t is a contiguous, 16-byte aligned `shape` of
    `dtype` on the card `index`; raises otherwise. Each wrapper checks
    its operands so, tensor by tensor, and reads each address once: a step
    makes about fifty calls, so the host's time a check counts."""
    p = t.data_ptr()
    if t.dtype is not dtype or p & 15 or t.shape != shape or \
            t.get_device() != index or not t.is_contiguous():
        _refuse(name, f"operands must be contiguous, 16-byte aligned "
                      f"{list(shape)} of {dtype} on card {index}, got "
                      f"{list(t.shape)} of {t.dtype} on {t.device}")
    return p


def _rows_of(name, y):
    """(dtype code, rows, width, card index) of y [rows, width]."""
    code = _build.DTYPE_CODES.get(y.dtype)
    if code is None:
        raise TypeError(f"{name}: compute dtype float32 or bfloat16, got "
                        f"{y.dtype}")
    if y.dim() != 2:
        _refuse(name, f"operands must be [rows, width], got {y.shape}")
    rows, width = y.shape
    return code, rows, width, y.get_device()


def _bias_act(name, y, b, gelu, out):
    code, rows, width, index = _rows_of(name, y)
    yp = _operand(name, y, y.dtype, y.shape, index)
    bp = _operand(name, b, torch.float32, (width,), index)
    plan = bias_plan(rows, width, y.element_size(), _build.sm_count(index))
    if out is None:
        out = torch.empty_like(y)
        op = out.data_ptr()
    else:
        op = _operand(name, out, y.dtype, y.shape, index)
    _build.check(_build.library().capdec_bias_act(
        yp, bp, op, rows, width, code, gelu, plan["threads"],
        _build.stream(index)), name)
    return out


def _residual_layernorm(name, x, y, add, weight, bias, eps, entry,
                        out=None):
    code, rows, width, index = _rows_of(name, y)
    yp = _operand(name, y, y.dtype, y.shape, index)
    if entry:  # `add` a row of wpe in the compute dtype; no x
        xp, ap = None, _operand(name, add, y.dtype, (width,), index)
    else:      # `add` the f32 bias
        xp = _operand(name, x, y.dtype, y.shape, index)
        ap = _operand(name, add, torch.float32, (width,), index)
    gp = _operand(name, weight, torch.float32, (width,), index)
    bp = _operand(name, bias, torch.float32, (width,), index)
    plan = layernorm_plan(rows, width, y.element_size(),
                          _build.sm_count(index))
    if out is None:
        out = torch.empty_like(y), torch.empty_like(y)
        xo, ho = out[0].data_ptr(), out[1].data_ptr()
    else:
        xo, ho = (_operand(name, t, y.dtype, y.shape, index) for t in out)
        if ho in (xp, yp, xo):
            _refuse(name, "out's h must not be x, y or out's x")
    _build.check(_build.library().capdec_residual_layernorm(
        xp, yp, ap, gp, bp, xo, ho, rows, width, eps, code, entry,
        plan["warps"], _build.stream(index)), name)
    return out


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def bias_cast(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """T(f32(y) + b), a new tensor: y [rows, width] a product's output in
    the compute dtype T, b float32 [width]."""
    if _build.run_plain(y):
        return bias_cast_plain(y, b)
    out = _bias_act("bias_cast", y, b, 0, None)
    bias_cast.launches += 1
    return out


bias_cast.launches = 0


def bias_gelu_cast(y: torch.Tensor, b: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """T(gelu_tanh(f32(y) + b)), as `bias_cast`; GELU is GPT-2's tanh
    form in float32. Written into `out` (like y; y itself, or no tensor
    that overlaps it) where given."""
    if _build.run_plain(y):
        return bias_gelu_cast_plain(y, b, out)
    out = _bias_act("bias_gelu_cast", y, b, 1, out)
    bias_gelu_cast.launches += 1
    return out


bias_gelu_cast.launches = 0


def bias_residual_layernorm(x: torch.Tensor, y: torch.Tensor,
                            b: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor, eps: float,
                            out: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x', h): the residual x' = x + T(f32(y) + b) in x's dtype T, and
    h = T(layernorm(f32(x')) with float32 weight and bias [width]). x and
    y [rows, width] of T. Written into the pair
    `out` where given (its x' may be x itself, updated in place; its h
    must not overlap x, y or its x'), else into new tensors."""
    if _build.run_plain(y):
        return bias_residual_layernorm_plain(x, y, b, weight, bias, eps,
                                             out)
    out = _residual_layernorm("bias_residual_layernorm", x, y, b, weight,
                              bias, eps, 0, out)
    bias_residual_layernorm.launches += 1
    return out


bias_residual_layernorm.launches = 0


def embed_layernorm(e: torch.Tensor, p: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, eps: float, dtype: torch.dtype
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, h): x = T(e + p), e [rows, width] (token embeddings) plus the
    row p [width] (a position's wpe row), and h = T(layernorm(f32(x))),
    as `bias_residual_layernorm`. On the card e and p must both be of
    the compute dtype `dtype`."""
    if _build.run_plain(e):
        return embed_layernorm_plain(e, p, weight, bias, eps, dtype)
    if e.dtype is not dtype:
        raise ValueError(f"embed_layernorm: e must be {dtype}, got "
                         f"{e.dtype}")
    out = _residual_layernorm("embed_layernorm", None, e, p, weight, bias,
                              eps, 1)
    embed_layernorm.launches += 1
    return out


embed_layernorm.launches = 0

"""The routed-expert layer of models/mla_moe.py: the router's choice, the
sort of the token-expert pairs by expert, the grouped expert products
with the SwiGLU between them, and the weighted combine into the residual
stream.

  route            sigmoid scores, top-k of score + e_score_correction_bias,
                   the unbiased scores of the chosen normalised and scaled
  dispatch         each expert's end (offs), each pair's row in expert
                   order (pos) and each row's token (token_of); adds the
                   counts to a counter row when given
  expert_products  the gate|up products, SwiGLU and the down products of
                   every expert over its rows: one grouped launch a
                   projection (`torch._grouped_mm`, CUTLASS's grouped GEMM
                   on sm_90), never a loop over the experts
  combine          x[t] += sum_j w[t, j] y[pos[t, j]] (f32)

route, dispatch, swiglu and combine launch the hand-written kernels of
csrc/moe.cu, or their plain versions where `_build.run_plain` says so.
`expert_products_plain` is the per-expert loop the grouped products
replace.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

MAX_EXPERTS = 64
MAX_TOP_K = 8


def route_plain(logits: torch.Tensor, bias: torch.Tensor, k: int,
                norm: bool, scaling: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `route`."""
    s = torch.sigmoid(logits.float())
    idx = torch.topk(s + bias, k, dim=-1).indices
    w = s.gather(-1, idx)
    if norm:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx.to(torch.int32), w * scaling


def route(logits: torch.Tensor, bias: torch.Tensor, k: int, norm: bool,
          scaling: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The router's choice of k experts a token from f32 logits [T, E] and
    the f32 e_score_correction_bias [E]: (expert ids int32 [T, k], their
    weights f32 [T, k])."""
    if _build.run_plain(logits):
        return route_plain(logits, bias, k, norm, scaling)
    T, E = logits.shape
    if logits.dtype != torch.float32 or bias.dtype != torch.float32 \
            or not logits.is_contiguous() or E > MAX_EXPERTS \
            or not 0 < k <= min(E, MAX_TOP_K):
        raise ValueError(f"route takes f32 logits [T, <= {MAX_EXPERTS}] and "
                         f"1 <= k <= {MAX_TOP_K}")
    idx = torch.empty(T, k, device=logits.device, dtype=torch.int32)
    w = torch.empty(T, k, device=logits.device, dtype=torch.float32)
    _build.check(_build.library().capdec_moe_route(
        logits.data_ptr(), bias.data_ptr(), T, E, k, int(norm), scaling,
        idx.data_ptr(), w.data_ptr(), _build.stream(logits.device)), "route")
    route.launches += 1
    return idx, w


route.launches = 0


def dispatch_plain(idx: torch.Tensor, E: int,
                   counter: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `dispatch` (a stable sort: within an expert
    the pairs keep their order)."""
    k = idx.shape[-1]
    flat = idx.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=E)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.numel(), device=order.device)
    if counter is not None:
        counter += counts.to(counter.dtype)
    return (counts.cumsum(0).to(torch.int32), pos.to(torch.int32),
            (order // k).to(torch.int32))


def dispatch(idx: torch.Tensor, E: int,
             counter: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pairs of idx int32 [T, k] sorted by expert: (offs int32 [E], each
    expert's end in the sorted rows; pos int32 [T k], pair (t, j)'s row;
    token_of int32 [T k], each row's token). `counter` int32 [E] (a layer's
    row of the expert_rows counter) takes the counts, added."""
    if _build.run_plain(idx):
        return dispatch_plain(idx, E, counter)
    T, k = idx.shape
    if idx.dtype != torch.int32 or not idx.is_contiguous() \
            or E > MAX_EXPERTS or (counter is not None and (
                counter.dtype != torch.int32 or counter.shape != (E,)
                or not counter.is_contiguous())):
        raise ValueError("dispatch takes contiguous int32 idx [T, k] and an "
                         "int32 counter [E]")
    dev = idx.device
    offs = torch.empty(E, device=dev, dtype=torch.int32)
    pos = torch.empty(T * k, device=dev, dtype=torch.int32)
    token_of = torch.empty(T * k, device=dev, dtype=torch.int32)
    _build.check(_build.library().capdec_moe_dispatch(
        idx.data_ptr(), T * k, k, E, offs.data_ptr(), pos.data_ptr(),
        token_of.data_ptr(), 0 if counter is None else counter.data_ptr(),
        _build.stream(dev)), "dispatch")
    dispatch.launches += 1
    return offs, pos, token_of


dispatch.launches = 0


def swiglu_plain(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return (torch.nn.functional.silu(g.float()) * u.float()).to(g.dtype)


def swiglu(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """silu(g) * u in f32, in g's dtype: g and u [M, I] views with
    contiguous rows (bf16 on the card)."""
    if _build.run_plain(g):
        return swiglu_plain(g, u)
    M, I = g.shape
    if g.dtype != torch.bfloat16 or u.dtype != torch.bfloat16 \
            or u.shape != g.shape or g.stride(1) != 1 or u.stride(1) != 1 \
            or I % 8 or g.stride(0) % 8 or u.stride(0) % 8:
        raise ValueError("swiglu takes bf16 [M, I] views, I and the row "
                         "strides multiples of 8")
    out = torch.empty(M, I, device=g.device, dtype=g.dtype)
    if M:
        blocks = min(-(-M * I // 8 // 256), 8 * _build.sm_count(g.device))
        _build.check(_build.library().capdec_swiglu(
            g.data_ptr(), g.stride(0), u.data_ptr(), u.stride(0),
            out.data_ptr(), M, I, blocks, _build.stream(g.device)), "swiglu")
        swiglu.launches += 1
    return out


swiglu.launches = 0


def expert_products_plain(x: torch.Tensor, w_gate_up: torch.Tensor,
                          w_down: torch.Tensor, offs: torch.Tensor
                          ) -> torch.Tensor:
    """The per-expert loop: rows offs[e - 1] .. offs[e] of x [M, D] through
    expert e's gate|up [E, 2 I, D], SwiGLU and down [E, D, I]."""
    I = w_down.shape[2]
    out = torch.empty(x.shape[0], w_down.shape[1], device=x.device,
                      dtype=x.dtype)
    start = 0
    for e, end in enumerate(offs.tolist()):
        if end > start:
            gu = x[start:end] @ w_gate_up[e].t()
            out[start:end] = swiglu_plain(gu[:, :I], gu[:, I:]) \
                @ w_down[e].t()
        start = end
    return out


def expert_products(x: torch.Tensor, w_gate_up: torch.Tensor,
                    w_down: torch.Tensor, offs: torch.Tensor,
                    kernels: bool = True) -> torch.Tensor:
    """Every expert's SwiGLU MLP over its rows of x [M, D] (sorted by
    expert, expert e's ending at offs[e]): one grouped gate|up product over
    all experts ([E, 2 I, D] weights), the SwiGLU, one grouped down
    product ([E, D, I]). `kernels=False` runs the per-expert loop."""
    if not kernels or _build.run_plain(x):
        return expert_products_plain(x, w_gate_up, w_down, offs)
    I = w_down.shape[2]
    gu = torch._grouped_mm(x, w_gate_up.transpose(-2, -1), offs=offs)
    act = swiglu(gu[:, :I], gu[:, I:])
    expert_products.launches += 1
    return torch._grouped_mm(act, w_down.transpose(-2, -1), offs=offs)


expert_products.launches = 0


def combine_plain(x: torch.Tensor, y: torch.Tensor, pos: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    T, k = w.shape
    x += (y[pos.long()].view(T, k, -1).float() * w[..., None]).sum(1)
    return x


def combine(x: torch.Tensor, y: torch.Tensor, pos: torch.Tensor,
            w: torch.Tensor) -> torch.Tensor:
    """x [T, D] f32 += sum_j w[t, j] y[pos[t k + j]] (y [T k, D] the expert
    rows in sorted order, w f32 [T, k]), in place; returns x."""
    if _build.run_plain(x):
        return combine_plain(x, y, pos, w)
    T, D = x.shape
    k = w.shape[1]
    if x.dtype != torch.float32 or y.dtype != torch.bfloat16 \
            or not (x.is_contiguous() and y.is_contiguous()
                    and w.is_contiguous() and pos.is_contiguous()) \
            or pos.dtype != torch.int32 or D % 8 or y.shape[1] != D:
        raise ValueError("combine takes f32 x [T, D], bf16 y [T k, D], "
                         "int32 pos and f32 w, contiguous")
    _build.check(_build.library().capdec_moe_combine(
        x.data_ptr(), y.data_ptr(), pos.data_ptr(), w.data_ptr(), T, D, k,
        _build.stream(x.device)), "combine")
    combine.launches += 1
    return x


combine.launches = 0

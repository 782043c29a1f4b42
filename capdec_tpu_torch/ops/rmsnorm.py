"""The residual sum and RMSNorm of models/mla_moe.py's blocks in one pass:
x (f32, the residual stream) += y, or x = y (the step's entry), then
h = x / sqrt(mean(x^2) + eps) * w in f32, in the compute dtype. The
hand-written kernel of csrc/rmsnorm.cu (bf16 y and h), or its plain
version where `_build.run_plain` says so."""
from __future__ import annotations

from typing import Optional

import torch

from . import _build

MAX_D = 2048


def residual_rmsnorm_plain(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                           eps: float, dtype: torch.dtype,
                           assign: bool = False,
                           out: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    if assign:
        x.copy_(y)
    else:
        x += y
    h = (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w).to(dtype)
    if out is None:
        return h
    out.copy_(h)
    return out


def residual_rmsnorm(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                     eps: float, dtype: torch.dtype, assign: bool = False,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, D] f32 += y [B, D] (x = y with `assign`), in place; returns
    h = rmsnorm(x) * w (w f32 [D]) in `dtype`, into `out` when given."""
    if _build.run_plain(x):
        return residual_rmsnorm_plain(x, y, w, eps, dtype, assign, out)
    B, D = x.shape
    if x.dtype != torch.float32 or y.dtype != torch.bfloat16 \
            or dtype != torch.bfloat16 or w.dtype != torch.float32 \
            or not x.is_contiguous() or y.shape != x.shape \
            or y.stride(1) != 1 or y.stride(0) % 8 or D % 8 or D > MAX_D:
        raise ValueError(f"residual_rmsnorm takes f32 x [B, D <= {MAX_D}], "
                         "bf16 y rows and a bf16 h")
    if out is None:
        out = torch.empty(B, D, device=x.device, dtype=dtype)
    _build.check(_build.library().capdec_residual_rmsnorm(
        x.data_ptr(), y.data_ptr(), y.stride(0), w.data_ptr(), out.data_ptr(),
        B, D, eps, int(assign), _build.stream(x.device)), "residual_rmsnorm")
    residual_rmsnorm.launches += 1
    return out


residual_rmsnorm.launches = 0

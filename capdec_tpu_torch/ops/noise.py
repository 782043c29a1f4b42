"""Noise injection, the core CapDec trick (port of capdec_tpu/ops/noise.py).

Simulates the CLIP image/text modality gap during text-only training by
perturbing the caption's CLIP embedding (reference train.py:18-39):
L2-normalise, add Gaussian noise of std sqrt(variance) (or uniform-ball
noise of radius sqrt(variance)), optionally add a precomputed modality
offset, and re-normalise.

The random draws come from an explicit `torch.Generator`, or are given as
tensors: `normal` (the Gaussian noise's standard normal, or the ball's
direction normal) and `uniform` (the ball's radius uniform [B]). The JAX
package draws from a PRNG key; its tests hand both packages the same
draws.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

# torch.nn.functional.normalize clamps the denominator at eps=1e-12.
_NORM_EPS = 1e-12


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / norm.clamp_min(_NORM_EPS)


def uniform_ball_noise(shape, radius: float = 0.1, *,
                       generator: Optional[torch.Generator] = None,
                       device=None, normal: Optional[torch.Tensor] = None,
                       uniform: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Uniform sample inside an L2 ball of `radius` (train.py:18-24):
    direction = normalised Gaussian `normal` [B, D]; radius scaled by
    `uniform`^(1/D) [B] so the density is uniform over the ball's volume.
    Draws not given come from `generator`."""
    if normal is None:
        normal = torch.randn(shape, generator=generator, device=device)
    if uniform is None:
        uniform = torch.rand(shape[0], generator=generator, device=device)
    direction = l2_normalize(normal, dim=1)
    u = uniform ** (1.0 / shape[1])
    return direction * (u * radius)[:, None]


def noise_injection(x: torch.Tensor, variance: float = 0.001,
                    modality_offset: Optional[torch.Tensor] = None,
                    uniform_noise: bool = False, dont_norm: bool = False, *,
                    generator: Optional[torch.Generator] = None,
                    normal: Optional[torch.Tensor] = None,
                    uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reference-parity noise injection (train.py:27-39) of x [B, D].

    variance == 0.0 is an exact passthrough (no normalisation), matching
    the reference's early return. `normal`/`uniform` are the draws (see
    the module docstring); those not given come from `generator`."""
    if variance == 0.0:
        return x
    std = math.sqrt(variance)
    if not dont_norm:
        x = l2_normalize(x, dim=1)
    if uniform_noise:
        x = x + uniform_ball_noise(x.shape, radius=std, generator=generator,
                                   device=x.device, normal=normal,
                                   uniform=uniform)
    else:
        if normal is None:
            normal = torch.randn(x.shape, generator=generator,
                                 device=x.device, dtype=x.dtype)
        x = x + normal * std
    if modality_offset is not None:
        x = x + modality_offset
    return l2_normalize(x, dim=1)

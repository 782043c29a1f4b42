"""Decode stage buckets and staged cache growth (port of
capdec_tpu/decode/staging.py).

The beam engine runs its steps in consecutive stages. Each stage's
bucket is the slot capacity of the generated cache it reads: either the
read bound (`e_cap`) of a cache allocated once at full size, or the size
of a cache that grows between stages (`grow_cache`), so early steps read
and fork-copy a small cache. Boundary contract: the loop counter `i` is
one past the slot being written (`step = i - 1`), and a stage with bucket
`cap` runs while `i <= cap`, so `step < cap`.
"""
from __future__ import annotations

from typing import Dict, List

import torch


def stage_buckets(e_pad: int, stages: int, align: int = 8) -> List[int]:
    """Slot-capacity buckets for `stages` consecutive decode stages."""
    if stages > 1:
        return sorted({min(e_pad, -(-(e_pad * k) // (stages * align)) * align)
                       for k in range(1, stages + 1)})
    return [e_pad]


def check_chunks(buckets: List[int], chunk: int) -> None:
    """Raise unless every bucket is a whole number of `chunk`-slot tiles
    (no-op for chunk 0: the full-read kernels)."""
    bad = [b for b in buckets if chunk and b % chunk]
    if bad:
        raise ValueError(f"stage buckets {bad} are not multiples of "
                         f"fused_slot_chunks ({chunk})")


def grow_cache(gen_cache: Dict[str, torch.Tensor],
               bigger: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Copy each leaf of a generated cache into the leading slice of the
    next stage's larger, zero-filled allocation `bigger` (same keys and
    dtypes) and return `bigger`. The old leaves are freed when the caller
    rebinds the cache. The JAX version skips the copy once every
    sequence stopped; the port's decode loop has already ended then and
    never calls it."""
    if gen_cache.keys() != bigger.keys():
        raise ValueError(f"cache leaves differ: {sorted(gen_cache)} vs "
                         f"{sorted(bigger)}")
    for name, old in gen_cache.items():
        big = bigger[name]
        if big.dtype != old.dtype or big.dim() != old.dim() or \
                any(b < o for b, o in zip(big.shape, old.shape)):
            raise ValueError(f"{name}: cannot grow {tuple(old.shape)} "
                             f"{old.dtype} into {tuple(big.shape)} "
                             f"{big.dtype}")
        big[tuple(slice(0, n) for n in old.shape)] = old
    return bigger

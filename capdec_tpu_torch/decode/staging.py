"""Decode stage buckets (port of capdec_tpu/decode/staging.py::stage_buckets).

The beam engine allocates its generated cache once at full size and runs
its steps in consecutive stages; each stage's bucket is the read bound
(`e_cap`) of the attention kernel, so early steps read a small slice of
the cache. Boundary contract: the loop counter `i` is one past the slot
being written (`step = i - 1`), and a stage with bucket `cap` runs while
`i <= cap`, so `step < cap`.
"""
from __future__ import annotations

from typing import List


def stage_buckets(e_pad: int, stages: int, align: int = 8) -> List[int]:
    """Slot-capacity buckets for `stages` consecutive decode stages."""
    if stages > 1:
        return sorted({min(e_pad, -(-(e_pad * k) // (stages * align)) * align)
                       for k in range(1, stages + 1)})
    return [e_pad]

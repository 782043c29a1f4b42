"""Process-level PyTorch configuration (counterpart of utils/jax_setup.py).

Float32 matrix products and convolutions run in full float32: TF32 keeps
about three decimal digits, which would break the port's float32 parity
with the JAX reference. The entry points resolve their device here, so a
run without a card fails loudly instead of carrying on on the CPU.

Where the rest of `setup_jax` / `force_cpu` went: `debug_nans` is
`setup_torch(debug_nans=True)` (autograd's anomaly mode, which raises on a
NaN in the backward, as `jax_debug_nans` raises on one); the persistent
compile cache is ops/_build.py's hashed build directory (the kernels and
the native BPE library build once and load thereafter); and forcing the
CPU is `resolve_device("cpu")`, which every entry point takes as
`device="cpu"` / `--device cpu`.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def setup_torch(debug_nans: bool = False) -> None:
    """TF32 off; with `debug_nans`, autograd's anomaly mode on (a backward
    that makes a NaN raises, naming the forward op that made it)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if debug_nans:
        torch.autograd.set_detect_anomaly(True)


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another (the tests pass "cpu"). With no card and no explicit device
    this raises."""
    setup_torch()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)

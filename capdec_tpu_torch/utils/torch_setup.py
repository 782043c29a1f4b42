"""Process-level PyTorch configuration (counterpart of utils/jax_setup.py).

Float32 matrix products and convolutions run in full float32: TF32 keeps
about three decimal digits, which would break the port's float32 parity
with the JAX reference. The entry points resolve their device here, so a
run without a card fails loudly instead of carrying on on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def setup_torch() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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

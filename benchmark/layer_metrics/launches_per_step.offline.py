"""Kernel launches on the device per decode step in the traced slice
(kernel events over the decode-step spans begun in it): layer decode
engine (`decode/beam.py`, `decode/staging.py`)."""
from benchmark.layer_metrics import _slice


def read(ctx):
    n = _slice.decode_steps(ctx)
    return None if n is None else len(ctx.trace.kernels) / n

"""Kernel launches on the device per train step in the traced slice:
layer train step (`train/step.py`)."""
from benchmark.layer_metrics import _slice


def read(ctx):
    n = _slice.train_steps(ctx)
    return None if n is None else len(ctx.trace.kernels) / n

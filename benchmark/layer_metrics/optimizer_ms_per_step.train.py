"""Device ms of the optimizer family (AdamW's multi-tensor kernels) per
train step in the traced slice: layer optimizer (`train/optim.py`)."""
from benchmark.layer_metrics import _slice


def read(ctx):
    n = _slice.train_steps(ctx)
    return None if n is None else 1e3 * ctx.trace.family_s("optimizer") / n

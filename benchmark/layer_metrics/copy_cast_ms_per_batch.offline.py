"""Device ms of the copy/cast family (PyTorch's copy and dtype-cast
kernels; the port's K4 is counted with the hand-written kernels) per
batch's worth of decode steps in the traced slice: layer model."""
from benchmark.layer_metrics import _slice


def read(ctx):
    b = _slice.batches(ctx)
    return None if b is None else 1e3 * ctx.trace.family_s("copy/cast") / b

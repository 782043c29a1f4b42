"""Share of the traced slice in which no operation ran on the device:
1 - (union of the device's event intervals) / (the slice's length)."""
from benchmark.layer_metrics import _slice


def read(ctx):
    return _slice.idle_share(ctx)

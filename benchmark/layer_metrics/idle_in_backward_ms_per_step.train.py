"""Device-idle ms under the program's `train.backward` spans (the
backward pass) in the traced slice, per `train.step` span begun in it:
layer train step (`train/step.py`)."""
from benchmark.layer_metrics import _program


def read(ctx):
    return _program.idle_ms_per(ctx, "train.backward", "train.step")

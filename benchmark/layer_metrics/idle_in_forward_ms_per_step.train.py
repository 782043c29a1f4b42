"""Device-idle ms under the program's `train.forward` spans (the batch's
copy to the device, the noise, the forward pass and the loss) in the
traced slice, per `train.step` span begun in it: layer train step
(`train/step.py`)."""
from benchmark.layer_metrics import _program


def read(ctx):
    return _program.idle_ms_per(ctx, "train.forward", "train.step")

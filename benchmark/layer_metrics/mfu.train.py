"""The whole train step's share of the card's bf16 peak, in %: the
frozen matmul count (roofline/train_model.py) of every step begun in the
traced slice over the slice's length and 989 TFLOP/s."""
from benchmark.layer_metrics import _slice
from benchmark.roofline import peaks, train_model


def read(ctx):
    n = _slice.train_steps(ctx)
    if n is None:
        return None
    tr = ctx.traffic
    flops = train_model.train_step_flops(ctx.cfg["model"], tr["batch_size"],
                                         tr["tokens"])
    return 100.0 * n * flops / ctx.trace.window_s / peaks.BF16_FLOPS

"""The whole train step's share of the card's bf16 peak, in %: the
frozen matmul count (the decoder's `train_step_flops`; GPT-2's is
roofline/train_model.py) of every step begun in the traced slice over
the slice's length and 989 TFLOP/s. The count is of the mix's
`batch_size`, which a data-parallel mix gives a rank: so under dp it is
rank 0's steps over one card's peak, a chip's share."""
from benchmark import decoders
from benchmark.layer_metrics import _slice
from benchmark.roofline import peaks


def read(ctx):
    n = _slice.train_steps(ctx)
    if n is None:
        return None
    tr = ctx.traffic
    m = ctx.cfg["model"]
    flops = decoders.of(m).train_step_flops(m, tr["batch_size"], tr["tokens"])
    return 100.0 * n * flops / ctx.trace.window_s / peaks.BF16_FLOPS

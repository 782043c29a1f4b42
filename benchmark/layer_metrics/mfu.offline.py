"""The whole decode's share of the card's bf16 peak, in %: the frozen
model matmul count of a caption (the decoder's `caption_flops`; GPT-2's
is roofline/decode_model.py: mapper,
prefill, every decode step's blocks, attention over the filled slots and
LM head) times the captions' worth of decode steps begun in the traced
slice, over the slice's length and 989 TFLOP/s."""
from benchmark import decoders
from benchmark.layer_metrics import _slice
from benchmark.roofline import peaks


def read(ctx):
    b = _slice.batches(ctx)
    if b is None:
        return None
    d = ctx.cfg["decode"]
    m = ctx.cfg["model"]
    flops = decoders.of(m).caption_flops(m, d["beam_size"], d["entry_length"])
    captions = b * ctx.traffic["batch_size"]
    return 100.0 * captions * flops / ctx.trace.window_s / peaks.BF16_FLOPS

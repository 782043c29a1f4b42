"""K2's share of its roofline in the traced slice, in %: each call's
bound (roofline/decode_attention.py at its decode step, which the
decode-step span that launched it records) over the device time of K2's
kernels. None for a decoder without K2 (its `decode_attention_shape`
is None)."""
from benchmark import decoders
from benchmark.roofline import decode_attention, peaks


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    m = ctx.cfg["model"]
    width = decoders.of(m).decode_attention_shape
    if width is None:
        return None
    ks = t.kernels_matching(decode_attention.KERNELS)
    N = ctx.traffic["batch_size"]
    R = ctx.cfg["decode"]["beam_size"]
    K, D = m["mapper"]["prefix_length"], width(m)
    bound = busy = 0.0
    for (_, s, e), span in t.assign(ks, "decode_step"):
        if span is None or span[4] is None:
            continue
        step = int(span[4])
        bound += peaks.bound_s(decode_attention.flops(N, R, K, D, step),
                               decode_attention.nbytes(N, R, K, D, step))
        busy += (e - s) / 1e9
    return None if busy == 0 else 100.0 * bound / busy

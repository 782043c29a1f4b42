"""K1's share of its roofline in the traced slice, in %: the calls'
bounds (roofline/lm_head.py at the call's shape: batch x beam rows and
the decoder's `lm_head_shape`, its width and vocabulary) over the device
time of K1's kernels."""
from benchmark import decoders
from benchmark.roofline import lm_head, peaks


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    calls = t.kernels_matching(("lm_head_wgmma",))
    ks = t.kernels_matching(lm_head.KERNELS)
    if not calls:
        return None
    m = ctx.cfg["model"]
    B = ctx.traffic["batch_size"] * ctx.cfg["decode"]["beam_size"]
    D, V = decoders.of(m).lm_head_shape(m)
    bound = peaks.bound_s(lm_head.flops(B, D, V),
                          lm_head.nbytes(B, D, V, ctx.cfg["decode"]["beam_size"]))
    busy = sum(e - s for _, s, e in ks) / 1e9
    return 100.0 * len(calls) * bound / busy

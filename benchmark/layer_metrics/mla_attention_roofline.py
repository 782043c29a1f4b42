"""K16's share of its roofline in the traced slice, in %: each call's
bound (roofline/mla_attention.py at its decode step, which the
decode-step span that launched it records) over the device time of
K16's kernels. None where no K16 kernel ran (a decoder without latent
attention)."""
from benchmark.roofline import mla_attention, peaks


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    c = ctx.cfg["model"].get("mla_moe")
    if c is None:
        return None
    ks = t.kernels_matching(mla_attention.KERNELS)
    N = ctx.traffic["batch_size"]
    R = ctx.cfg["decode"]["beam_size"]
    K = ctx.cfg["model"]["mapper"]["prefix_length"]
    shape = dict(H=c["num_attention_heads"], Dl=c["kv_lora_rank"],
                 Dr=c["qk_rope_head_dim"])
    bound = busy = 0.0
    for (_, s, e), span in t.assign(ks, "decode_step"):
        if span is None or span[4] is None:
            continue
        step = int(span[4])
        bound += peaks.bound_s(mla_attention.flops(N, R, K, step, **shape),
                               mla_attention.nbytes(N, R, K, step, **shape))
        busy += (e - s) / 1e9
    return None if busy == 0 else 100.0 * bound / busy

"""Device ms of the decode step's fused epilogues (`ops/epilogue.py`,
csrc/epilogue.cu: the bias adds, casts, GELU, residual sums and layernorms
between a block's products) per batch's worth of decode steps in the
traced slice: layer model. Their kernels, `bias_act` and
`residual_layernorm`, match no key of the frozen family table
(roofline/families.py), so they fall in its `other` family, which
`copy_cast_ms_per_batch.offline` and `gemm_ms_per_batch.offline` do not
read. None where the program has no such kernel (before the epilogues
were fused, the glue ran as PyTorch's copy, cast, elementwise and
layernorm kernels)."""
from benchmark.layer_metrics import _slice

KERNELS = ("bias_act", "residual_layernorm")


def read(ctx):
    b = _slice.batches(ctx)
    if b is None:
        return None
    ks = ctx.trace.kernels_matching(KERNELS)
    return 1e3 * sum(e - s for _, s, e in ks) / 1e9 / b if ks else None

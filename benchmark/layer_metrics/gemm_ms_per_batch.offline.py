"""Device ms of the GEMM family (cuBLAS and CUTLASS products, by the
frozen family table roofline/families.py) per batch's worth of decode
steps in the traced slice: layer model (`models/gpt2.py`,
`models/mappers.py`)."""
from benchmark.layer_metrics import _slice


def read(ctx):
    b = _slice.batches(ctx)
    return None if b is None else 1e3 * ctx.trace.family_s("gemm") / b

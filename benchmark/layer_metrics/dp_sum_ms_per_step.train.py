"""Device ms of the data-parallel sums (NCCL's kernels: the gradients'
all-reduces in flat buckets and the two scalar sums of the loss,
`parallel/mesh.py`) per train step in rank 0's traced slice: layer data
parallel. A collective's kernel runs from its launch until every rank
has joined, so the time holds the wait for the slowest rank beside the
transfer. None where the slice has no such kernel (one card, or gloo on
the CPU)."""
from benchmark.layer_metrics import _slice

KERNELS = ("nccl",)


def read(ctx):
    n = _slice.train_steps(ctx)
    if n is None:
        return None
    ks = ctx.trace.kernels_matching(KERNELS)
    return 1e3 * sum(e - s for _, s, e in ks) / 1e9 / n if ks else None

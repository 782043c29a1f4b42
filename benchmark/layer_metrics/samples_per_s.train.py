"""The window's training rate, samples/s: every sample stepped in the
window over its length, the global batch under dp, on rank 0's clock
(drivers/train.py's counter `samples_per_s`); layer whole train step. The
host's speed sets it and moves it 15-19 % between runs, so it stands here,
with no bound, and not among the end-to-end metrics. In a traced run the
profiled slice's steps run slower than the others."""


def read(ctx):
    return ctx.counters.get("samples_per_s")

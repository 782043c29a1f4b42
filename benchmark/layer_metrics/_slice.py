"""Readings of the traced slice that several metrics share."""


def decode_steps(ctx):
    """Decode steps whose span began in the slice, or None."""
    t = ctx.trace
    if t is None or not t.has_device_events:
        return None
    n = len(t.spans_named("decode_step"))
    return n or None


def batches(ctx):
    """Batches' worth of decode steps in the slice (every batch runs all
    entry_length - 1 steps), or None."""
    n = decode_steps(ctx)
    return None if n is None else n / (ctx.cfg["decode"]["entry_length"] - 1)


def train_steps(ctx):
    t = ctx.trace
    if t is None or not t.has_device_events:
        return None
    return len(t.spans_named("train_step")) or None


def idle_share(ctx):
    t = ctx.trace
    if t is None or not t.has_device_events or t.window_s <= 0:
        return None
    return 1.0 - t.busy_s / t.window_s

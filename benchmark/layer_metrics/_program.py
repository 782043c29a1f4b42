"""Readings of the program's own spans (`capdec_tpu_torch.utils.
profiling`: name, start_ns, end_ns, id, parent, meta; recorded while the
traced slice's profiler is open) against the device events of the slice.

A program without those spans reads None, as does a slice with no device
events. "Idle under a span" is the part of the span's interval, clipped
to the slice, in which no device event runs.
"""


def spans(ctx):
    """The program's spans that overlap the traced slice, or None."""
    t = ctx.trace
    if t is None or not t.has_device_events:
        return None
    try:
        from capdec_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "spans", None)
    if recorded is None:
        return None
    return [s for s in recorded() if s.end_ns > t.t0 and s.start_ns < t.t1]


def begun(spans, name, t):
    """The spans named `name` that began in the slice, by start."""
    return sorted((s for s in spans if s.name == name and t.t0 <= s.start_ns
                   < t.t1), key=lambda s: s.start_ns)


def idle_ns(busy, t, start, end):
    """Device-idle ns in [start, end] clipped to the slice, `busy` being
    the union of its device events (`t._union()`)."""
    start, end = max(start, t.t0), min(end, t.t1)
    if end <= start:
        return 0
    covered = sum(max(0, min(e, end) - max(s, start)) for s, e in busy
                  if s < end and e > start)
    return end - start - covered


def idle_ms_per(ctx, under, per):
    """Device-idle ms under the spans named `under`, over the number of
    spans named `per` begun in the slice, or None."""
    sp = spans(ctx)
    if sp is None:
        return None
    t = ctx.trace
    n = len(begun(sp, per, t))
    if not n:
        return None
    busy = t._union()
    idle = sum(idle_ns(busy, t, s.start_ns, s.end_ns) for s in sp
               if s.name == under)
    return idle / 1e6 / n

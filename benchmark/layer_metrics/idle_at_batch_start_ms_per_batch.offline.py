"""Device-idle ms under each program `decode.batch` span begun in the
traced slice before its first `decode.step` (the batch's copy to the
device, the mapper, the prefill and the first top-R), per such batch:
layer decode engine (`serve.py::_decode`, `decode/beam.py`)."""
from benchmark.layer_metrics import _program


def read(ctx):
    sp = _program.spans(ctx)
    if sp is None:
        return None
    t = ctx.trace
    batches = _program.begun(sp, "decode.batch", t)
    if not batches:
        return None
    first = {}
    for s in sp:
        if s.name == "decode.step" and s.parent is not None:
            first[s.parent] = min(first.get(s.parent, s.start_ns), s.start_ns)
    busy = t._union()
    idle = sum(_program.idle_ns(busy, t, b.start_ns,
                                min(first.get(b.id, b.end_ns), b.end_ns))
               for b in batches)
    return idle / 1e6 / len(batches)

"""The host's time to issue a decode step, in ms: over the program's
`decode.step` spans begun in the traced slice that hold a
`decode.stop_flag` read, the mean of that read's start less the step's
start (the flag read is the step's one wait on the device): layer decode
engine (`decode/beam.py`)."""
from benchmark.layer_metrics import _program


def read(ctx):
    sp = _program.spans(ctx)
    if sp is None:
        return None
    flag = {}
    for s in sp:
        if s.name == "decode.stop_flag" and s.parent is not None:
            flag.setdefault(s.parent, s.start_ns)
    issue = [flag[s.id] - s.start_ns
             for s in _program.begun(sp, "decode.step", ctx.trace)
             if s.id in flag]
    return sum(issue) / len(issue) / 1e6 if issue else None

"""Device-idle ms under the program's `serve.detokenize` spans (the
serving thread turning a finished batch's tokens into text) in the
traced slice, per `decode.batch` span begun in it: layer serve
(`serve.py`)."""
from benchmark.layer_metrics import _program


def read(ctx):
    return _program.idle_ms_per(ctx, "serve.detokenize", "decode.batch")

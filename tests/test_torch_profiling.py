"""The port's profiling and process setup (capdec_tpu_torch/utils/
profiling.py, utils/torch_setup.py) against the JAX package's modules of
the same names.

  * `trace(log_dir)` writes a Chrome trace of the block on the CPU, and
    `summarize_trace` sums its complete ("X") events by name in ms, the
    largest first, as the JAX summary does over a jax.profiler trace;
    `print_trace_summary` prints the JAX module's lines.
  * `setup_torch(debug_nans=True)` raises on a NaN in the backward (the
    counterpart of jax_debug_nans), and without it the backward runs.
"""
import json
import os

import pytest
import torch

from capdec_tpu.utils import profiling as jax_profiling
from capdec_tpu_torch.utils import profiling, torch_setup


def test_trace_and_summary_on_the_cpu(tmp_path, capsys):
    d = str(tmp_path / "trace")
    a = torch.randn(64, 64)
    with profiling.trace(d) as where:
        assert where == d
        for _ in range(3):
            (a @ a).relu_()
    files = [f for f in os.listdir(d) if f.endswith(".trace.json")]
    assert len(files) == 1
    with open(os.path.join(d, files[0])) as f:
        events = json.load(f)["traceEvents"]
    want = {}
    for e in events:
        if e.get("ph") == "X":
            want[e["name"]] = want.get(e["name"], 0) + e.get("dur", 0)
    summary = profiling.summarize_trace(d, top=5)
    assert 0 < len(summary) <= 5
    assert list(summary.values()) == sorted(summary.values(), reverse=True)
    for name, ms in summary.items():
        assert ms == pytest.approx(want[name] / 1000.0)
    assert any("mm" in n or "matmul" in n for n in
               profiling.summarize_trace(d, top=50))
    profiling.print_trace_summary(d, top=2)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and all(" ms  " in x for x in lines)
    # the JAX module's summary of a missing trace is empty, as here
    assert profiling.summarize_trace(str(tmp_path / "none")) == {} == \
        jax_profiling.summarize_trace(str(tmp_path / "none"))


def test_debug_nans_raises_on_a_nan_backward():
    def nan_backward():
        x = torch.tensor([-1.0, 4.0], requires_grad=True)
        torch.sqrt(x).sum().backward()
        return x.grad

    assert torch.isnan(nan_backward()).any()  # no check: NaN passes
    try:
        torch_setup.setup_torch(debug_nans=True)
        assert torch.is_anomaly_enabled()
        with pytest.raises(RuntimeError, match="nan"), \
                pytest.warns(UserWarning, match="Error detected in Sqrt"):
            nan_backward()
    finally:
        torch.autograd.set_detect_anomaly(False)
    torch_setup.setup_torch()
    assert not torch.is_anomaly_enabled()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch_setup.resolve_device("cpu") == torch.device("cpu")

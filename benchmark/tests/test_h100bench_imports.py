"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
the reference imports nothing of the program, and no file reads the JAX
package's benchmark records."""
from __future__ import annotations

import ast

import pytest

from h100bench_helpers import ROOT

BENCH_DIR = ROOT / "benchmark"
SOURCES = sorted(p for p in BENCH_DIR.rglob("*.py") if "tests" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "capdec_tpu"}


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    assert "capdec_tpu_torch" not in set(top_level_imports(path))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_records_read(path):
    text = path.read_text()
    for name in ("bench.py", "BENCH_r", "MULTICHIP_r", "BASELINE.json"):
        assert name not in text


def test_top_level_name_compared_whole():
    from benchmark import common
    import sys
    import types
    sys.modules["capdec_tpu_torch_probe"] = types.ModuleType("x")
    try:
        assert "capdec_tpu" not in common.forbidden_loaded()
    finally:
        del sys.modules["capdec_tpu_torch_probe"]

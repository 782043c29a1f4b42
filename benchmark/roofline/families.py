"""Kernel families by name, frozen with the benchmark.

The port's hand-written kernels come first, so that K4
(`copy_forked_rows_bounded`) does not count as a copy; the rest is the
family table of the port's `scripts/torch_train_profile.py` as it stood
when the benchmark was written (first match wins)."""
from __future__ import annotations

FAMILIES = (
    ("hand-written", ("lm_head_wgmma", "lm_head_fma", "lm_head_merge",
                      "async_attn", "write_gen_slot", "copy_forked_rows",
                      "gather_spans", "empty_grid")),
    ("gemm", ("gemm", "xmma", "nvjet", "cutlass", "matmul")),
    ("optimizer", ("multi_tensor", "adam", "Adam")),
    ("softmax", ("softmax",)),
    ("layernorm", ("layer_norm", "LayerNorm")),
    ("index/gather/scatter", ("index", "gather", "scatter", "embedding")),
    ("reduction", ("reduce", "Reduce")),
    ("copy/cast", ("copy", "Copy")),
    ("elementwise", ("elementwise",)),
    ("fill", ("fill",)),
)


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"

"""Build and bind the hand-written Hopper kernels (capdec_tpu_torch/csrc).

At first use, every `csrc/*.cu` is compiled by its own `nvcc` process (all
started together) for `sm_90a`, and the objects are linked into one shared
library with a plain C interface, loaded with `ctypes`. The library sits
under `capdec_tpu_torch/_build/` (git-ignored), named by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one
loads in milliseconds. Each compile's `-Xptxas -v` report (registers,
shared memory, spills) is kept beside the library as `<name>.log`.

Every C entry launches on the stream it is given and returns
`cudaGetLastError()`; `check` raises on a non-zero code.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float

# The parameter struct of K3, K13 and K14 (csrc/cache_reorder.cu
# LayerSources), passed by pointer and copied by value into the launch:
# each layer's K and V base pointers and row strides in 16-byte words.
SLOT_MAX_LAYERS = 64


class LayerSources(ctypes.Structure):
    _fields_ = [("k", P * SLOT_MAX_LAYERS), ("v", P * SLOT_MAX_LAYERS),
                ("k_row16", I * SLOT_MAX_LAYERS),
                ("v_row16", I * SLOT_MAX_LAYERS)]


# C entry -> argument types (pointers and the stream as c_void_p)
SIGNATURES = {
    "capdec_lm_head_topk":
        [P, P, I, I, I, I, I, *[P] * 7, I, I, I, I, I, I, P],
    "capdec_beam_decode_attention_rowmajor":
        [P, P, P, L, *[P] * 5, *[I] * 14, P],
    "capdec_write_gen_slot":
        [P, P, ctypes.POINTER(LayerSources), I, I, I, I, L, I, I, I, P],
    "capdec_copy_forked_rows_bounded": [P, P, P, I, I, I, I, L, I, P],
    "capdec_write_gen_slot_q": [*[P] * 6, *[I] * 8, P],
    "capdec_beam_decode_attention_rowmajor_q":
        [P, P, P, L, *[P] * 7, *[I] * 14, P],
    "capdec_copy_forked_rows": [P, P, P, I, L, P],
    "capdec_beam_decode_attention_chunked":
        [P, P, P, L, *[P] * 5, *[I] * 14, P],
    "capdec_beam_decode_attention_chunked_q":
        [P, P, P, L, *[P] * 9, *[I] * 14, P],
    "capdec_write_gen_slot_seqmajor":
        [P, P, ctypes.POINTER(LayerSources), I, I, I, I, L, I, I, I, P],
    "capdec_empty_grid": [I, I, P],
    "capdec_gather_rows": [P, P, P, P, P, I, I, I, L, L, P],
    "capdec_beam_decode_attention": [P, P, P, L, *[P] * 5, *[I] * 14, P],
    "capdec_bias_act": [P, P, P, I, I, I, I, I, P],
    "capdec_residual_layernorm":
        [*[P] * 7, I, I, ctypes.c_float, I, I, I, P],
    "capdec_write_gen_slot_one":
        [P, ctypes.POINTER(LayerSources), I, I, I, I, L, I, I, I, P],
    "capdec_copy_forked_rows_bounded_one": [P, P, I, I, I, I, L, I, P],
    "capdec_mla_decode_attention":
        [P, P, L, L, P, L, P, P, P, *[I] * 7, F, I, P],
    "capdec_mla_prep": [P, L, P, L, P, P, P, F, P, L, I, I, P],
    "capdec_moe_route": [P, P, I, I, I, I, F, P, P, P],
    "capdec_moe_dispatch": [P, I, I, I, P, P, P, P, P],
    "capdec_swiglu": [P, L, P, L, P, L, I, I, P],
    "capdec_moe_combine": [P, P, P, P, I, I, I, P],
    "capdec_residual_rmsnorm": [P, P, L, P, P, I, I, F, I, P],
}

build_seconds = 0.0  # wall time of the build this process ran (0: cached)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (home and os.path.join(home, "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the kernels build with the CUDA "
                       "toolkit (set CUDA_HOME)")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    sources, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libcapdec_kernels_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    global build_seconds
    t0 = time.perf_counter()
    nvcc = _nvcc()
    sources, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        procs = [(src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
             str(tmp / (src.stem + ".o"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src in sources]
        logs, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode:
                failed.append(src.name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp / so.name),
             *[str(tmp / (s.stem + ".o")) for s in sources]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        so.with_suffix(".log").write_text(log)
        os.replace(tmp / so.name, so)  # atomic: concurrent builds agree
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    build_seconds = time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel library, built first if its sources changed."""
    so = library_path()
    if not so.exists():
        _build(so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def on_cpu(t) -> bool:
    """True for a CPU tensor (the wrapper runs its plain version), False
    for a CUDA tensor (the wrapper launches its kernel); raises for any
    other device."""
    if t.is_cuda:
        return False
    if not t.is_cpu:
        raise ValueError(f"kernels run on cuda (or plain on cpu), got "
                         f"{t.device}")
    return True


def check(code: int, name: str) -> None:
    if code:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def stream(device) -> int:
    """The handle of PyTorch's current stream on `device` (a CUDA
    torch.device or its index), read without building a Stream object."""
    index = device if isinstance(device, int) else device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The streaming multiprocessors of the card `device`."""
    return torch.cuda.get_device_properties(device).multi_processor_count


# dtype codes of the C entries (csrc/common.cuh DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return code

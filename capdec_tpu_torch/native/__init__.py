"""Native (C++) host components, built at first use (port of
capdec_tpu/native/__init__.py).

`bpe.cpp` (the GPT-2 BPE merge loop; the port's own copy of
capdec_tpu/native/bpe.cpp) is compiled with `g++` into
`capdec_tpu_torch/_build/` (git-ignored), the directory the CUDA kernels
build into, under a name that holds a hash of the source and flags, as
ops/_build.py names the kernel library: an edited source rebuilds, an
unchanged one loads at once. No binary is committed.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import tempfile
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent / "_build"
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]


def build_library(name: str, sources) -> str:
    """Compile `sources` (files of this directory) into
    _build/{name}-{hash}.so unless it is there; returns its path. Raises
    when the compiler fails."""
    srcs = [NATIVE_DIR / s for s in sources]
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for s in srcs:
        h.update(s.read_bytes())
    so_path = BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"
    if so_path.is_file():
        return str(so_path)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a process of its own name, then one rename: concurrent builders
    # never see half a library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, *map(str, srcs), "-o", tmp],
                       check=True, capture_output=True)
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return str(so_path)


def try_load(name: str, sources):
    """Build and load with ctypes; None (and a note on stderr) when there
    is no toolchain."""
    import ctypes
    try:
        return ctypes.CDLL(build_library(name, sources))
    except Exception as e:
        print(f"[capdec_tpu_torch.native] {name} unavailable: {e}",
              file=sys.stderr)
        return None

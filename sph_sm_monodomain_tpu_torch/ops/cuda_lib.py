"""Build and load the port's CUDA kernels (csrc/*.cu) through ctypes.

The sources are compiled with `nvcc` for Hopper (`sm_90a`) into a shared
library with a plain C interface, at first use, into
`<checkout>/build/torch_kernels/` (git-ignored). The file name carries a
hash of the sources and flags, so an edited source builds anew and an
unchanged one is reused. Nothing here runs at import time: the CPU tests
import this module on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("fused_sweeps.cu",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# no --use_fast_math: IEEE division and sqrt, as the reference computes them
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: (pointer args, int args) before the trailing stream
_SIGNATURES = {
    "sph_sweep_a3": [_P] * 6 + [_I] * 8 + [_P],
    "sph_sweep_b3": [_P] * 6 + [_I] * 4 + [_P],
}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, PATH, or the toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) \
            + [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from source at first use")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libsph_sweeps_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a library of the same sources exists.
    `verbose` adds `-Xptxas -v` (registers, shared memory and spills per
    kernel) and prints the compiler's output."""
    path = library_path()
    if path.exists() and not verbose:
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *(str(CSRC_DIR / s) for s in SOURCES)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if verbose:
            print(res.stdout + res.stderr, flush=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, path)  # atomic: a reader never sees a partial file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load() -> ctypes.CDLL:
    """The kernel library, built at first use and then cached."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.sph_cuda_error_string.argtypes = [ctypes.c_int]
            lib.sph_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def error_string(code: int) -> str:
    return load().sph_cuda_error_string(code).decode()

"""Build and load the port's CUDA kernels (csrc/*.cu) through ctypes.

The sources are compiled with `nvcc` for Hopper (`sm_90a`), one nvcc
process per source, all started together, and linked into one shared
library with a plain C interface, at first use, into
`<checkout>/build/torch_kernels/` (git-ignored). The file name carries a
hash of the sources, headers and flags, so an edited source builds anew and
an unchanged one is reused. Nothing here runs at import time: the CPU tests
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
SOURCES = ("fused_sweeps.cu", "fused_adjoint.cu", "legacy_sweeps.cu",
           "roofline.cu")
HEADERS = ("sweep_common.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# no --use_fast_math: IEEE division and sqrt, as the reference computes them
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: (pointer args, int args) before the trailing stream
_SIGNATURES = {
    "sph_sweep_a3": [_P] * 6 + [_I] * 8 + [_P],
    "sph_sweep_b3": [_P] * 6 + [_I] * 4 + [_P],
    "sph_sweep_a3_hash9": [_P] * 6 + [_I] * 8 + [_P],
    "sph_sweep_b3_hash9": [_P] * 6 + [_I] * 5 + [_P],
    "sph_sweep_a5": [_P] * 5 + [_I] * 9 + [_P],
    "sph_sweep_b5": [_P] * 5 + [_I] * 6 + [_P],
    "sph_sweep_lap3": [_P] * 6 + [_I] * 3 + [_P],
    "sph_sweep_bwd_a": [_P] * 6 + [_I] * 3 + [_P],
    "sph_sweep_bwd_b": [_P] * 6 + [_I] * 3 + [_P],
    "sph_sweep_a1": [_P] * 6 + [_I] + [_P],
    "sph_sweep_b1": [_P] * 6 + [_I] + [_P],
    "sph_sweep_a2": [_P] * 6 + [_I] * 4 + [_P],
    "sph_sweep_b2": [_P] * 6 + [_I] * 4 + [_P],
    "sph_fma_chains": [_P] * 2 + [_I] * 3 + [_P],
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


def library_path(csrc: Path | None = None,
                 build_dir: Path | None = None) -> Path:
    csrc, build_dir = csrc or CSRC_DIR, build_dir or BUILD_DIR
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((csrc / name).read_bytes())
    return build_dir / f"libsph_sweeps_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]], verbose: bool) -> None:
    """Run the commands in parallel, wait for every one, and raise if any
    failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if verbose:
            print(out, flush=True)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")


def build(verbose: bool = False, csrc: Path | None = None,
          build_dir: Path | None = None) -> Path:
    """Compile the kernels unless a library of the same sources exists.
    `verbose` adds `-Xptxas -v` (registers, shared memory and spills per
    kernel) and prints the compiler's output. `csrc` and `build_dir` build
    another copy of the sources elsewhere (compare_builds.py)."""
    csrc = csrc or CSRC_DIR
    path = library_path(csrc, build_dir)
    if path.exists() and not verbose:
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=path.parent) as tmp:
        objs = [str(Path(tmp) / f"{Path(s).stem}.o") for s in SOURCES]
        _run_all([[nvcc, *NVCC_FLAGS,
                   *(["-Xptxas", "-v"] if verbose else []), "-c", "-o", o,
                   str(csrc / s)] for s, o in zip(SOURCES, objs)],
                 verbose)
        lib = str(Path(tmp) / path.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]], verbose)
        os.replace(lib, path)  # atomic: a reader never sees a partial file
    return path


def bind(path: Path) -> ctypes.CDLL:
    """The library at `path` with the C entry points' signatures set."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.sph_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sph_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built at first use and then cached."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(build())
        return _lib


def error_string(code: int) -> str:
    return load().sph_cuda_error_string(code).decode()

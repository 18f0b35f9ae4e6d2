"""Native (C++) host I/O helpers, loaded via ctypes with Python fallbacks
(mirror of `sph_sm_monodomain_tpu.runtime`).

  - `parse_cloud_csv`: fast CSV point-cloud parser (reference loader
    semantics, main.cpp:145-179); `utils/io.read_cloud_csv` is the numpy
    reader it is held equal to;
  - `TrajectoryWriter`: background-thread binary frame streamer, file
    format "SPHT0001" (header {magic[8], int64 n_particles, int64
    fields_per_particle}, then frames {int64 step, float32
    payload[n * fields]}), read back by `read_trajectory`.

The port keeps its own copies of the sources (`csv_loader.cpp`,
`traj_writer.cpp`, the JAX package's C ABI). At first use they are
compiled with the host's C++ compiler (`$CXX`, else g++) into
`<checkout>/build/torch_runtime/libsphsm_runtime_<source hash>.so`
(git-ignored). This is host I/O, not a kernel: where no compiler exists
every entry point falls back to pure Python, and `native_available()`
says which one runs.
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

import numpy as np

_DIR = Path(__file__).resolve().parent
SOURCES = ("csv_loader.cpp", "traj_writer.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_runtime"
_lib = None
_lib_lock = threading.Lock()


def _library_path() -> Path:
    h = hashlib.sha256()
    for s in SOURCES:
        h.update((_DIR / s).read_bytes())
    return BUILD_DIR / f"libsphsm_runtime_{h.hexdigest()[:12]}.so"


def _build(path: Path) -> None:
    """Compile the sources into `path` (through a temporary file renamed
    into place, so concurrent builders never load a half-written file)."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise FileNotFoundError("no C++ compiler ($CXX or g++)")
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    try:
        subprocess.run([cxx, "-O3", "-std=c++17", "-Wall", "-fPIC",
                        "-shared", "-pthread", "-o", tmp]
                       + [str(_DIR / s) for s in SOURCES],
                       check=True, capture_output=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> ctypes.CDLL | None:
    """Build (if needed) and load the native library; None on failure."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib or None
        try:
            path = _library_path()
            if not path.exists():
                _build(path)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError:
                # built on another host (a copied checkout): build again
                _build(path)
                lib = ctypes.CDLL(str(path))
            lib.sphsm_parse_cloud_csv.restype = ctypes.c_longlong
            lib.sphsm_parse_cloud_csv.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_longlong)]
            lib.sphsm_traj_open.restype = ctypes.c_void_p
            lib.sphsm_traj_open.argtypes = [ctypes.c_char_p,
                                            ctypes.c_longlong,
                                            ctypes.c_longlong]
            lib.sphsm_traj_append.restype = ctypes.c_longlong
            lib.sphsm_traj_append.argtypes = [
                ctypes.c_void_p, ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_float)]
            lib.sphsm_traj_close.restype = ctypes.c_longlong
            lib.sphsm_traj_close.argtypes = [ctypes.c_void_p]
            _lib = lib
        except (OSError, subprocess.CalledProcessError, AttributeError):
            _lib = False  # cache the failure: the Python fallbacks run
        return _lib or None


def native_available() -> bool:
    return _load() is not None


def parse_cloud_csv(path, subsample_freq: int = 0,
                    subsample_after: int = 3000,
                    capacity: int = 2_000_000) -> np.ndarray | None:
    """Native CSV parse; returns (N, 3) float32 or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    total = ctypes.c_longlong(0)

    def parse(cap):
        out = np.empty((cap, 3), dtype=np.float32)
        n = lib.sphsm_parse_cloud_csv(
            str(path).encode(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            cap, subsample_freq, subsample_after, ctypes.byref(total))
        if n < 0:
            raise FileNotFoundError(path)
        return out, n

    out, n = parse(capacity)
    if n >= capacity and total.value > capacity:
        # the capacity truncated the kept rows (the numpy reader has no
        # cap); the total of data rows is an exact upper bound
        out, n = parse(int(total.value))
    return out[:n].copy()


class TrajectoryWriter:
    """Stream (step, payload) frames to disk off the hot loop.

    payload = concatenated float32 per-particle fields, `fields` per
    particle (e.g. 4 for [pos3, vm]). Uses the native background-thread
    writer when available (`native=None` or True), else a synchronous
    Python writer of the same bytes (`native=False` asks for it).
    `close()` returns the number of frames written.
    """

    MAGIC = b"SPHT0001"

    def __init__(self, path, n_particles: int, fields: int = 4,
                 native: bool | None = None):
        self.path = str(path)
        self.n = int(n_particles)
        self.fields = int(fields)
        self._lib = _load() if native is not False else None
        if native and self._lib is None:
            raise RuntimeError("the native trajectory writer did not build")
        self._handle = None
        self._file = None
        self._frames = 0
        if self._lib is not None:
            self._handle = self._lib.sphsm_traj_open(
                self.path.encode(), self.n, self.fields)
        if self._handle is None:
            self._lib = None
            self._file = open(self.path, "wb")
            self._file.write(self.MAGIC)
            np.asarray([self.n, self.fields], np.int64).tofile(self._file)

    @property
    def native(self) -> bool:
        return self._lib is not None

    def append(self, step: int, payload: np.ndarray) -> None:
        payload = np.ascontiguousarray(payload, dtype=np.float32)
        if payload.size != self.n * self.fields:
            raise ValueError(f"payload size {payload.size} != "
                             f"{self.n * self.fields}")
        if self._lib is not None:
            self._lib.sphsm_traj_append(
                self._handle, int(step),
                payload.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        else:
            np.asarray([step], np.int64).tofile(self._file)
            payload.tofile(self._file)
            self._frames += 1

    def close(self) -> int:
        if self._lib is not None:
            n = int(self._lib.sphsm_traj_close(self._handle))
            self._handle = None
            self._lib = None
            if n < 0:
                raise IOError(
                    f"trajectory writer hit a disk write error on "
                    f"{self.path} ({-n - 1} frames written before it); "
                    "the file is truncated")
            self._frames = n
        elif self._file:
            self._file.close()
            self._file = None
        return self._frames

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_trajectory(path):
    """Read a trajectory file -> (steps (T,), payload (T, N, fields))."""
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != TrajectoryWriter.MAGIC:
            raise ValueError(f"bad trajectory magic {magic!r}")
        n, fields = (int(v) for v in np.fromfile(f, np.int64, 2))
        data = f.read()
    frame_bytes = 8 + 4 * n * fields
    t = len(data) // frame_bytes
    steps = np.empty(t, np.int64)
    payload = np.empty((t, n, fields), np.float32)
    for i in range(t):
        off = i * frame_bytes
        steps[i] = np.frombuffer(data, np.int64, 1, off)[0]
        payload[i] = np.frombuffer(data, np.float32, n * fields,
                                   off + 8).reshape(n, fields)
    return steps, payload

"""PyTorch port vs the JAX package: the native host runtime
(runtime/__init__.py, its own copies of csv_loader.cpp and
traj_writer.cpp). Trajectory files must be byte-compatible both ways
("SPHT0001"), the native and Python writers must write the same bytes, and
the CSV parser must give exactly the points of the JAX package's parser and
of the port's numpy reader (after tests/test_runtime.py:31-71)."""

import numpy as np
import pytest

from sph_sm_monodomain_tpu import runtime as jrt
from sph_sm_monodomain_tpu.utils import io as jio
from sph_sm_monodomain_tpu_torch import runtime as trt
from sph_sm_monodomain_tpu_torch.utils import io as tio

CSV = tio.ASSETS_DIR / "biceps_simple_out_18475.csv"


def _need_native():
    """Skip where the host has no C++ compiler (decided in the test, not
    at import)."""
    if not trt.native_available():
        pytest.skip("no C++ compiler on this host")


def _payloads(rng, frames=5, n=64, fields=4):
    return rng.random((frames, n, fields)).astype(np.float32)


def _write(writer_cls, path, payloads, **kw):
    """Write `payloads` at steps 0, 10, ...; returns (whether the writer
    ran native, the frame count its close() gave)."""
    frames, n, fields = payloads.shape
    w = writer_cls(path, n, fields, **kw)
    native = getattr(w, "native", None)
    for i in range(frames):
        w.append(i * 10, payloads[i])
    return native, w.close()


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_port_trajectory_reads_in_jax(tmp_path, rng, native):
    if native:
        _need_native()
    p = _payloads(rng)
    path = tmp_path / "t.bin"
    assert _write(trt.TrajectoryWriter, path, p, native=native) == \
        (native, len(p))
    steps, data = jrt.read_trajectory(path)
    np.testing.assert_array_equal(steps, np.arange(len(p)) * 10)
    np.testing.assert_array_equal(data, p)
    t_steps, t_data = trt.read_trajectory(path)
    np.testing.assert_array_equal(t_steps, steps)
    np.testing.assert_array_equal(t_data, data)


def test_jax_trajectory_reads_in_port(tmp_path, rng):
    p = _payloads(rng, frames=3, n=17, fields=4)
    path = tmp_path / "j.bin"
    _write(jrt.TrajectoryWriter, path, p)
    steps, data = trt.read_trajectory(path)
    np.testing.assert_array_equal(steps, [0, 10, 20])
    np.testing.assert_array_equal(data, p)


def test_native_and_python_writers_write_the_same_bytes(tmp_path, rng):
    _need_native()
    p = _payloads(rng, frames=4, n=33, fields=3)
    a, b = tmp_path / "native.bin", tmp_path / "python.bin"
    _write(trt.TrajectoryWriter, a, p, native=True)
    _write(trt.TrajectoryWriter, b, p, native=False)
    assert a.read_bytes() == b.read_bytes()
    assert a.read_bytes()[:8] == b"SPHT0001"


def test_trajectory_payload_size_is_checked(tmp_path):
    with trt.TrajectoryWriter(tmp_path / "x.bin", 4, 4) as w:
        with pytest.raises(ValueError):
            w.append(0, np.zeros(15, np.float32))
    with open(tmp_path / "bad.bin", "wb") as f:
        f.write(b"NOTATRAJ")
    with pytest.raises(ValueError):
        trt.read_trajectory(tmp_path / "bad.bin")


@pytest.mark.parametrize("freq", [0, 7])
def test_native_csv_matches_jax_and_numpy_reader(freq):
    _need_native()
    got = trt.parse_cloud_csv(CSV, subsample_freq=freq)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, tio.read_cloud_csv(
        CSV, subsample_freq=freq))
    np.testing.assert_array_equal(got, jio.read_cloud_csv(
        CSV, subsample_freq=freq))
    j = jrt.parse_cloud_csv(CSV, subsample_freq=freq)
    if j is not None:   # the JAX package's native parser, where it built
        np.testing.assert_array_equal(got, j)
    # the reference rule: 5,211 points at freq 7
    assert got.shape == ((18475, 3) if freq == 0 else (5211, 3))


def test_native_csv_capacity_regrow_and_missing_file(tmp_path):
    """An undersized capacity must not truncate: the wrapper reparses with
    the exact row total. A missing file raises."""
    _need_native()
    full = trt.parse_cloud_csv(CSV)
    small = trt.parse_cloud_csv(CSV, capacity=4)
    assert small.shape == full.shape == (18475, 3)
    np.testing.assert_array_equal(small, full)
    with pytest.raises(FileNotFoundError):
        trt.parse_cloud_csv(tmp_path / "nope.csv")

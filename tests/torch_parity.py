"""Helpers shared by the tests that hold the PyTorch port
(sph_sm_monodomain_tpu_torch) to the JAX package on the same inputs.

Inputs are made once with numpy and handed to both packages; JAX stays on
the CPU (tests/conftest.py), its Pallas kernels in interpret mode, and the
port runs on CPU tensors, i.e. through the plain versions of its kernels.
"""

import dataclasses

import numpy as np

import sph_sm_monodomain_tpu as J
import sph_sm_monodomain_tpu_torch as T


def torch_cfg(jcfg):
    """The port's SimConfig equal to a JAX-package SimConfig."""
    return T.config_from_dict(dataclasses.asdict(jcfg))


def jax_state_arrays(js) -> dict:
    return {f.name: np.asarray(getattr(js, f.name))
            for f in dataclasses.fields(js)}


def to_torch_state(js):
    return T.state_from_numpy(jax_state_arrays(js))


def assert_bit_equal(a, b, what=""):
    """Same dtype, shape and bits (so -0.0 != 0.0 and NaNs must match)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, \
        (what, a.dtype, b.dtype, a.shape, b.shape)
    if a.dtype.kind == "f":
        a = a.view(np.uint32 if a.itemsize == 4 else np.uint64)
        b = b.view(a.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def random_state(jcfg, n=200, seed=0):
    """A JAX-package state with non-trivial fields: a Gaussian blob around
    (0.6, 0.6, 0.6), stimulated in a sphere, with random corrected
    velocities, voltages, recovery variables and densities."""
    rng = np.random.default_rng(seed)
    pts = np.clip(rng.normal(size=(n, 3)).astype(np.float32) * 0.05 + 0.6,
                  0.05, 1.2)
    js = J.init_fluid(pts, jcfg)
    js = J.stim.set_stim(js, (0.6, 0.6, 0.6), 0.3, jcfg.stim_strength, jcfg)
    cap = js.capacity
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return js.replace(
        corrected_vel=f32(rng.normal(size=(cap, 3)) * 0.1),
        vm=f32(rng.normal(size=(cap,)) * 10.0),
        w=f32(rng.normal(size=(cap,)) * 1e-3),
        iion=f32(rng.normal(size=(cap,)) * 1e-3),
        dens=f32(jcfg.stand_density + rng.normal(size=(cap,)) * 20.0))


def biceps_slice_points(every: int = 40) -> np.ndarray:
    """Every `every`-th row of the 18,475-particle biceps cloud."""
    pts = J.read_cloud_csv(J.utils.io.ASSETS_DIR
                           / "biceps_simple_out_18475.csv")
    return pts[::every]

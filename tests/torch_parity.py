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
    return T.state_from_numpy(jax_state_arrays(js), device="cpu")


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


def slice_scenes(**fields):
    """(JAX Scene, port Scene) of the 462-particle biceps slice (every 40th
    row of biceps_full, tendon anchors fixed, stim on), with bit-equal
    states. `fields` override the Scene fields (fused_impl, sub_block,
    pack_cap, ...); the defaults are the v4 ones."""
    from sph_sm_monodomain_tpu.ops import grid as jgrid
    pts = biceps_slice_points(every=40)
    assert pts.shape == (462, 3)
    jcfg = J.SimConfig()
    js = J.stim.turn_on_stim_mesh(J.init_fluid(pts, jcfg), pts, jcfg)
    common = dict(cell_capacity=jgrid.auto_cell_capacity(pts, jcfg),
                  neighbor_capacity=jgrid.auto_window_capacity(pts, jcfg),
                  num_particles=pts.shape[0], name="biceps_every40",
                  q_block=128, block_window=128, sub_block=128,
                  fused_impl="v4")
    common.update(fields)
    tcfg = torch_cfg(jcfg)
    ts = T.stim.turn_on_stim_mesh(T.init_fluid(pts, tcfg, device="cpu"), pts,
                                  tcfg)
    for k, v in jax_state_arrays(js).items():
        assert_bit_equal(T.state_to_numpy(ts)[k], v, k)
    assert int(np.asarray(js.fixed).sum()) > 0
    return (J.Scene(state=js, cfg=jcfg, **common),
            T.Scene(state=ts, cfg=tcfg, **common))


# fused-step tolerances of the JAX suite (tests/test_pallas_sweeps.py): pos,
# vel, vm, iion, w absolute; dens relative 1e-5
STEP_TOLS = {"pos": 5e-5, "vel": 5e-3, "vm": 5e-3, "iion": 1e-5, "w": 1e-6}


def assert_states_close(ts, js, rows, tols=STEP_TOLS, dens_rtol=1e-5):
    """The port's state against the JAX one on the rows `rows` (a bool
    mask), at the fused-step tolerances."""
    got = T.state_to_numpy(ts)
    for name, atol in tols.items():
        np.testing.assert_allclose(got[name][rows],
                                   np.asarray(getattr(js, name))[rows],
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(got["dens"][rows], np.asarray(js.dens)[rows],
                               rtol=dens_rtol, err_msg="dens")


WIDE_WORLD = (4.5, 1.5, 1.5)


def _wide_state(jcfg, rng):
    """A cloud along x in a stretched world: the v4 / v5 hash axes
    permute (x is not the fast axis)."""
    pts = rng.random((220, 3)).astype(np.float32) * [4.3, 0.4, 0.4] \
        + [0.1, 0.5, 0.5]
    js = J.init_fluid(pts.astype(np.float32), jcfg)
    return J.stim.set_stim(js, tuple(pts[0]), 0.5, jcfg.stim_strength, jcfg)


def _sparse_state(jcfg, rng):
    """Two tight clusters far apart along the fast axis, so one sub-block
    straddles a huge hash gap and its dilated runs overlap
    (tests/test_pallas_sweeps.py:495-517)."""
    n = 96
    pts = np.concatenate([
        rng.random((n // 2, 3)).astype(np.float32) * 0.08 + 0.05,
        rng.random((n // 2, 3)).astype(np.float32) * 0.08 + 1.3,
    ]).astype(np.float32)
    js = J.init_fluid(pts, jcfg)
    return J.stim.set_stim(js, tuple(pts[0]), 0.5, jcfg.stim_strength, jcfg)


def named_state(case):
    """(JAX config, JAX state) of a named test state: "padded" (200
    particles, capacity 256: 56 dead rows), "slice" (the biceps slice),
    "wide_world" (a stretched world) or "sparse" (two far clusters)."""
    jcfg = J.SimConfig()
    rng = np.random.default_rng(7)
    if case == "padded":
        js = random_state(jcfg, n=200)
    elif case == "slice":
        pts = biceps_slice_points(every=40)
        js = J.stim.turn_on_stim_mesh(J.init_fluid(pts, jcfg), pts, jcfg)
    elif case == "wide_world":
        jcfg = jcfg.replace(world_size=WIDE_WORLD)
        js = _wide_state(jcfg, rng)
    else:
        js = _sparse_state(jcfg, rng)
    return jcfg, js

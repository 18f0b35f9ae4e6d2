"""Helpers shared by the tests that hold the PyTorch port
(sph_sm_monodomain_tpu_torch) to the JAX package on the same inputs.

Inputs are made once with numpy and handed to both packages; JAX stays on
the CPU (tests/conftest.py), its Pallas kernels in interpret mode, and the
port runs on CPU tensors, i.e. through the plain versions of its kernels.

Tolerances of the comparisons over more than one step. The one-step
tolerances (`STEP_TOLS`, the JAX suite's fused-vs-unfused step check) do
not allow for how the trajectory amplifies rounding: after 6 steps of the
biceps slice, JAX against itself with the input positions moved by one
float32 ulp differs by 2.95e-5 in dens (relative), while the one-step
tolerance is 1e-5. So `ulp_spread` measures that sensitivity on the test's
own call (the JAX run, and the same run with every live row's pos moved
one ulp toward +inf), and `assert_states_close` holds each field to
max(one-step tolerance, SPREAD_FACTOR x spread). The factor is 2: on the
6-step slice runs the port sits at 0.58x JAX's 1-ulp dens spread (the
largest share of a spread-set tolerance it uses is 0.46), while planted
faults land outside: every float32 square root 3.1e-4 relative off (the
size of a CPU sqrt fault the port once had) at 17x the tolerance or more
wherever the test reaches a square root, and Poly6's constant 1e-4 off at
1.9x the tolerance on the 6-step slice runs and 5.8x or more elsewhere.
"""

import dataclasses

import numpy as np
import pytest

import sph_sm_monodomain_tpu as J
import sph_sm_monodomain_tpu_torch as T

from parity_clouds import (BICEPS_CSV, WIDE_WORLD, blob_fields, blob_points,
                           sparse_points, wide_points)


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
    pts = blob_points(rng, n)
    js = J.init_fluid(pts, jcfg)
    js = J.stim.set_stim(js, (0.6, 0.6, 0.6), 0.3, jcfg.stim_strength, jcfg)
    return js.replace(**blob_fields(rng, js.capacity, jcfg.stand_density))


def biceps_slice_points(every: int = 40) -> np.ndarray:
    """Every `every`-th row of the 18,475-particle biceps cloud."""
    pts = J.read_cloud_csv(J.utils.io.ASSETS_DIR / BICEPS_CSV)
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


SPREAD_FACTOR = 2.0


def assert_states_close(ts, js, rows, tols=STEP_TOLS, dens_rtol=1e-5,
                        spread=None):
    """The port's state against the JAX one on the rows `rows` (a bool
    mask), at the fused-step tolerances; with `spread` (`ulp_spread` of
    the JAX call), each field at max(its tolerance, SPREAD_FACTOR x its
    spread)."""
    spread = spread or {}

    def tol(name, one_step):
        return max(one_step, SPREAD_FACTOR * spread.get(name, 0.0))

    got = T.state_to_numpy(ts)
    for name, atol in tols.items():
        np.testing.assert_allclose(got[name][rows],
                                   np.asarray(getattr(js, name))[rows],
                                   atol=tol(name, atol), err_msg=name)
    np.testing.assert_allclose(got["dens"][rows], np.asarray(js.dens)[rows],
                               rtol=tol("dens", dens_rtol), err_msg="dens")


def jax_steps(jcfg, impl, steps, sub_q, pack_cap=0, w_chunk=128):
    """`steps` JAX fused steps (impl, sub_q, ...) as a function of the
    start state: the JAX side of a multi-step test, for `ulp_spread`."""
    def run(js):
        for _ in range(steps):
            js = J.step_fused(js, jcfg, sub_q, w_chunk, sub_q, impl=impl,
                              pack_cap=pack_cap)[0]
        return js
    return run


def bump_pos(js, toward=np.inf):
    """The JAX state with every live row's pos moved one float32 ulp
    toward `toward` (+inf by default)."""
    pos = np.array(js.pos)
    act = np.asarray(js.active)
    pos[act] = np.nextafter(pos[act], np.float32(toward))
    return js.replace(pos=pos)


def state_spread(a, b):
    """Max difference of two JAX states on `a`'s live rows, per field:
    dens relative, the others absolute."""
    act = np.asarray(a.active)
    out = {name: float(np.abs(np.asarray(getattr(a, name))[act]
                              - np.asarray(getattr(b, name))[act]).max())
           for name in STEP_TOLS}
    da, db = np.asarray(a.dens)[act], np.asarray(b.dens)[act]
    out["dens"] = float((np.abs(da - db) / np.abs(da)).max())
    return out


def ulp_spread(run, js, ref=None):
    """JAX's own sensitivity to one input bit: `run(state)` is the test's
    JAX call (a final JAX state from a start state); it runs on `js` (or
    `ref` is that run's result) and on `bump_pos(js)`. Returns
    `state_spread` of the two."""
    if ref is None:
        ref = run(js)
    return state_spread(ref, run(bump_pos(js)))


@pytest.fixture(scope="module")
def ulp_spreads():
    """`ulp_spread` memoised by a key naming the scene and implementation,
    so each is computed once per test module."""
    seen = {}

    def get(key, run, js, ref=None):
        if key not in seen:
            seen[key] = ulp_spread(run, js, ref)
        return seen[key]
    return get


def _stim_first(pts, jcfg):
    """A JAX state of `pts`, stimulated within 0.5 of its first point."""
    js = J.init_fluid(pts.astype(np.float32), jcfg)
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
        js = _stim_first(wide_points(rng), jcfg)
    else:
        js = _stim_first(sparse_points(rng), jcfg)
    return jcfg, js

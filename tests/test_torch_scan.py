"""The port's run loop (sph_sm_monodomain_tpu_torch/models/scan.py), the
counterpart of the JAX package's jitted lax.scan, on the CPU: the block
schedule, the port's simulate(unroll=k) against the JAX package's
simulate(..., unroll=k) with frames and a stim-off index inside a block,
simulate_donated in place, run_protocol leaving the caller's state alone,
the in-place write of one state into another, and the launch counter
registry. On the CPU every block runs eagerly; the captured graphs are
held to the eager blocks on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 31).

Tolerances: the JAX run against the port's, at the multi-step parity
tolerances of tests/torch_parity.py (the one-step fused-step tolerances,
or twice JAX's own spread when the input positions move by one ulp);
everything within the port (donated against not, chunked against not) is
the same eager arithmetic, so bit for bit.
"""

import importlib
import pkgutil

import numpy as np
import pytest
import torch

import sph_sm_monodomain_tpu as J
import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu_torch.models import monodomain as tmono
from sph_sm_monodomain_tpu_torch.models import scan
from sph_sm_monodomain_tpu_torch.ops import cuda_lib
from sph_sm_monodomain_tpu_torch.state import FIELD_NAMES

from torch_parity import (SPREAD_FACTOR, STEP_TOLS, assert_bit_equal,
                          assert_states_close, random_state, slice_scenes,
                          to_torch_state, torch_cfg)
from torch_parity import ulp_spreads  # noqa: F401 (a fixture)

# the JAX table's per-cell bucket width (only the JAX side takes it) and
# the neighbor table width of both
CELL_CAP, NBR_CAP = 32, 9 * 64
# 7 steps, a frame every 2, stim off before step 4: inside the block [3, 6)
# of unroll 3, so the block is cut there
RUN = dict(num_steps=7, stim_off_step=4, record_every=2)


def _expand(events):
    """A schedule as one event per step: "s" a step, and the STIM_OFF and
    FRAME events in place."""
    out = []
    for ev in events:
        out += ["s"] * ev if isinstance(ev, int) else [ev]
    return out


@pytest.mark.parametrize("num_steps,unroll,stim_off,record_every,start", [
    (7, 1, 4, 2, 0), (7, 3, 4, 2, 0), (7, 3, 4, 2, 1), (10, 4, -1, 0, 0),
    (10, 4, 0, 3, 0), (10, 4, 0, 3, 1), (10, 4, 9, 5, 0), (5, 8, 2, 1, 0),
    (6, 2, 6, 4, 0), (0, 3, 0, 1, 0)])
def test_schedule_expands_to_the_protocol(num_steps, unroll, stim_off,
                                          record_every, start):
    """Step by step, the schedule is the JAX scan's protocol: turnOffStim
    before step `stim_off`, a frame after every full block of
    `record_every` steps; no block is longer than `unroll` or spans a
    stim-off or a frame."""
    events = scan.schedule(num_steps, unroll, stim_off, record_every, start)
    want = []
    for i in range(start, num_steps):
        if i == stim_off:
            want.append(scan.STIM_OFF)
        want.append("s")
        if record_every and (i + 1) % record_every == 0:
            want.append(scan.FRAME)
    assert _expand(events) == want
    assert all(1 <= ev <= unroll for ev in events if isinstance(ev, int))


def _states(seed=0, n=200):
    jcfg = J.SimConfig()
    js = random_state(jcfg, n=n, seed=seed)
    return jcfg, js, torch_cfg(jcfg), to_torch_state(js)


@pytest.mark.parametrize("unroll", [1, 3])
def test_simulate_matches_jax(unroll, ulp_spreads):
    """The unfused coupled run, 7 steps in blocks of `unroll`, frames every
    2 steps, stim off before step 4, against the JAX package's simulate
    with the same unroll: the end state, each frame and the overflow."""
    jcfg, js0, tcfg, ts0 = _states()
    jst, jaux, jtraj = J.simulate(js0, jcfg, CELL_CAP, NBR_CAP,
                                  unroll=unroll, **RUN)
    tst, taux, ttraj = T.simulate(ts0, tcfg, fused=False,
                                  neighbor_capacity=NBR_CAP, unroll=unroll,
                                  **RUN)
    assert int(taux.overflow) == int(jaux.overflow) == 0
    spread = ulp_spreads("scan/unfused", lambda s: J.simulate(
        s, jcfg, CELL_CAP, NBR_CAP, **RUN)[0], js0)
    act = np.asarray(jst.active)
    assert_states_close(tst, jst, act, spread=spread)
    assert tuple(ttraj["pos"].shape) == tuple(jtraj["pos"].shape) \
        == (3, ts0.capacity, 3)
    for f in range(3):
        for name in ("pos", "vm"):
            tol = max(STEP_TOLS[name], SPREAD_FACTOR * spread[name])
            np.testing.assert_allclose(
                ttraj[name][f].numpy()[act],
                np.asarray(jtraj[name][f])[act], atol=tol,
                err_msg=f"frame {f} {name}")


@pytest.mark.parametrize("fused", [True, False], ids=["v4", "unfused"])
def test_simulate_donated_updates_the_input_in_place(fused):
    """simulate_donated writes the run into the input state's own tensors
    (same data_ptr) and returns them, equal bit for bit to simulate, and
    simulate leaves its input as it was."""
    _, _, tcfg, ts0 = _states(seed=1)
    before = scan.copy_state(ts0)
    kw = dict(fused=fused, neighbor_capacity=NBR_CAP, unroll=3, **RUN)
    want, waux, wtraj = T.simulate(ts0, tcfg, **kw)
    src = scan.copy_state(ts0)
    ptrs = [t.data_ptr() for t in scan._leaves(src)]
    got, gaux, gtraj = tmono.simulate_donated(src, tcfg, **kw)
    assert [t.data_ptr() for t in scan._leaves(got)] == ptrs
    assert [t.data_ptr() for t in scan._leaves(src)] == ptrs
    for name in FIELD_NAMES:
        assert_bit_equal(getattr(got, name).numpy(),
                         getattr(want, name).numpy(), name)
        assert_bit_equal(getattr(ts0, name).numpy(),
                         getattr(before, name).numpy(), name)
    assert_bit_equal(gtraj["pos"].numpy(), wtraj["pos"].numpy(), "frames")
    assert int(gaux.overflow) == int(waux.overflow)


@pytest.mark.parametrize("impl", ["v4", "v3"])
def test_run_protocol_leaves_scene_state_intact(impl):
    """run_protocol in chunks (stim off inside a chunk) leaves the caller's
    scene.state bit for bit as it was and ends where one simulate call over
    the same protocol ends."""
    _, tsc = slice_scenes(fused_impl=impl, sub_block=64)
    before = scan.copy_state(tsc.state)
    got, aux, _ = T.run_protocol(tsc, num_steps=5, chunk=2, stim_off_step=3)
    for name in FIELD_NAMES:
        assert_bit_equal(getattr(tsc.state, name).numpy(),
                         getattr(before, name).numpy(), name)
    want, _ = T.simulate(before, tsc.cfg, 5, stim_off_step=3, sub_q=64,
                         impl=impl)
    for name in FIELD_NAMES:
        assert_bit_equal(getattr(got, name).numpy(),
                         getattr(want, name).numpy(), name)
    assert int(aux.overflow) == 0


def test_assign_reads_every_source_before_writing():
    """Writing a state into another whose fields it reads (here pos and
    vel swapped, and one field left as it is) copies each source first."""
    _, _, _, ts = _states(seed=2)
    dst = scan.copy_state(ts)
    pos, vel = dst.pos.clone(), dst.vel.clone()
    scan._assign(dst, dst.replace(pos=dst.vel, vel=dst.pos))
    assert torch.equal(dst.pos, vel) and torch.equal(dst.vel, pos)
    assert torch.equal(dst.mass, ts.mass)


def test_every_launch_counter_is_in_the_registry():
    """Every wrapper of the port with a launch counter (`launches` or
    `slab_launches`) is in cuda_lib.launch_counters(), which the graphed
    run loop corrects after each capture and replay."""
    registry = {(id(fn), attr) for fn, attr in cuda_lib.launch_counters()}
    found = set()
    pkg = importlib.import_module("sph_sm_monodomain_tpu_torch")
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        if info.name.endswith("__main__"):
            continue
        mod = importlib.import_module(info.name)
        for obj in vars(mod).values():
            for attr in ("launches", "slab_launches"):
                if callable(obj) and isinstance(getattr(obj, attr, None),
                                                int):
                    found.add((id(obj), attr))
    assert len(found) == 16
    assert found <= registry
    before = cuda_lib.read_counters()
    cuda_lib.add_counters((1,) * len(before))
    assert cuda_lib.read_counters() == tuple(b + 1 for b in before)
    cuda_lib.add_counters((-1,) * len(before))
    assert cuda_lib.read_counters() == before

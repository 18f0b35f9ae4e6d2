"""PyTorch port vs the JAX package: v4 sweep bookkeeping (exactly equal)
and the sweep-A / sweep-B kernel modules with stencil "xyz3" (the port's
plain versions on the CPU against the Pallas kernels in interpret mode).

Sweep tolerance, per output column: rtol 1e-5 and atol 1e-6 * max(1,
max |JAX column|). Both sides sum the same pairs in fp32 in another order
(lane-wise partial sums vs. one pass), so errors are a few ulp of the
column's largest terms; the pressure and density columns reach 1e4, the
cell-feature column holds the 2^20 dead-row sentinel.
"""

import numpy as np
import pytest
import torch

import sph_sm_monodomain_tpu as J
from sph_sm_monodomain_tpu.ops import fused_step as jfs
from sph_sm_monodomain_tpu.ops import pallas_sweeps as jps
import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu_torch.ops import fused_step as tfs
from sph_sm_monodomain_tpu_torch.ops import sweeps as tsw

from torch_parity import assert_bit_equal, random_state, to_torch_state, \
    torch_cfg

SUB_Q = 128


def _boundary_state(jcfg):
    """A cloud hugging the y = 0 and y = world walls, so wrap pairs (mid
    cell 0 next to mid cell G-1 one slow plane lower) reach the mask."""
    rng = np.random.default_rng(4)
    n = 180
    pts = rng.random((n, 3)).astype(np.float32)
    pts[:, 1] = np.where(pts[:, 1] < 0.5, pts[:, 1] * 0.05,
                         1.5 - 0.05 * (1.0 - pts[:, 1]) - 1e-4)
    pts[:, 0] = 0.02 + pts[:, 0] * 0.1
    pts[:, 2] = 0.02 + pts[:, 2] * 0.1
    js = J.init_fluid(np.clip(pts, 0.0, 1.5 - 1e-4), jcfg)
    return J.stim.set_stim(js, (0.07, 0.02, 0.07), 0.5, jcfg.stim_strength,
                           jcfg)


@pytest.mark.parametrize("case", ["blob", "boundary", "wide_world"])
def test_bookkeeping_exact(case):
    jcfg = J.SimConfig()
    if case == "blob":
        js = random_state(jcfg, n=300)
    elif case == "boundary":
        js = _boundary_state(jcfg)
    else:
        # stretched world: the hash axes permute (x is not fast)
        jcfg = jcfg.replace(world_size=(4.5, 1.5, 1.5))
        rng = np.random.default_rng(6)
        pts = rng.random((220, 3)).astype(np.float32) * [4.3, 0.4, 0.4] \
            + [0.1, 0.5, 0.5]
        js = J.init_fluid(pts.astype(np.float32), jcfg)
        assert tsw.hash_axis_perm(torch_cfg(jcfg))[0] != 0
    tcfg = torch_cfg(jcfg)
    assert tsw.hash_axis_perm(tcfg) == jps.hash_axis_perm(jcfg)
    ts = to_torch_state(js)
    jb = jps.sweep_bookkeeping3(js.pos, js.active, jcfg, SUB_Q)
    tb = tsw.sweep_bookkeeping3(ts.pos, ts.active, tcfg, SUB_Q)
    for name, a, b in zip(("order", "inv", "blk_lo", "blk_hi", "cx", "cyz"),
                          jb, tb):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=name)
    assert tb[2].dtype == tb[3].dtype == torch.int32
    pts = np.asarray(js.pos)[np.asarray(js.active)]
    assert tsw.auto_sweep4_params(pts, tcfg) == \
        jps.auto_sweep4_params(pts, jcfg)


def _assert_columns_close(t, j, what):
    t, j = t.numpy(), np.asarray(j)
    assert t.shape == j.shape
    for c in range(j.shape[1]):
        atol = 1e-6 * max(1.0, float(np.abs(j[:, c]).max()))
        np.testing.assert_allclose(t[:, c], j[:, c], rtol=1e-5, atol=atol,
                                   err_msg=f"{what} column {c}")


_CASES = {
    "default": ({}, True, False),
    "dynp": ({}, True, True),
    "no_ep": ({}, False, False),
    "fine_grid_full_mask": ({"cell_size": 0.03}, True, False),
    "quirks_off": ({"quirk_double_self_density": False,
                    "quirk_pressure_stim_gate": False,
                    "quirk_iion_accumulate": False}, True, False),
}
_PARAMS = {"k_stiffness": 0.7, "mu_viscosity": 60.0, "velocity_mixing": 0.5,
           "fh_c1": 0.2, "sigma_i": 1.1, "voltage_constant": 2.0}


@pytest.mark.parametrize("case", list(_CASES))
def test_sweeps_match_jax(case):
    overrides, with_ep, dyn = _CASES[case]
    jcfg = J.SimConfig(**overrides)
    tcfg = torch_cfg(jcfg)
    js = random_state(jcfg, n=200)
    ts = to_torch_state(js)
    jdynp = tdynp = None
    if dyn:
        jdynp = jfs.build_dynp(J.resolve_params(jcfg, _PARAMS))
        tdynp = tfs.build_dynp(T.resolve_params(tcfg, _PARAMS))
        np.testing.assert_array_equal(tdynp.numpy(), np.asarray(jdynp))
    assert tfs._mask_a_full(tcfg) == (case == "fine_grid_full_mask")

    jb = jps.sweep_bookkeeping3(js.pos, js.active, jcfg, SUB_Q)
    tb = tsw.sweep_bookkeeping3(ts.pos, ts.active, tcfg, SUB_Q)
    jq, jfa = jfs.build_qm_feats(js, jb[4], jb[5], jb[0])
    tq, tfa = tfs.build_qm_feats(ts, tb[4], tb[5], tb[0])
    assert_bit_equal(tq.numpy(), np.asarray(jq), "QM_A")
    assert_bit_equal(tfa.numpy(), np.asarray(jfa), "sweep-A features")

    ja = jfs.sweep_a3(jq, jfa, jb[2], jb[3], SUB_Q, 128, jcfg,
                      with_ep=with_ep, sub_q=SUB_Q, stencil="xyz3",
                      dynp=jdynp)
    ta = tfs.sweep_a3(tq, tfa, tb[2], tb[3], tcfg, with_ep=with_ep,
                      sub_q=SUB_Q, dynp=tdynp)
    _assert_columns_close(ta, ja, "OUT_A")
    ja = np.asarray(ja)
    if jcfg.quirk_pressure_stim_gate:
        # the gate writes -0.0 on unstimulated rows
        unstim = np.asarray(jq)[:, 9] <= 0.0
        assert unstim.any()
        assert_bit_equal(ta.numpy()[unstim, 6],
                         np.full(unstim.sum(), -0.0, np.float32), "gate")
        assert_bit_equal(ja[unstim, 6], ta.numpy()[unstim, 6], "gate")

    # sweep B on the SAME OUT_A for both, so B is compared on its own
    out_a = torch.from_numpy(ja.copy())
    vol = np.where(ja[:, 8] > 0.0, ja[:, 10] / np.where(ja[:, 8] > 0.0,
                                                        ja[:, 8], 1.0), 0.0)
    vol = vol.astype(np.float32)
    jfb = jfs.feats_from_out_a(ja, vol)
    tfb = tfs.feats_from_out_a(out_a, torch.from_numpy(vol))
    assert_bit_equal(tfb.numpy(), np.asarray(jfb), "sweep-B features")
    jout = jfs.sweep_b3(ja, jfb, jb[2], jb[3], SUB_Q, 128, jcfg,
                        with_ep=with_ep, sub_q=SUB_Q, stencil="xyz3",
                        dynp=jdynp)
    tout = tfs.sweep_b3(out_a, tfb, tb[2], tb[3], tcfg, with_ep=with_ep,
                        sub_q=SUB_Q, dynp=tdynp)
    _assert_columns_close(tout, jout, "OUT_B")

    # the write-back (unsort, fixed / inactive keeps)
    jst = jfs.apply_out_fused(js, ja, jout, jb[1])
    tst = tfs.apply_out_fused(ts, out_a, tout, tb[1])
    for f in ("pos", "vel", "vm", "dens", "inter_vel"):
        np.testing.assert_allclose(getattr(tst, f).numpy(),
                                   np.asarray(getattr(jst, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)


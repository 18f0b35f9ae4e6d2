"""PyTorch port vs the independent float64 NumPy oracle (tests/oracle.py),
in both regimes of the dynamics: stimulated (live SPH pressure, fixed
particles) and after turnOffStim. The port runs its v4 fused step on CPU
tensors (the plain sweep versions). Tolerances are those of
tests/test_step_oracle.py: pos 2e-5, vel 5e-3, vm 5e-3 absolute, dens 1e-4
relative.
"""

import numpy as np
import pytest
import torch

import sph_sm_monodomain_tpu_torch as T
from sph_sm_monodomain_tpu_torch.ops.electrophysiology import (set_stim,
                                                               turn_off_stim)
from sph_sm_monodomain_tpu_torch.ops.shape_matching import sm_invariants

from oracle import oracle_step, oracle_turn_off_stim, state_to_oracle

CFG = T.SimConfig()


def _compare(state, o, n, step_idx):
    got = T.state_to_numpy(state)
    for name, atol in (("pos", 2e-5), ("vel", 5e-3), ("vm", 5e-3)):
        np.testing.assert_allclose(got[name][:n], o[name], atol=atol,
                                   err_msg=f"{name} at step {step_idx}")
    np.testing.assert_allclose(got["dens"][:n], o["dens"], rtol=1e-4,
                               err_msg=f"dens at step {step_idx}")


@pytest.mark.parametrize("stim_off", [False, True],
                         ids=["stimulated", "after_stim_off"])
def test_step_matches_oracle(stim_off):
    rng = np.random.default_rng(0)
    pts = np.clip(rng.normal(size=(220, 3)).astype(np.float32) * 0.05
                  + 0.55, 0.05, 1.2)
    n = pts.shape[0]
    state = set_stim(T.init_fluid(pts, CFG), (0.55, 0.55, 0.55), 0.5,
                     CFG.stim_strength, CFG)
    fixed = torch.zeros(state.capacity, dtype=torch.bool)
    fixed[:5] = True
    state = state.replace(fixed=fixed)
    o = state_to_oracle(state, n)
    sm_inv = sm_invariants(state, CFG)
    for i in range(5):
        if stim_off and i == 2:
            state = turn_off_stim(state, CFG)
            o = oracle_turn_off_stim(o)
        state, aux = T.step_fused(state, CFG, sm_inv=sm_inv)
        assert int(aux.overflow) == 0
        o = oracle_step(o, CFG)
        _compare(state, o, n, i)

"""The superseded v1 / v2 fused steps (mirror of
`sph_sm_monodomain_tpu.ablation.legacy_steps`). models.monodomain.
step_fused dispatches here lazily for impl="v1" / "v2".

Both steps run the reference phases (cpp:794-824) as: bookkeeping, shape
matching, one (N, 13) sorted gather, sweep A's raw sums, the pointwise glue
in PyTorch (XSPH mix, the EOS / stim gate / FHN epilogue that the v3-v5
kernels fuse), sweep B's raw sums, the acceleration and voltage glue, one
(N, 11) unsort gather and the integration. They differ only in the
bookkeeping and the sweeps (ablation/legacy_sweeps.py). Neither can
overflow: the runs and windows cover every candidate exactly.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..models.monodomain import StepAux, _no_overflow
from ..ops.fused_step import _a_epilogue, _Phys, _safe_div, kernel_params
from ..ops.integrate import update_properties
from ..ops.shape_matching import corrected_velocity
from ..ops.sweeps import sweep_bookkeeping2
from ..state import ParticleState
from .legacy_sweeps import (sweep_a, sweep_a2, sweep_b, sweep_b2,
                            sweep_bookkeeping)


def _step_raw_sweeps(state: ParticleState, cfg: SimConfig, order, inv,
                     col12, sweep_a_fn, sweep_b_fn, sm_inv=None
                     ) -> tuple[ParticleState, StepAux]:
    """The step around two raw-sum sweeps. `col12` (ORIGINAL order) rides
    in the sorted gather's column 12 and reaches the sweeps as `hash_s`;
    sweep_a_fn(pos_s, cvel_s, vol_prev, mass_s, hash_s) -> (dens, xsph),
    sweep_b_fn(pos_s, ivel_s, vol_now, pres_s, vm_s, hash_s) -> (acc_raw,
    lap)."""
    state = corrected_velocity(state, cfg, sm_inv=sm_inv)
    # sorted views: ONE (N, 13) gather (the JAX step gathers (N, 16))
    fields = torch.cat([
        state.pos, state.corrected_vel, state.mass[:, None],
        state.dens[:, None], state.vm[:, None], state.stim[:, None],
        state.iion[:, None], state.w[:, None], col12[:, None]], dim=1)
    fs = fields[order]
    pos_s, cvel_s, mass_s, dens_prev_s = fs[:, 0:3], fs[:, 3:6], fs[:, 6], \
        fs[:, 7]
    vm_s, stim_s, iion_s, w_rec_s, hash_s = fs[:, 8], fs[:, 9], fs[:, 10], \
        fs[:, 11], fs[:, 12]
    P = _Phys(kernel_params(cfg, None, state.device))

    # phases 3+4: XSPH + density over the previous step's volumes (0 where
    # the previous density is not positive, so every row stays finite)
    vol_prev = _safe_div(mass_s, dens_prev_s, dens_prev_s > 0.0)
    dens_s, xsph_s = sweep_a_fn(pos_s, cvel_s, vol_prev, mass_s, hash_s)
    inter_vel_s = cvel_s + xsph_s * P.velocity_mixing           # cpp:699
    # phases 4b+5: EOS + stim gate + FHN reaction (cpp:483-593)
    dens_s, pres_s, react_s, iion_s, w_rec_s = _a_epilogue(
        cfg, True, mass_s, vm_s, stim_s, iion_s, w_rec_s, dens_s, P)

    # phase 6: forces + Vm Laplacian over the current volumes
    dens_guard = torch.where(dens_s > 0.0, dens_s, torch.ones_like(dens_s))
    acc_raw_s, lap_s = sweep_b_fn(pos_s, inter_vel_s, mass_s / dens_guard,
                                  pres_s, vm_s, hash_s)
    acc_s = acc_raw_s / dens_guard[:, None]                     # cpp:568
    inter_vm_s = lap_s + P.vm_scale * lap_s - react_s           # cpp:571

    # unsort in ONE (N, 11) gather and integrate (phase 7)
    ou = torch.cat([dens_s[:, None], pres_s[:, None], inter_vel_s,
                    iion_s[:, None], w_rec_s[:, None], acc_s,
                    inter_vm_s[:, None]], dim=1)[inv]
    state = state.replace(
        dens=ou[:, 0], pres=ou[:, 1], inter_vel=ou[:, 2:5], iion=ou[:, 5],
        w=ou[:, 6], acc=ou[:, 7:10], inter_vm=ou[:, 10])
    return update_properties(state, cfg), StepAux(overflow=_no_overflow(state))


def _step_fused_v1(state: ParticleState, cfg: SimConfig, sub_q: int,
                   sm_inv=None) -> tuple[ParticleState, StepAux]:
    """v1 fused step: per-query run bounds (sweep_bookkeeping with
    `sub_q`-row blocks), raw-sum sweeps K8 (ablation baseline)."""
    order, inv, qstart, qend, blk_start, blk_len = sweep_bookkeeping(
        state.pos, state.active, cfg, sub_q)
    bounds = (qstart, qend, blk_start, blk_len)
    return _step_raw_sweeps(
        state, cfg, order, inv, torch.zeros_like(state.mass),
        lambda p, v, vol, m, _: sweep_a(p, v, vol, m, *bounds, cfg),
        lambda p, v, vol, pr, vm, _: sweep_b(p, v, vol, pr, vm, *bounds, cfg),
        sm_inv)


def _step_fused_v2(state: ParticleState, cfg: SimConfig, sub_q: int,
                   sm_inv=None) -> tuple[ParticleState, StepAux]:
    """v2 fused step: v3's hash run windows (sweep_bookkeeping2) and
    linear-hash mask, raw-sum sweeps K9 with the pointwise glue outside
    the kernels (ablation baseline)."""
    order, inv, blk_lo, blk_hi, chash = sweep_bookkeeping2(
        state.pos, state.active, cfg, sub_q)
    return _step_raw_sweeps(
        state, cfg, order, inv, chash,
        lambda p, v, vol, m, h: sweep_a2(p, v, vol, m, h, blk_lo, blk_hi,
                                         cfg, sub_q),
        lambda p, v, vol, pr, vm, h: sweep_b2(p, v, vol, pr, vm, h, blk_lo,
                                              blk_hi, cfg, sub_q),
        sm_inv)

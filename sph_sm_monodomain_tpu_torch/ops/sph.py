"""SPH neighbor-sum phases of the unfused reference step: XSPH mixing,
density/pressure, force + diffusion (mirror of
`sph_sm_monodomain_tpu.ops.sph`, `:41-144`; reference
SPH_SM_monodomain.cpp:448-573, 669-701).

Each phase is a masked gather over the neighbor table of ops/grid.py, pair
math, and a masked sum over the table's K slots. The array-level functions
(`*_arrays`) take query arrays and global (gather-source) arrays; the state
wrappers call them with query == global.

Reference quirks kept (switches on SimConfig):
  - self-density double count: the neighbor loop already includes self and
    cpp:483 adds m_i * Poly6(0) again;
  - stim pressure gate: pressure is forced to -0.0 on particles with
    stim <= 0 (cpp:493-503);
  - the pair guard r^2 > 1e-12 (cpp:546) in the force loop only;
  - XSPH reads the PREVIOUS step's densities (phase order, cpp:794-824);
  - inter_vm = lap + (sigma/(Beta*Cm))*lap - (Iion - stim*dt/m)/Cm
    (cpp:571): the Laplacian is scaled by (1 + sigma/(Beta*Cm)).
Masked slots are zeroed by torch.where; the divisions that autograd sees
are guarded, so no masked slot carries inf or NaN into a gradient.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..state import ParticleState
from .fused_step import _safe_div
from .grid import NeighborTable
from .kernels import b_spline_2, poly6, spiky, visco
from .numerics import sqrt_rn
from .sweeps import _PAIR_EPS


def _div(num, den):
    """num / den, 0 where den is 0 (masked slots or inactive rows)."""
    return _safe_div(num, den, den != 0.0)


def _masked_sum(mask, x):
    """Sum of the (Nq, K) `x` over the K table slots where `mask` (vector
    quantities are summed one component at a time, over the contiguous K
    axis)."""
    return torch.where(mask, x, torch.zeros_like(x)).sum(dim=1)


def gather_index(nbr: NeighborTable) -> torch.Tensor:
    """The table's indices as the phases gather with them: a masked slot
    reads its query's row number (any row in range would do) where the
    table holds particle 0. The values read there are zeroed by
    torch.where either way, so the forward is the same; the backward of a
    gather is an index_put with accumulation, which walks each index's
    duplicates serially, and with every masked slot of the table on
    particle 0 that walk grew to seconds a gather on the card at
    biceps_full's width (chip_smoke phase 32 times both)."""
    idx = nbr.idx.long()
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return torch.where(nbr.mask, idx, rows)


def _diffs(pos_q, pos_g, idx):
    """[pos_q_i - pos_g_j] per axis, three (Nq, K) tensors, and r^2."""
    d = [pos_q[:, k:k + 1] - pos_g[:, k][idx] for k in range(3)]
    return d, d[0] * d[0] + d[1] * d[1] + d[2] * d[2]


def xsph_arrays(pos_q, cvel_q, pos_g, cvel_g, mass_g, dens_g,
                nbr: NeighborTable, cfg: SimConfig):
    """inter_vel = corrected_vel + mixing * sum_j (v_j - v_i) W_poly6 m_j /
    rho_j (calculate_intermediate_velocity, cpp:669-701), with last step's
    densities."""
    idx, mask = gather_index(nbr), nbr.mask
    _, r2 = _diffs(pos_q, pos_g, idx)
    wv = poly6(r2, cfg) * _div(mass_g[idx], dens_g[idx])
    partial = torch.stack([
        _masked_sum(mask, (cvel_g[:, k][idx] - cvel_q[:, k:k + 1]) * wv)
        for k in range(3)], dim=1)
    return cvel_q + partial * cfg.velocity_mixing


def density_pressure_arrays(pos_q, vm_q, stim_q, mass_q, pos_g, mass_g,
                            nbr: NeighborTable, cfg: SimConfig):
    """Density summation + single-pressure EOS with voltage coupling
    (Compute_Density_SingPressure, cpp:448-513). Returns (dens, pres)."""
    idx, mask = gather_index(nbr), nbr.mask
    _, r2 = _diffs(pos_q, pos_g, idx)
    dens = _masked_sum(mask, mass_g[idx] * poly6(r2, cfg))
    if cfg.quirk_double_self_density:                        # cpp:483
        dens = dens + mass_q * poly6(torch.zeros_like(dens), cfg)
    pres = cfg.k_stiffness * (dens - cfg.stand_density)      # cpp:486
    pres = pres - vm_q * cfg.voltage_constant                # cpp:491
    clamped = torch.clamp(pres, -cfg.max_pressure, cfg.max_pressure)
    if cfg.quirk_pressure_stim_gate:                         # cpp:493-503
        pres = torch.where(stim_q > 0.0, clamped,
                           torch.full_like(clamped, -0.0))
    else:
        pres = clamped
    return dens, pres


def force_diffusion_arrays(pos_q, ivel_q, pres_q, vm_q, dens_q, iion_q,
                           stim_q, mass_q, pos_g, ivel_g, pres_g, vm_g,
                           mass_g, dens_g, nbr: NeighborTable,
                           cfg: SimConfig):
    """Pressure + viscosity accelerations and the SPH-discretized monodomain
    Laplacian in one neighbor sweep (Compute_Force, cpp:515-573). Returns
    (acc, inter_vm)."""
    idx, mask = gather_index(nbr), nbr.mask
    diff, r2 = _diffs(pos_q, pos_g, idx)
    pair = mask & (r2 > _PAIR_EPS)                           # cpp:546
    r = sqrt_rn(torch.where(pair, r2, torch.ones_like(r2)))

    vol = _div(mass_g[idx], dens_g[idx])             # cpp:551
    # pressure: acc -= d * Vol*(p_i+p_j)/2 * Spiky(r) / r (cpp:553-554)
    f_pres = vol * (pres_q[:, None] + pres_g[idx]) * 0.5 * spiky(r, cfg)
    fr = f_pres / r
    # viscosity: acc += (u_j - u_i) * Vol * mu * Visco(r) (cpp:558-560)
    f_visc = vol * cfg.mu_viscosity * visco(r, cfg)
    acc = torch.stack([
        -_masked_sum(pair, diff[k] * fr)
        + _masked_sum(pair, (ivel_g[:, k][idx] - ivel_q[:, k:k + 1])
                      * f_visc) for k in range(3)], dim=1)
    acc = _div(acc, dens_q[:, None])                 # cpp:568

    # voltage Laplacian: (Vm_j - Vm_i) * Vol * W''_bspline (cpp:562-563)
    lap = _masked_sum(pair, (vm_g[idx] - vm_q[:, None]) * vol
                      * b_spline_2(r, cfg))
    # currents + scaling (cpp:571)
    inter_vm = lap + (cfg.sigma / (cfg.beta_sv_ratio * cfg.cm_capacitance)) \
        * lap - (iion_q - stim_q * cfg.time_delta / mass_q) \
        / cfg.cm_capacitance
    return acc, inter_vm


# --- single-device state wrappers (query == global) ------------------------------

def xsph_intermediate_velocity(state: ParticleState, nbr: NeighborTable,
                               cfg: SimConfig) -> ParticleState:
    inter = xsph_arrays(state.pos, state.corrected_vel, state.pos,
                        state.corrected_vel, state.mass, state.dens, nbr, cfg)
    return state.replace(inter_vel=inter)


def density_pressure(state: ParticleState, nbr: NeighborTable,
                     cfg: SimConfig) -> ParticleState:
    dens, pres = density_pressure_arrays(state.pos, state.vm, state.stim,
                                         state.mass, state.pos, state.mass,
                                         nbr, cfg)
    return state.replace(dens=dens, pres=pres)


def force_and_diffusion(state: ParticleState, nbr: NeighborTable,
                        cfg: SimConfig) -> ParticleState:
    acc, inter_vm = force_diffusion_arrays(
        state.pos, state.inter_vel, state.pres, state.vm, state.dens,
        state.iion, state.stim, state.mass, state.pos, state.inter_vel,
        state.pres, state.vm, state.mass, state.dens, nbr, cfg)
    return state.replace(acc=acc, inter_vm=inter_vm)

"""Model variants: SPH-only, SM-only and the frozen-cloud monodomain mode
(mirror of `sph_sm_monodomain_tpu.models.variants`).

The reference runs only the fully coupled model, but its phases separate,
and the repo's benchmark configurations call for decoupled modes:
  - SPH-only: density, pressure and viscosity, no activation;
  - monodomain-only: FHN wave propagation (diffusion + reaction) on frozen
    particles;
  - SM-only: a viscoelastic solid under gravity.
Each reuses the phase transforms of the coupled model (ops/sph.py,
ops/electrophysiology.py, ops/shape_matching.py, ops/integrate.py).

The fused forms run hand-written kernels: SPH-only the coupled step's two
sweep kernels with the EP terms switched off; monodomain-only the
Laplacian-only sweep (ops/fused_step.sweep_lap3) once per step forward and
once per step backward (`LapVmFn`), over geometry computed once
(`monodomain_prepare_fused`). The JAX package's TPU tiling arguments
(q_block, w_chunk, w_window) have no counterpart; `sub_q` is the rows per
bookkeeping sub-block, one thread block of the kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SimConfig, resolve_params
from ..state import ParticleState
from ..ops.electrophysiology import fhn_cell_model
from ..ops.fused_step import (build_qm_feats, feats_b, sweep_a3, sweep_b3,
                              sweep_lap3)
from ..ops.grid import NeighborTable, build_neighbor_table
from ..ops.integrate import update_properties
from ..ops.shape_matching import (apply_external_forces, corrected_velocity,
                                  sm_invariants)
from ..ops.sph import (density_pressure, force_and_diffusion,
                       xsph_intermediate_velocity)
from ..ops.sweeps import sweep_bookkeeping3
from .monodomain import StepAux


def _zero_overflow(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


# --- SPH-only -------------------------------------------------------------------

def sph_only_config(cfg: SimConfig | None = None) -> SimConfig:
    """Config for pure-fluid runs: the stim pressure gate (a coupled-model
    quirk, cpp:493-503) must be off or an unstimulated fluid has no pressure
    forces at all; the voltage coupling is inert since Vm stays 0."""
    cfg = cfg or SimConfig()
    return cfg.replace(quirk_pressure_stim_gate=False)


def step_sph_only(state: ParticleState, cfg: SimConfig,
                  neighbor_capacity: int) -> tuple[ParticleState, StepAux]:
    """Pure SPH: gravity -> XSPH -> density/pressure -> forces -> integrate.
    No shape matching (corrected_vel = predicted_vel) and no
    electrophysiology (EP state untouched; inter_vm zeroed so the voltage
    update of Update_Properties is a no-op)."""
    nbr = build_neighbor_table(state.pos, state.pos, state.active, cfg,
                               neighbor_capacity)
    state = apply_external_forces(state, cfg)
    state = state.replace(corrected_vel=state.predicted_vel)
    state = xsph_intermediate_velocity(state, nbr, cfg)
    state = density_pressure(state, nbr, cfg)
    state = force_and_diffusion(state, nbr, cfg)
    state = state.replace(inter_vm=torch.zeros_like(state.inter_vm))
    state = update_properties(state, cfg)
    return state, StepAux(overflow=nbr.overflow)


def step_sph_only_fused(state: ParticleState, cfg: SimConfig,
                        sub_q: int = 128) -> tuple[ParticleState, StepAux]:
    """Pure SPH on the coupled step's sweep kernels with with_ep=False (the
    EP terms of both epilogues drop out: gravity -> XSPH + density + EOS ->
    pressure/viscosity forces -> integrate). Physics-equivalent to
    `step_sph_only`; its write-back leaves vm, iion and w alone."""
    order, inv, blk_lo, blk_hi, cx, cyz = sweep_bookkeeping3(
        state.pos.detach(), state.active, cfg, sub_q)
    state = apply_external_forces(state, cfg)
    state = state.replace(corrected_vel=state.predicted_vel)
    # the QM_A column contract with the EP columns read as zeros
    zeros1 = torch.zeros_like(state.mass)
    fs, feats_a = build_qm_feats(
        state.replace(vm=zeros1, iion=zeros1, w=zeros1), cx, cyz, order)
    out_a = sweep_a3(fs, feats_a, blk_lo, blk_hi, cfg, with_ep=False,
                     sub_q=sub_q)
    out_b = sweep_b3(out_a, feats_b(out_a), blk_lo, blk_hi, cfg,
                     with_ep=False, sub_q=sub_q)

    ou = torch.cat([out_b, out_a[:, 3:6]], dim=1)[inv]
    upd = (state.active & ~state.fixed)[:, None]
    state = state.replace(
        pos=torch.where(upd, ou[:, 0:3], state.pos),
        vel=torch.where(upd, ou[:, 3:6], state.vel),
        dens=ou[:, 7], pres=ou[:, 8], acc=ou[:, 12:15],
        inter_vel=ou[:, 16:19], inter_vm=torch.zeros_like(state.inter_vm))
    return state, StepAux(overflow=_zero_overflow(state.device))


def simulate_sph_only(state: ParticleState, cfg: SimConfig,
                      neighbor_capacity: int, num_steps: int,
                      record_every: int = 0, fused: bool = False,
                      sub_q: int = 128):
    """Run `num_steps` pure-SPH steps (fused or unfused), recording (pos,)
    frames after each block of `record_every` steps."""
    def one(st):
        if fused:
            return step_sph_only_fused(st, cfg, sub_q)
        return step_sph_only(st, cfg, neighbor_capacity)

    return _scan_with_frames(one, state, num_steps, record_every,
                             lambda st: (st.pos,))


# --- SM-only --------------------------------------------------------------------

def step_sm_only(state: ParticleState, cfg: SimConfig, sm_inv=None
                 ) -> tuple[ParticleState, StepAux]:
    """Shape matching + gravity only: a viscoelastic solid with no fluid
    forces, no electrophysiology and no neighbor table (SM is global)."""
    state = corrected_velocity(state, cfg, sm_inv=sm_inv)
    state = state.replace(inter_vel=state.corrected_vel,
                          acc=torch.zeros_like(state.acc),
                          inter_vm=torch.zeros_like(state.inter_vm))
    state = update_properties(state, cfg)
    return state, StepAux(overflow=_zero_overflow(state.device))


def simulate_sm_only(state: ParticleState, cfg: SimConfig, num_steps: int,
                     record_every: int = 0):
    """Run `num_steps` SM-only steps with the rest-shape moments hoisted."""
    sm_inv = sm_invariants(state, cfg)
    return _scan_with_frames(lambda st: step_sm_only(st, cfg, sm_inv), state,
                             num_steps, record_every, lambda st: (st.pos,))


def _scan_with_frames(one_step, state, num_steps: int, record_every: int,
                      extract):
    """Run `num_steps` steps of `one_step` (state -> (state, StepAux)),
    recording `extract(state)` after each full block of `record_every`
    steps; leftover steps run unrecorded. Returns (state, StepAux) or, with
    `record_every`, (state, StepAux, frames): a tuple of (blocks, ...)
    stacks, one per extracted field."""
    ovfs, frames = [], []
    for i in range(num_steps):
        state, aux = one_step(state)
        ovfs.append(aux.overflow)
        if record_every and (i + 1) % record_every == 0:
            frames.append(tuple(x.clone() for x in extract(state)))
    ovf = torch.stack(ovfs).amax() if ovfs else _zero_overflow(state.device)
    if not record_every:
        return state, StepAux(overflow=ovf)
    if frames:
        stacked = tuple(torch.stack(f) for f in zip(*frames))
    else:
        stacked = tuple(x.new_zeros((0,) + tuple(x.shape))
                        for x in extract(state))
    return state, StepAux(overflow=ovf), stacked


# --- monodomain-only, unfused -------------------------------------------------

class MonodomainTables(NamedTuple):
    """Geometry of the frozen cloud for the unfused monodomain mode."""
    nbr: NeighborTable
    dens: torch.Tensor


def monodomain_prepare(state: ParticleState, cfg: SimConfig,
                       neighbor_capacity: int) -> MonodomainTables:
    """Frozen particles: the neighbor table and the SPH densities are
    static, so they are built once (every step in the coupled model)."""
    with torch.no_grad():
        nbr = build_neighbor_table(state.pos, state.pos, state.active, cfg,
                                   neighbor_capacity)
        dens = density_pressure(state, nbr, cfg).dens
    return MonodomainTables(nbr=nbr, dens=dens)


def step_monodomain_only(state: ParticleState, tables: MonodomainTables,
                         cfg: SimConfig) -> ParticleState:
    """FHN reaction + SPH-discretized diffusion on a frozen cloud (the
    reaction-diffusion core of Compute_Force cpp:562-571,
    calculate_cell_model cpp:575-593 and the Vm update of cpp:612-616)."""
    state = state.replace(dens=tables.dens)
    state = fhn_cell_model(state, cfg)
    state = force_and_diffusion(state, tables.nbr, cfg)
    vm = state.vm + state.inter_vm * cfg.time_delta / state.mass
    vm = torch.clamp(vm, -cfg.max_voltage, cfg.max_voltage)
    return state.replace(vm=torch.where(state.active, vm, state.vm))


def _vm_frames(body, state, num_steps: int, record_every: int):
    """The monodomain drivers' return convention over `_scan_with_frames`
    (these modes have no neighbor table to overflow): `state` after
    `num_steps` steps of `body`, or with `record_every` (state, (blocks, N)
    vm frames)."""
    no_ovf = StepAux(overflow=_zero_overflow(state.device))
    out = _scan_with_frames(lambda st: (body(st), no_ovf), state, num_steps,
                            record_every, lambda st: (st.vm,))
    return (out[0], out[2][0]) if record_every else out[0]


def simulate_monodomain_only(state: ParticleState, tables: MonodomainTables,
                             cfg: SimConfig, num_steps: int,
                             record_every: int = 0, params=None):
    """Run the unfused frozen-cloud FHN wave. `params`
    (config.PARAM_FIELDS): EP-constant overrides, floats or 0-dim tensors
    (differentiable); the frozen density table ignores stand_density by
    definition of the mode."""
    cfg = resolve_params(cfg, params)
    return _vm_frames(lambda st: step_monodomain_only(st, tables, cfg),
                      state, num_steps, record_every)


# --- monodomain-only, fused: the Laplacian kernel ------------------------------

class MonodomainFusedTables(NamedTuple):
    """Static geometry of the fused frozen-cloud stepper: the cloud never
    moves, so the sort, the v4 window bookkeeping, the densities and the
    neighbor volumes are computed once; per step only the Laplacian-only
    sweep runs."""
    order: torch.Tensor
    inv: torch.Tensor
    blk_lo: torch.Tensor
    blk_hi: torch.Tensor
    cx_s: torch.Tensor      # sorted f32 fast-axis cell coordinate
    cyz_s: torch.Tensor     # sorted f32 mid + Gm*slow coordinate
    pos_s: torch.Tensor     # sorted positions
    vol_s: torch.Tensor     # sorted m/rho
    rowsum_s: torch.Tensor  # sum_k vol_k W2_jk per sorted row (for the VJP)
    mass: torch.Tensor      # original-order mass
    dens: torch.Tensor      # original-order densities


def _lap_inputs(vm_q, vol_row, vm_row, pos_s, cx_s, cyz_s):
    """(qm (N, 16), feats (16, N)) of one Laplacian sweep."""
    n = pos_s.shape[0]
    z = pos_s.new_zeros((n,))
    qm = torch.cat([pos_s, vm_q[:, None], pos_s.new_zeros((n, 8)),
                    cx_s[:, None], cyz_s[:, None], pos_s.new_zeros((n, 2))],
                   dim=1)
    feats = torch.stack([pos_s[:, 0], pos_s[:, 1], pos_s[:, 2], vol_row,
                         vm_row, z, z, z, z, z, z, z, cx_s, cyz_s, z, z])
    return qm, feats


def _lap_sweep(vm_q, vol_row, vm_row, tables, cfg: SimConfig, sub_q: int):
    """Column 0 of one Laplacian sweep over the tables' geometry."""
    qm, feats = _lap_inputs(vm_q, vol_row, vm_row, tables.pos_s,
                            tables.cx_s, tables.cyz_s)
    return sweep_lap3(qm, feats, tables.blk_lo, tables.blk_hi, cfg,
                      sub_q=sub_q)[:, 0]


def monodomain_prepare_fused(state: ParticleState, cfg: SimConfig,
                             sub_q: int = 128) -> MonodomainFusedTables:
    """The frozen geometry of `state` for the fused stepper: the v4 sort and
    windows, the densities from one sweep A (with_ep=False: only its dens
    column is read; the double-self quirk is applied inside, cpp:483) and
    the constant Laplacian row sum from one Laplacian sweep (query vm 0,
    candidate vm 1), which the backward pass of every step then reuses."""
    with torch.no_grad():
        order, inv, blk_lo, blk_hi, cx, cyz = sweep_bookkeeping3(
            state.pos, state.active, cfg, sub_q)
        fs, feats_a = build_qm_feats(
            state.replace(corrected_vel=torch.zeros_like(state.pos)),
            cx, cyz, order)
        out_a = sweep_a3(fs, feats_a, blk_lo, blk_hi, cfg, with_ep=False,
                         sub_q=sub_q)
        dens_s = out_a[:, 8]
        dens_guard = torch.where(dens_s > 0.0, dens_s,
                                 torch.ones_like(dens_s))
        vol_s = state.mass[order] / dens_guard
        pos_s = state.pos[order]
        tables = MonodomainFusedTables(
            order=order, inv=inv, blk_lo=blk_lo, blk_hi=blk_hi,
            cx_s=cx[order], cyz_s=cyz[order], pos_s=pos_s, vol_s=vol_s,
            rowsum_s=None, mass=state.mass, dens=dens_s[inv])
        zeros = torch.zeros_like(vol_s)
        rowsum_s = _lap_sweep(zeros, vol_s, torch.ones_like(vol_s), tables,
                              cfg, sub_q)
    return tables._replace(rowsum_s=rowsum_s)


class LapVmFn(torch.autograd.Function):
    """The sorted-order Vm Laplacian over the hoisted tables, with its VJP
    (the counterpart of the JAX package's `_lap_vm_factory`).

    The Laplacian is linear in vm: lap = L vm with L = A - diag(rowsum(A)),
    A_ij = vol_j W2(r_ij) over the symmetric 27-cell stencil with the
    symmetric r^2 > eps exclusion. W2 is symmetric in r, so the VJP is one
    more sweep of the same kernel:
        (L^T g)_j = vol_j sum_i W2_ij g_i - g_j sum_k vol_k W2_jk,
    a sweep with unit candidate volumes gathering g (query vm zeroed), plus
    the constant row sum of the tables. Gradients flow to vm only: the mode
    holds its geometry constant, so the tables get no cotangent. Composes
    with torch.utils.checkpoint (each recomputed forward launches the
    kernel again)."""

    @staticmethod
    def forward(ctx, vm_s, tables: MonodomainFusedTables, cfg: SimConfig,
                sub_q: int):
        ctx.tables, ctx.cfg, ctx.sub_q = tables, cfg, sub_q
        return _lap_sweep(vm_s, tables.vol_s, vm_s, tables, cfg, sub_q)

    @staticmethod
    def backward(ctx, g):
        t = ctx.tables
        g = g.contiguous()
        s = _lap_sweep(torch.zeros_like(g), torch.ones_like(g), g, t,
                       ctx.cfg, ctx.sub_q)
        return t.vol_s * s - g * t.rowsum_s, None, None, None


def simulate_monodomain_only_fused(state: ParticleState,
                                   tables: MonodomainFusedTables,
                                   cfg: SimConfig, num_steps: int,
                                   record_every: int = 0, sub_q: int = 128,
                                   params=None):
    """Fused frozen-cloud FHN wave: per step the reaction ODE and one
    Laplacian-only sweep (the kernel carries two accumulators instead of
    sweep B's force machinery); all geometry is in `tables`.
    Differentiable w.r.t. the EP state (vm, iion, w, stim) through `LapVmFn`.
    `params` (config.PARAM_FIELDS): EP-constant overrides, floats or 0-dim
    tensors. They are resolved after the Laplacian is set up, since the
    kernel is geometry only: every EP constant lives in the PyTorch part of
    the step, so gradients w.r.t. them flow here. Returns the state, or with
    `record_every` (state, vm frames) as `simulate_monodomain_only`."""
    lap_cfg = cfg
    cfg = resolve_params(cfg, params)
    dt = cfg.time_delta

    def body(st):
        st = fhn_cell_model(st, cfg)
        lap = LapVmFn.apply(st.vm[tables.order], tables, lap_cfg,
                            sub_q)[tables.inv]
        scale = cfg.sigma / (cfg.beta_sv_ratio * cfg.cm_capacitance)
        inter_vm = lap + scale * lap - (st.iion - st.stim * dt / st.mass) \
            / cfg.cm_capacitance
        vm = torch.clamp(st.vm + inter_vm * dt / st.mass, -cfg.max_voltage,
                         cfg.max_voltage)
        return st.replace(vm=torch.where(st.active, vm, st.vm),
                          inter_vm=inter_vm, dens=tables.dens)

    return _vm_frames(body, state, num_steps, record_every)

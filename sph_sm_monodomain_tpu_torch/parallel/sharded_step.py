"""Particle-sharded multi-device steps over the ranks of a `comm.Comm`
(mirror of `sph_sm_monodomain_tpu.parallel.sharded_step`).

Each rank owns a contiguous share of the padded particle rows (shard_state);
neighbor interactions read the ALL_GATHERed fields of every particle, and
the shape-matching moments are summed over the ranks (ops/shape_matching.py,
`comm`), the only all-reduce the physics needs; the pointwise phases run on
the rank's own rows.

  unfused (`make_sharded_step`, `make_sharded_simulate`): the reference
      step over a neighbor table of the rank's rows against the gathered
      cloud (ops/grid.build_neighbor_table), plain PyTorch; the fields of
      each phase group travel in one packed all_gather.
  fused (`make_sharded_step_fused`, `make_sharded_simulate_fused`): the
      v4 sort and window bookkeeping, replicated on every rank over the
      gathered cloud, then the v4 sweep kernels K1 / K2 over THIS rank's
      slab of sorted query rows (`q_slice`, the slab launches of
      ops/fused_step.sweep_a3 / sweep_b3) against every candidate; the
      slabs' outputs are all_gathered in sorted order and mapped back to
      the rank's rows. The capacity must be a multiple of ranks x sub_q.

Every returned step or run takes (state, params=None): `params` is a dict
of physics overrides (config.PARAM_FIELDS) that reach the kernels through
the physics-constant vector (the JAX package's `dynamic_params=True`
form, which needs no flag here: a tensor override is an operand of the
captured graph, not part of its key).

The simulates run their steps through models/scan.run_steps, the JAX
package's jitted lax.scan inside shard_map: over NCCL, replays of one
captured CUDA graph a step; on the CPU, the same steps eagerly; with
gloo through host copies (ranks sharing a card), whose copies cannot be
captured, scan.run_steps_uncaptured (`run_loop`). The single-step makers
stay eager: the JAX package's single jitted steps, and the reference the
simulates are held to.

The all-gather path is differentiable, as the JAX package's
`jax.value_and_grad` through its make_sharded_simulate(...,
dynamic_params=True) is: its collectives carry their VJPs
(parallel/comm.py), the physics overrides pass through
`comm.replicated` once a call, and the simulate under autograd is the
checkpointed adjoint scan of models/scan.py (its backward step graphed
over NCCL, eager on the CPU and through host copies). The contract: the
loss is a sum over the ranks of each rank's share (e.g. a sum over its
own rows of the output); each rank calls torch.autograd on its own share
and reads
  - for a physics override: the gradient of the whole loss, the same on
    every rank;
  - for a sharded field of the input state: the gradient of the whole
    loss at the rank's own rows.
The fused slab path refuses autograd (comm.refuse_grad), as the JAX
package's does not differentiate it.
"""

from __future__ import annotations

import torch

from ..config import SimConfig, resolve_params
from ..models.monodomain import StepAux
from ..models.scan import run_steps, run_steps_uncaptured
from ..state import FIELD_NAMES, ParticleState
from ..ops.electrophysiology import fhn_cell_model, turn_off_stim
from ..ops.fused_step import (apply_out_fused, build_dynp, feats_a_from_fs,
                              feats_b, sweep_a3, sweep_b3)
from ..ops.grid import build_neighbor_table
from ..ops.integrate import update_properties
from ..ops.numerics import ensure_fp32
from ..ops.shape_matching import corrected_velocity, sm_invariants
from ..ops.sph import (density_pressure_arrays, force_diffusion_arrays,
                       xsph_arrays)
from ..ops.sweeps import sweep_bookkeeping3
from .comm import Comm, current, refuse_grad

# per-row fields in the packed (N, 34) matrix of gather_state; flags as 0/1
_ROW_FIELDS = tuple(n for n in FIELD_NAMES if n != "is_stim_on")


def make_mesh(devices=None) -> Comm:
    """The group this process joined (comm.init / comm.init_from_env):
    the port's counterpart of the JAX package's 1-D device mesh. `devices`
    is accepted for the JAX signature and must match the group size."""
    mesh = current()
    if mesh is None:
        raise RuntimeError("no group: start the ranks with comm.spawn or "
                           "torchrun (comm.init_from_env) first")
    if devices is not None and len(devices) != mesh.size:
        raise ValueError(f"{len(devices)} devices for a group of "
                         f"{mesh.size} ranks")
    return mesh


def shard_state(state: ParticleState, mesh: Comm) -> ParticleState:
    """This rank's rows of a full (single-device) state: rows [r * n_loc,
    (r + 1) * n_loc) with n_loc = capacity / ranks, on the rank's device;
    the stim flag is replicated."""
    cap, d = state.capacity, mesh.size
    if cap % d:
        raise ValueError(f"capacity {cap} does not divide over {d} ranks "
                         "(pad the state: build_scene(pad_to=...))")
    n_loc = cap // d
    lo = mesh.rank * n_loc
    return ParticleState(**{
        n: (getattr(state, n) if n == "is_stim_on"
            else getattr(state, n)[lo:lo + n_loc]).to(mesh.device)
        for n in FIELD_NAMES})


def gather_state(state: ParticleState, mesh: Comm) -> ParticleState:
    """The ranks' rows of a sharded state concatenated in rank order (the
    full state, on every rank), in one all_gather of the fields packed as
    one float32 matrix."""
    cols = [getattr(state, n).to(torch.float32).reshape(state.capacity, -1)
            for n in _ROW_FIELDS]
    full = mesh.all_gather(torch.cat(cols, dim=1))
    out, k = {}, 0
    for n, c in zip(_ROW_FIELDS, cols):
        w = c.shape[1]
        v = full[:, k:k + w]
        ref = getattr(state, n)
        out[n] = (v[:, 0] > 0.5 if ref.dtype == torch.bool
                  else v if ref.dim() == 2 else v[:, 0])
        k += w
    return ParticleState(is_stim_on=state.is_stim_on, **out)


def _sharded_step_body(state: ParticleState, cfg: SimConfig,
                       neighbor_capacity: int, mesh: Comm, sm_inv=None,
                       params=None):
    """One coupled step on this rank's rows (the unfused reference form).
    `params`: physics overrides (config.PARAM_FIELDS); geometry stays on
    the static cfg. Returns (state, overflow summed over the ranks)."""
    cfg = resolve_params(cfg, params)
    # gather #1: the neighbor table's and XSPH's sources [pos | active |
    # mass], one packed (n_loc, 5) block
    g1 = mesh.all_gather(torch.cat(
        [state.pos, state.active.to(torch.float32)[:, None],
         state.mass[:, None]], dim=1))
    g_pos, g_active, g_mass = g1[:, 0:3], g1[:, 3] > 0.5, g1[:, 4]

    # 1. neighbor table: the rank's queries against the gathered cloud
    nbr = build_neighbor_table(state.pos, g_pos, g_active, cfg,
                               neighbor_capacity)

    # 2. shape matching: moments summed over the ranks
    state = corrected_velocity(state, cfg, sm_inv=sm_inv, comm=mesh)

    # 3. XSPH (previous-step global densities + fresh corrected velocities)
    g2 = mesh.all_gather(torch.cat([state.corrected_vel,
                                    state.dens[:, None]], dim=1))
    inter = xsph_arrays(state.pos, state.corrected_vel, g_pos, g2[:, 0:3],
                        g_mass, g2[:, 3], nbr, cfg)
    state = state.replace(inter_vel=inter)

    # 4. density + pressure (local queries, global positions)
    dens, pres = density_pressure_arrays(state.pos, state.vm, state.stim,
                                         state.mass, g_pos, g_mass, nbr, cfg)
    state = state.replace(dens=dens, pres=pres)

    # 5. FHN reaction (pointwise)
    state = fhn_cell_model(state, cfg)

    # 6. force + Vm diffusion (freshly updated global fields, one gather)
    g3 = mesh.all_gather(torch.cat(
        [state.inter_vel, state.pres[:, None], state.vm[:, None],
         state.dens[:, None]], dim=1))
    acc, inter_vm = force_diffusion_arrays(
        state.pos, state.inter_vel, state.pres, state.vm, state.dens,
        state.iion, state.stim, state.mass, g_pos, g3[:, 0:3], g3[:, 3],
        g3[:, 4], g_mass, g3[:, 5], nbr, cfg)
    state = state.replace(acc=acc, inter_vm=inter_vm)

    # 7. integrate + walls (pointwise)
    state = update_properties(state, cfg)
    # the table's truncations are per rank: their sum is the global count
    return state, mesh.all_sum(nbr.overflow)


def run_loop(mesh: Comm):
    """(run, how): the run loop of the multi-device simulates on `mesh`'s
    transport, fixed by the transport and never switched after a failure,
    and a line saying how it runs. NCCL: models/scan.run_steps, graphed
    (a capture or replay that fails raises), its gradient the graphed
    adjoint scan; gloo over CPU tensors: run_steps, whose blocks and
    adjoint run eagerly on the CPU; gloo through host copies:
    scan.run_steps_uncaptured (a copy to the host cannot be captured),
    its gradient the eager adjoint scan."""
    if mesh.transport == "gloo-host":
        return (run_steps_uncaptured, "eager (gloo through host copies), "
                "gradients through the eager adjoint scan")
    if mesh.transport == "nccl":
        return run_steps, ("graphed (captured CUDA graphs over NCCL), "
                           "gradients through the graphed adjoint scan")
    return run_steps, ("eager (gloo over CPU tensors), gradients through "
                       "the eager adjoint scan")


def _replicated(mesh: Comm, params):
    """The physics overrides (a dict, or None) with every tensor that
    requires grad passed through comm.replicated under grad mode: the
    transpose of a replicated input (module docstring)."""
    if not params or not torch.is_grad_enabled():
        return params
    return {k: mesh.replicated(v) if torch.is_tensor(v) and v.requires_grad
            else v for k, v in params.items()}


def _simulate(body, key: tuple, mesh: Comm, cfg: SimConfig,
              num_steps: int, stim_off_step: int,
              differentiable: bool = False):
    """N steps of body(state, sm_inv, params) -> (state, overflow) through
    the transport's run loop, with the reference stim-off protocol
    (main.cpp:329-334) and the rest-shape moments hoisted (the halo body
    rebinds their per-row members to its migrated rows). Returns (state,
    largest per-step overflow).

    `key` names the path and its static arguments; the rank's (rank,
    size, transport) join it, so no two paths or ranks share a capture,
    and every rank makes the same captures in the same order. The number
    of steps stays out of it: a run in chunks replays the first chunk's
    capture. Nothing is donated (the JAX package's sharded scans donate
    nothing). `differentiable`: under autograd the run is the adjoint
    scan, the overrides replicated (_replicated); else it refuses
    autograd (comm.refuse_grad)."""
    run = run_loop(mesh)[0]
    key = key + (mesh.rank, mesh.size, mesh.transport)

    def one(st, ops):
        st, overflow = body(st, *ops)
        return st, StepAux(overflow=overflow)

    def impl(state, params=None):
        if differentiable:
            params = _replicated(mesh, params)
        else:
            refuse_grad(f"the multi-device run {key[0]!r}", state, params)
        ensure_fp32()
        sm_inv = sm_invariants(state, cfg, comm=mesh)
        state, overflow, _ = run(
            one, state, num_steps, key=key, operands=(sm_inv, params),
            stim_off_step=stim_off_step,
            stim_off=lambda st: turn_off_stim(st, cfg))
        return state, overflow
    return impl


def make_sharded_step(mesh: Comm, cfg: SimConfig, neighbor_capacity: int):
    """The unfused multi-device step: (state, params=None) -> (state,
    overflow), state from shard_state; eager, and differentiable under
    eager autograd (the module docstring's contract). The sorted window
    table has no per-cell buckets, so the JAX package's `cell_capacity`
    has no counterpart (as in the port's unfused step)."""
    def impl(state, params=None):
        ensure_fp32()
        return _sharded_step_body(state, cfg, neighbor_capacity, mesh,
                                  params=_replicated(mesh, params))
    return impl


def make_sharded_simulate(mesh: Comm, cfg: SimConfig,
                          neighbor_capacity: int, num_steps: int,
                          stim_off_step: int = -1):
    """N unfused multi-device steps with the stim-off protocol through the
    transport's run loop (run_loop): (state, params=None) -> (state,
    largest per-step overflow). Under autograd (an override or a field of
    the state requiring grad) the checkpointed adjoint scan, graphed over
    NCCL: each rank's gradient of its rows' share of a loss gives the
    overrides' gradient of the loss summed over the ranks and the state's
    at the rank's rows (the module docstring's contract), as
    jax.value_and_grad through the JAX package's make_sharded_simulate(...,
    dynamic_params=True) gives them."""
    return _simulate(
        lambda st, inv, prm: _sharded_step_body(
            st, cfg, neighbor_capacity, mesh, sm_inv=inv, params=prm),
        ("sharded_gather", cfg, neighbor_capacity), mesh, cfg, num_steps,
        stim_off_step, differentiable=True)


def _sharded_fused_body(state: ParticleState, cfg: SimConfig, sub_q: int,
                        mesh: Comm, sm_inv=None, params=None):
    """One fused coupled step on this rank's rows: the gathered cloud's
    sort and windows on every rank, K1 / K2 over this rank's slab of
    sorted query rows, the slabs' outputs gathered and unsorted to the
    rank's rows."""
    cfg_eff = resolve_params(cfg, params)
    dynp = build_dynp(cfg_eff, state.device) if params else None
    n_loc = state.capacity
    if n_loc % sub_q:
        raise ValueError(f"{n_loc} rows a rank are not whole sub-blocks of "
                         f"sub_q={sub_q}: pad the capacity to a multiple "
                         f"of {mesh.size * sub_q}")
    lo = mesh.rank * n_loc  # this rank's slab of sorted rows

    # gather #1: positions + active mask (bookkeeping inputs), one packed
    # (n_loc, 4) block
    g_pa = mesh.all_gather(torch.cat(
        [state.pos, state.active.to(torch.float32)[:, None]], dim=1))
    g_pos, g_active = g_pa[:, 0:3], g_pa[:, 3] > 0.5
    order, inv, blk_lo, blk_hi, cx, cyz = sweep_bookkeeping3(
        g_pos, g_active, cfg, sub_q)
    my_inv = inv[lo:lo + n_loc]

    # shape matching: local moments summed over the ranks
    state = corrected_velocity(state, cfg_eff, sm_inv=sm_inv, comm=mesh)

    # gather #2: the remaining QM_A columns as one packed (n_loc, 9) block
    g_rest = mesh.all_gather(torch.cat(
        [state.corrected_vel, state.mass[:, None], state.dens[:, None],
         state.vm[:, None], state.stim[:, None], state.iion[:, None],
         state.w[:, None]], dim=1))
    n = g_pos.shape[0]
    # QM_A column contract: ops/fused_step.build_qm_feats
    fields = torch.cat([g_pos, g_rest, cx[:, None], cyz[:, None],
                        g_pos.new_zeros((n, 2))], dim=1)
    fs = fields[order]
    out_a_slab = sweep_a3(fs, feats_a_from_fs(fs), blk_lo, blk_hi, cfg,
                          sub_q=sub_q, dynp=dynp, q_slice=(lo, n_loc))
    out_a = mesh.all_gather(out_a_slab)                     # sorted order
    out_b_slab = sweep_b3(out_a, feats_b(out_a), blk_lo, blk_hi, cfg,
                          sub_q=sub_q, dynp=dynp, q_slice=(lo, n_loc))
    out_b = mesh.all_gather(out_b_slab)
    state = apply_out_fused(state, out_a, out_b, my_inv)
    # the windows cover every candidate: no overflow on this path
    return state, torch.zeros((), dtype=torch.int32, device=state.device)


def make_sharded_step_fused(mesh: Comm, cfg: SimConfig, sub_q: int = 128):
    """The fused multi-device step, eager: (state, params=None) -> (state,
    0). The capacity must be a multiple of ranks x sub_q, so each rank owns
    whole sub-blocks of sorted rows (the JAX package's q_block
    contract). Refuses autograd (comm.refuse_grad)."""
    def impl(state, params=None):
        refuse_grad("the multi-device step 'sharded_fused'", state, params)
        ensure_fp32()
        return _sharded_fused_body(state, cfg, sub_q, mesh, params=params)
    return impl


def make_sharded_simulate_fused(mesh: Comm, cfg: SimConfig, num_steps: int,
                                stim_off_step: int = -1, sub_q: int = 128):
    """N fused multi-device steps with the stim-off protocol through the
    transport's run loop (run_loop; the command line's `--devices N
    --parallel fused`): (state, params=None) -> (state, 0). Refuses
    autograd (comm.refuse_grad)."""
    return _simulate(
        lambda st, inv, prm: _sharded_fused_body(st, cfg, sub_q, mesh,
                                                 sm_inv=inv, params=prm),
        ("sharded_fused", cfg, sub_q), mesh, cfg, num_steps, stim_off_step)


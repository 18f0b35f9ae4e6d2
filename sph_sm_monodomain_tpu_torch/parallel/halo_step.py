"""Halo-exchange multi-device step with particle migration, over slow-axis
slabs of cell planes (mirror of `sph_sm_monodomain_tpu.parallel.halo_step`;
the design is the JAX package's docs/halo_exchange_design.md).

  - ownership: rank d owns the cell planes whose SLOW-axis coordinate lies
    in [sb[d], sb[d+1]) (slab_bounds) of the axis-permuted hash cf + Gf*(cm
    + Gm*cs) (ops/sweeps.hash_axis_perm puts the largest grid extent on the
    slow axis, so a world stretched along x slabs along x). The ranks'
    locally sorted rows laid end to end are globally sorted.
  - per step each rank flags its emigrants elementwise on the hash (a
    particle moves less than one cell a step, so only the adjacent ranks
    receive), packs them with a cumsum-rank scatter, shifts them to its
    neighbours (comm.shift), and restores the slab-sorted layout with one
    stable argsort over the merged S + 2M rows and one wide row gather.
  - each sweep exchanges one boundary plane of candidate rows with each
    neighbour, the int32 window id riding the float matrix as a bitcast
    (`.view(torch.float32)`, never a value cast: ids can pass 2^24); the
    rank's S query rows are swept against the S + 2H merged candidates by
    the v4 kernels K1 / K2 (their slab launches, ops/fused_step.sweep_a3
    / sweep_b3 with N_c != N_q).
  - the only collectives over all ranks are the shape-matching sums and
    the overflow count.

The state keeps a rank-sorted row layout (rows migrate and reorder);
particle identity travels in the fields (orig_pos, ...), as the reference's
particles have no global index either. Fixed capacities, sized by
shard_state_halo and reported through the step's overflow count when
exceeded: S rows a rank, mig_cap migrants a direction a step, halo_cap
boundary-plane rows a direction a sweep.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import SimConfig, resolve_params
from ..state import FIELD_NAMES, ParticleState
from ..ops.constants import const_tensor
from ..ops.fused_step import (apply_out_fused, build_dynp, feats_a_from_fs,
                              feats_from_out_a, sweep_a3, sweep_b3, vol_now)
from ..ops.numerics import ensure_fp32
from ..ops.shape_matching import (corrected_velocity, sm_invariants,
                                  sm_rebind_rows)
from ..ops.sweeps import _COORD_SENTINEL, hash_axis_perm, hash_cells_perm
from .comm import Comm, refuse_grad
from .sharded_step import _simulate

_SENTINEL = _COORD_SENTINEL  # -1048576: marks rows the stencil ignores
# the fields a migrant carries, in the columns of the migration matrix
# (then `fixed` and the valid flag)
_MIG_FIELDS = ("pos", "vel", "orig_pos", "goal_pos", "mass", "dens", "vm",
               "iion", "stim", "w")


def slab_bounds(cfg: SimConfig, n_devices: int) -> np.ndarray:
    """Slow-axis cell-plane split points: rank d owns slow coordinates in
    [sb[d], sb[d+1]) of the permuted hash (hash_axis_perm)."""
    gs = cfg.grid_size[hash_axis_perm(cfg)[2]]
    return np.array([(d * gs) // n_devices for d in range(n_devices + 1)],
                    dtype=np.int32)


def z_slab_bounds(cfg: SimConfig, n_devices: int) -> np.ndarray:
    """The JAX package's alias: on the standard cubic world the permuted
    slow axis is z."""
    return slab_bounds(cfg, n_devices)


def _hash_ids(pos, active, cfg: SimConfig) -> torch.Tensor:
    """Slab-ownership sort key: the v4 sweeps' window sort key, by
    construction (both from ops/sweeps.hash_cells_perm), with the
    num_cells sentinel on inactive and out-of-grid rows."""
    return hash_cells_perm(pos, active, cfg)[4]


def halo_layout(state: ParticleState, n_devices: int, cfg: SimConfig,
                mig_cap: int = 0, halo_cap: int = 0, slack: float = 1.2,
                q_block: int = 128):
    """The slab re-layout of a full state over `n_devices` ranks, on the
    host: (arrays {field: numpy (D*S, ...)}, S, mig_cap, halo_cap). Rank
    d's rows [d*S, (d+1)*S) hold the particles of its slab, hash-sorted,
    then inactive padding (positions parked far outside the grid, mass and
    rest density kept). The JAX package's sizing policy: S = the largest
    slab occupancy x slack + 2 mig_cap, rounded up to max(128, q_block);
    mig_cap = 1.25 x one boundary plane's largest occupancy (a particle
    moves less than one cell a step), at least 128; halo_cap = slack x
    that occupancy, rounded up to 128; a capacity given is kept."""
    d = n_devices
    sb = slab_bounds(cfg, d)
    fa, ma, sa = hash_axis_perm(cfg)
    gplane = cfg.grid_size[fa] * cfg.grid_size[ma]
    gs = cfg.grid_size[sa]
    ids = _hash_ids(state.pos.detach().cpu(), state.active.cpu(),
                    cfg).numpy()
    order = np.argsort(ids, kind="stable")
    ids_s = ids[order]
    starts = np.searchsorted(ids_s, sb.astype(np.int64) * gplane)
    n_act = int(np.searchsorted(ids_s, cfg.num_cells))
    counts = np.diff(np.append(starts[:-1], n_act))
    # occupancy of each slow-axis cell plane sizes both exchange caps
    plane = np.maximum(ids_s[:n_act] // gplane, 0)
    plane_counts = np.bincount(plane.astype(np.int64), minlength=gs)
    if not mig_cap:
        mig_cap = max(128, int(-(-int(plane_counts.max() * 1.25)
                                 // 128) * 128))
    if not halo_cap:
        halo_cap = int(-(-int(plane_counts.max() * slack) // 128) * 128)
    align = max(128, q_block)
    s_cap = int(-(-int(counts.max() * slack + 2 * mig_cap) // align)
                * align)

    cap = state.capacity
    rows = [order[starts[k]:(min(starts[k + 1], n_act) if k < d - 1
                              else n_act)] for k in range(d)]
    far = 4.0 * max(cfg.world_size)
    out = {}
    for name in FIELD_NAMES:
        arr = getattr(state, name).detach().cpu().numpy()
        if arr.ndim == 0 or arr.shape[0] != cap:
            out[name] = arr
            continue
        lay = np.zeros((d * s_cap,) + arr.shape[1:], dtype=arr.dtype)
        for k in range(d):
            seg = arr[rows[k]]
            lay[k * s_cap:k * s_cap + len(seg)] = seg
            if arr.dtype == np.float32 and arr.ndim == 2:
                # park padded positions far outside the grid
                lay[k * s_cap + len(seg):(k + 1) * s_cap] = far
        out[name] = lay
    act = np.zeros((d * s_cap,), bool)
    for k in range(d):
        act[k * s_cap:k * s_cap + len(rows[k])] = True
    # padding keeps nonzero mass / rest density like init_fluid's padding
    # (a zero mass turns g*dt/m into inf, which masked products would then
    # turn into NaN)
    out["active"] = act
    out["mass"] = np.where(act, out["mass"], np.float32(cfg.particle_mass))
    out["dens"] = np.where(act, out["dens"], np.float32(cfg.stand_density))
    return out, s_cap, mig_cap, halo_cap


def shard_state_halo(state: ParticleState, mesh: Comm, cfg: SimConfig,
                     mig_cap: int = 0, halo_cap: int = 0,
                     slack: float = 1.2, q_block: int = 128):
    """Re-layout a full (single-device) state into slow-axis slab
    ownership: (this rank's (S, ...) rows on its device, S, mig_cap,
    halo_cap), sized as halo_layout says. Every rank computes the same
    layout from the same full state, so no collective is needed."""
    lay, s_cap, mig_cap, halo_cap = halo_layout(
        state, mesh.size, cfg, mig_cap, halo_cap, slack, q_block)
    lo = mesh.rank * s_cap
    # np.array keeps the 0-dim stim flag 0-dim (ascontiguousarray makes
    # it (1,), a shape the stim-off's in-place write would then keep)
    local = {n: torch.from_numpy(np.array(a) if a.ndim == 0 else
                                 np.ascontiguousarray(a[lo:lo + s_cap]))
             .to(mesh.device) for n, a in lay.items()}
    return ParticleState(**local), s_cap, mig_cap, halo_cap


def _halo_body(state: ParticleState, cfg: SimConfig, sub_q: int,
               mig_cap: int, halo_cap: int, mesh: Comm, sm_inv,
               params=None):
    """One coupled step of this rank's slab: migration, shape matching,
    sweep A and sweep B each after a boundary-plane exchange. Returns
    (state, overflow summed over the ranks)."""
    cfg_eff = resolve_params(cfg, params)
    dev = state.device
    dynp = build_dynp(cfg_eff, dev) if params else None
    s_cap = state.capacity
    n_dev, d = mesh.size, mesh.rank
    fa, ma, _sa = hash_axis_perm(cfg)
    gf, gm = cfg.grid_size[fa], cfg.grid_size[ma]
    gplane = gf * gm
    sb = slab_bounds(cfg, n_dev)
    my_lo, my_hi = int(sb[d]) * gplane, int(sb[d + 1]) * gplane
    num_cells = cfg.num_cells
    i32 = dict(dtype=torch.int32, device=dev)

    # ---- 1+2. migration and one local sort ----------------------------
    ids = _hash_ids(state.pos, state.active, cfg)
    # inactive rows hash to the num_cells sentinel: never left-emigrants,
    # excluded from the right test explicitly
    left_flag = ids < my_lo
    right_flag = (ids >= my_hi) & (ids < num_cells)
    overflow = (torch.clamp(left_flag.sum(dtype=torch.int32) - mig_cap,
                            min=0)
                + torch.clamp(right_flag.sum(dtype=torch.int32) - mig_cap,
                              min=0))
    cols = [getattr(state, f) for f in _MIG_FIELDS]
    cols = [c[:, None] if c.dim() == 1 else c for c in cols]
    core_valid = state.active & ~left_flag & ~right_flag
    mat = torch.cat(cols + [state.fixed.to(torch.float32)[:, None],
                            core_valid.to(torch.float32)[:, None]], dim=1)
    mig_iota = torch.arange(mig_cap, **i32)

    def pack(flag):
        """The flagged rows compacted to the head of a (mig_cap, C)
        buffer: cumsum ranks and one scatter (rows past mig_cap land on
        the dump row, counted by the overflow above); the valid column
        marks the first min(count, mig_cap) rows for the receiver."""
        rank = torch.cumsum(flag.to(torch.int32), 0, dtype=torch.int32) - 1
        idx = torch.where(flag & (rank < mig_cap), rank,
                          torch.full_like(rank, mig_cap))
        buf = mat.new_zeros((mig_cap + 1, mat.shape[1]))
        buf[idx.long()] = mat
        buf = buf[:mig_cap]
        valid = mig_iota < flag.sum(dtype=torch.int32)
        buf[:, -1] = valid.to(buf.dtype)
        return buf

    left_in = mesh.shift(pack(right_flag), +1)    # from d-1's tail
    right_in = mesh.shift(pack(left_flag), -1)    # from d+1's head

    # land the immigrants: merge S + 2M rows, sort once, keep the first S
    merged = torch.cat([mat, left_in, right_in], dim=0)
    ids2 = _hash_ids(merged[:, 0:3], merged[:, -1] > 0.5, cfg)
    order2 = torch.argsort(ids2, stable=True)[:s_cap]
    ids2_s = ids2[order2]
    # active rows beyond S are lost: reported through the overflow count
    overflow = overflow + torch.clamp(
        (ids2 < num_cells).sum(dtype=torch.int32) - s_cap, min=0)
    ms = merged[order2]                      # the one wide row gather
    actj = ms[:, -1] > 0.5
    parts, k = {}, 0
    for f in _MIG_FIELDS:
        w = 3 if getattr(state, f).dim() == 2 else 1
        parts[f] = ms[:, k:k + w] if w == 3 else ms[:, k]
        k += w
    zero1 = state.pos.new_zeros((s_cap,))
    zero3 = state.pos.new_zeros((s_cap, 3))
    state = ParticleState(
        pos=parts["pos"], vel=parts["vel"], predicted_vel=zero3,
        corrected_vel=zero3, inter_vel=zero3, acc=zero3,
        orig_pos=parts["orig_pos"], goal_pos=parts["goal_pos"],
        # padding rows keep nonzero mass / rest density (dt/m stays finite)
        mass=torch.where(actj, parts["mass"],
                         torch.full_like(zero1, cfg.particle_mass)),
        dens=torch.where(actj, parts["dens"],
                         torch.full_like(zero1, cfg.stand_density)),
        pres=zero1, vm=parts["vm"], inter_vm=zero1, iion=parts["iion"],
        stim=parts["stim"], w=parts["w"], fixed=ms[:, -2] > 0.5,
        active=actj, is_stim_on=state.is_stim_on)

    # ---- 3. shape matching (moments summed over the ranks) -------------
    # the hoisted invariants' per-row members follow the migrated rows
    sm_inv = sm_rebind_rows(sm_inv, state, cfg)
    state = corrected_velocity(state, cfg_eff, sm_inv=sm_inv, comm=mesh)

    # ---- 4. sweep A after one boundary-plane exchange ------------------
    nc = const_tensor(num_cells, dev, torch.int32)
    act_end2 = torch.searchsorted(ids2_s, nc.reshape(1),
                                  out_int32=True)[0]
    # v4 stencil features from the permuted hash: cx = fast-axis cell
    # coordinate (sentinel on dead rows), cyz = mid + Gm * slow
    live = ids2_s < num_cells
    cx = torch.where(live, (ids2_s % gf).to(torch.float32),
                     torch.full_like(zero1, _SENTINEL))
    cyz = torch.where(live, (ids2_s // gf).to(torch.float32), zero1)
    # QM_A column contract: ops/fused_step.build_qm_feats
    fields = torch.cat([
        state.pos, state.corrected_vel, state.mass[:, None],
        state.dens[:, None], state.vm[:, None], state.stim[:, None],
        state.iion[:, None], state.w[:, None], cx[:, None], cyz[:, None],
        state.pos.new_zeros((s_cap, 2))], dim=1)
    hiota = torch.arange(halo_cap, **i32)
    # the first and last halo_cap rows, clamped into the S rows as
    # dynamic_slice clamps its start
    tail_lo = torch.clamp(act_end2 - halo_cap, min=0, max=s_cap - halo_cap)
    tail_rows = (tail_lo + hiota).long()

    def exchange_halo(mat):
        """Send my first / last boundary rows to my neighbours; return the
        (halo_cap, C) blocks to prepend / append and their window ids,
        kept monotone: head rows past my active rows take num_cells (the
        receiver appends them), tail rows past them my_hi - 1 (the
        receiver prepends them); such rows carry sentinel features
        already, so the stencil ignores them."""
        head, tail = mat[:halo_cap], mat[tail_rows]
        head_ids = torch.where(hiota < act_end2, ids2_s[:halo_cap],
                               torch.full_like(hiota, num_cells))
        tail_ids = torch.where(hiota < act_end2 - tail_lo,
                               torch.clamp(ids2_s[tail_rows], max=my_hi - 1),
                               torch.full_like(hiota, my_hi - 1))
        # the int32 ids ride the float matrix as a BITCAST: ids can reach
        # num_cells, which passes 2^24 around ~12.3M-cell worlds, where a
        # value round trip through f32 would merge adjacent planes' ids
        left = mesh.shift(torch.cat(
            [tail, tail_ids.view(torch.float32)[:, None]], dim=1), +1)
        right = mesh.shift(torch.cat(
            [head, head_ids.view(torch.float32)[:, None]], dim=1), -1)
        # edge ranks receive zeros: mark those rows inert
        if d > 0:
            l_mat = left[:, :-1]
            l_ids = left[:, -1].contiguous().view(torch.int32)
        else:
            l_mat = torch.full_like(left[:, :-1], _SENTINEL)
            l_ids = torch.zeros_like(hiota)
        if d < n_dev - 1:
            r_mat = right[:, :-1]
            r_ids = right[:, -1].contiguous().view(torch.int32)
        else:
            r_mat = torch.full_like(right[:, :-1], _SENTINEL)
            r_ids = torch.full_like(hiota, num_cells)
        return l_mat, l_ids, r_mat, r_ids

    l_mat, l_ids, r_mat, r_ids = exchange_halo(fields)
    # window ids sorted across [left halo | core | right halo]: the core's
    # inactive sentinel ids (num_cells, which would sort after the right
    # halo's) clamp down to my_hi - 1, on the candidate side only; their
    # features keep the sentinel, so the stencil still ignores them
    win_ids = torch.where(live, ids2_s, torch.full_like(ids2_s, my_hi - 1))
    merged_ids = torch.cat([l_ids, win_ids, r_ids])
    # query-side probe ids stay unclamped: pure-padding sub-blocks probe
    # past every real plane and get empty windows
    probe_ids = torch.where(live, ids2_s,
                            torch.full_like(ids2_s, num_cells + 2 * gplane))
    merged_fs = torch.cat([l_mat, fields, r_mat], dim=0)

    overflow = overflow + _plane_overflow(ids2_s, act_end2, my_lo, my_hi,
                                          gplane, halo_cap, d, n_dev)
    blk_lo, blk_hi = _window_bounds3(probe_ids, merged_ids, cfg, sub_q)
    # dead rows here (inactive core padding, invalid exchanged rows, an
    # edge rank's all-sentinel blocks) all carry the cx sentinel
    out_a = sweep_a3(fields, feats_a_from_fs(merged_fs), blk_lo, blk_hi,
                     cfg, sub_q=sub_q, dynp=dynp)

    # ---- 5. sweep B after the second exchange --------------------------
    la, _, ra, _ = exchange_halo(out_a)
    merged_a = torch.cat([la, out_a, ra], dim=0)
    out_b = sweep_b3(out_a, feats_from_out_a(merged_a, vol_now(merged_a)),
                     blk_lo, blk_hi, cfg, sub_q=sub_q, dynp=dynp)

    # ---- 6. final state (rank-sorted layout, no unsort) ----------------
    state = apply_out_fused(state, out_a, out_b)
    # overflow sums three failure modes over the ranks: emigrants beyond
    # mig_cap, active rows beyond S, boundary-plane rows beyond halo_cap
    return state, mesh.all_sum(overflow)


def _plane_overflow(ids_s, act_end, my_lo: int, my_hi: int, gplane: int,
                    halo_cap: int, d: int, n_devices: int):
    """Boundary-plane rows beyond the halo capacity. An edge rank's outer
    plane has no partner, so it is not counted."""
    probe = const_tensor((my_lo + gplane, my_hi - gplane), ids_s.device,
                         torch.int32)
    first_end, last_start = torch.searchsorted(ids_s, probe, out_int32=True)
    zero = torch.zeros((), dtype=torch.int32, device=ids_s.device)
    n_first = torch.minimum(first_end, act_end)
    n_last = act_end - torch.minimum(last_start, act_end)
    ovf_first = torch.clamp(n_first - halo_cap, min=0) if d > 0 else zero
    ovf_last = (torch.clamp(n_last - halo_cap, min=0)
                if d < n_devices - 1 else zero)
    return ovf_first + ovf_last


def _window_bounds3(core_ids, merged_ids, cfg: SimConfig, sub_q: int):
    """Each sub-block's three slow-plane candidate windows in the merged
    array (sweeps.sweep_bookkeeping3's searchsorted step on the merged
    ids): window r spans the ids [h_lo + ds*Gf*Gm - Gf - 1, h_hi +
    ds*Gf*Gm + Gf + 2), ds = r - 1, covering the 3x3 (fast, mid)
    footprint. Returns (blk_lo, blk_hi), 4 bounds a sub-block."""
    fa, ma, _sa = hash_axis_perm(cfg)
    gf, gm = cfg.grid_size[fa], cfg.grid_size[ma]
    num_cells = cfg.num_cells
    b = core_ids.shape[0] // sub_q
    h_lo = core_ids[::sub_q][:b]
    h_hi = core_ids[sub_q - 1::sub_q][:b]
    dvec = const_tensor((-gf * gm, 0, gf * gm), core_ids.device,
                        torch.int32)
    blo = torch.clamp(h_lo[:, None] + dvec[None, :] - (gf + 1), 0,
                      num_cells)
    bhi = torch.clamp(h_hi[:, None] + dvec[None, :] + (gf + 2), 0,
                      num_cells)
    lo = torch.searchsorted(merged_ids, blo.contiguous(), out_int32=True)
    hi = torch.searchsorted(merged_ids, bhi.contiguous(), out_int32=True)
    flat4 = lambda a: torch.nn.functional.pad(a, (0, 1)).reshape(-1)  # noqa: E731
    return flat4(lo), flat4(hi)


def unshard_state_halo(state: ParticleState, num_particles: int,
                       cfg: SimConfig, pad_to: int | None = None,
                       allow_loss: bool = False) -> ParticleState:
    """A full halo layout (every rank's rows in rank order, e.g. from
    sharded_step.gather_state) compacted back into a dense state: the
    active rows, in rank-major order (globally slab-sorted), in rows [0,
    n) of a state padded as init_fluid pads, on the state's device. For
    checkpoints, renders and trajectories; not the hot loop.

    A state whose active count is not `num_particles` (capacity overflow
    lost rows) raises, unless `allow_loss` (view-only callers), which
    warns on stderr instead."""
    act = state.active.detach().cpu().numpy()
    idx = np.nonzero(act)[0]
    n = int(idx.size)
    if n != num_particles:
        msg = (f"unshard_state_halo: expected {num_particles} active "
               f"particles, state has {n} (capacity overflow loss)")
        if not allow_loss:
            raise ValueError(msg)
        print(msg, file=sys.stderr, flush=True)
    cap = pad_to or ((max(n, 1) + 127) // 128) * 128
    if cap < n:
        raise ValueError(f"pad_to={cap} < active rows {n}")
    far = 4.0 * max(cfg.world_size)
    fill = {"pos": far, "orig_pos": far, "goal_pos": far,
            "mass": cfg.particle_mass, "dens": cfg.stand_density,
            "fixed": False, "active": False}
    out = {}
    for name in FIELD_NAMES:
        arr = getattr(state, name).detach().cpu().numpy()
        if arr.ndim == 0 or arr.shape[0] != act.shape[0]:
            out[name] = torch.from_numpy(np.array(arr))
            continue
        dense = np.full((cap,) + arr.shape[1:], fill.get(name, 0),
                        dtype=arr.dtype)
        dense[:n] = arr[idx]
        out[name] = torch.from_numpy(dense)
    return ParticleState(**{k: v.to(state.device) for k, v in out.items()})


def make_halo_step(mesh: Comm, cfg: SimConfig, mig_cap: int, halo_cap: int,
                   sub_q: int = 128):
    """The halo-exchange step: (state, params=None) -> (state, overflow),
    state from shard_state_halo (S rows a rank, a multiple of sub_q);
    params (config.PARAM_FIELDS overrides) reach the kernels through the
    physics-constant vector. Eager, and not differentiable
    (comm.refuse_grad)."""
    def impl(state, params=None):
        refuse_grad("the multi-device step 'halo'", state, params)
        ensure_fp32()
        sm_inv = sm_invariants(state, cfg, comm=mesh)
        return _halo_body(state, cfg, sub_q, mig_cap, halo_cap, mesh,
                          sm_inv, params)
    return impl


def make_halo_simulate(mesh: Comm, cfg: SimConfig, mig_cap: int,
                       halo_cap: int, num_steps: int,
                       stim_off_step: int = -1, sub_q: int = 128):
    """N halo-exchange steps with the reference stim-off protocol
    (main.cpp:329-334) through the transport's run loop
    (sharded_step.run_loop: graphed over NCCL); the rest-shape moments
    hoisted (their sums do not depend on which rank holds a row):
    (state, params=None) -> (state, largest per-step overflow). Not
    differentiable (comm.refuse_grad)."""
    return _simulate(
        lambda st, inv, prm: _halo_body(st, cfg, sub_q, mig_cap, halo_cap,
                                        mesh, inv, prm),
        ("halo", cfg, sub_q, mig_cap, halo_cap), mesh, cfg, num_steps,
        stim_off_step)

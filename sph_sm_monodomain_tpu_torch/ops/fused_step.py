"""Fused coupled step: two neighbor sweeps with fused pointwise epilogues
(mirror of `sph_sm_monodomain_tpu.ops.fused_step`), in three generations
that differ only in how a sub-block enumerates its candidates:
  v4 (`sweep_a3` / `sweep_b3`, stencil "xyz3"): three merged slow-plane
      windows, per-axis (cx, cyz) mask;
  v3 (`sweep_a3_hash9` / `sweep_b3_hash9`, stencil "hash9"): nine (dy, dz)
      run windows, linear-hash mask;
  v5 (`sweep_a5` / `sweep_b5`): the sub-block's own packed candidate slab
      (`pack_feats_a5` / `pack_feats_b5`), per-axis (cf, cm, cs) mask,
      constants baked from the config.

  sweep A: XSPH + density gather (calculate_intermediate_velocity
      cpp:669-701 + Compute_Density_SingPressure cpp:448-513), epilogue:
      EOS pressure, voltage coupling, stim gate (cpp:486-503) and the FHN
      reaction (calculate_cell_model cpp:575-593).
  sweep B: pressure/viscosity forces + Vm Laplacian gather (Compute_Force
      cpp:515-573), epilogue: semi-implicit Euler, voltage update, walls
      and AABB clamp (Update_Properties cpp:596-651).

  Laplacian-only sweep (`sweep_lap3`): the Vm diffusion half of sweep B
      with two accumulators, for the frozen-cloud monodomain mode
      (models/variants.py), forward and backward.

On a CUDA tensor each sweep is one hand-written kernel
(csrc/fused_sweeps.cu); on a CPU tensor the wrapper runs the plain PyTorch
version in this module (`sweep_a3_plain` / `sweep_b3_plain` with their
`stencil`, `sweep_a5_plain` / `sweep_b5_plain`, `sweep_lap3_plain`), which
the tests hold to the JAX package and chip_smoke.py holds the kernels to.
`_epi_a` / `_epi_b` are each sweep's epilogue as a function of its pair
sums; ops/fused_adjoint.py takes their VJP with autograd.

Layouts (16 f32 columns per particle, sorted order), as in the JAX package:
  QM_A / fs:  [pos3 | cvel3 | mass | dens_prev | vm | stim | iion | w |
               cx | cyz | - | -]
  OUT_A/QM_B: [pos3 | ivel3 | pres | vm | dens | react | mass | iion' |
               cx | cyz | - | w']   (react = (iion' - stim*dt/m)/Cm)
  OUT_B:      [pos'3 | vel'3 | vm' | dens | pres | iion' | w' | inter_vm |
               acc3 | 0]
Candidate feature rows (16, N):
  sweep A: [pos3 | cvel3 | vol_prev | mass | - - - - | cx | cyz | - -]
  sweep B: [pos3 | ivel3 | vol | pres | vm | - - - | cx | cyz | - -]
The cell-feature columns 12-14 are (cx, cyz, -) under v4, (hash, 0, -)
under v3 and (cf, cm, cs) under v5; the v5 slabs (B, 16, kb) carry the
candidate rows above with cf cm cs in rows 12-14.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from . import cuda_lib
from .constants import const_tensor
from .sweeps import _COORD_SENTINEL, _PAIR_EPS, RUN_OFFSETS, hash_axis_perm

# --- physics constants ------------------------------------------------------
# The kernels (and the plain versions) read every physics scalar from one
# (32,) f32 vector: the 16 dynamic slots of the JAX package's `build_dynp`
# operand (config.PARAM_FIELDS-derived, 14 used), then the static constants.
# So the per-call `params` overrides and the default config take one path.
_DYN_SLOTS = ("velocity_mixing", "k_stiffness", "stand_density",
              "voltage_constant", "fh_vr", "fh_denom", "fh_asd",
              "fh_c1", "fh_c2", "fh_c3", "fh_c4", "cm_capacitance",
              "mu_viscosity", "vm_scale")  # 14 used; 2 spare slots
_STATIC_SLOTS = ("kernel_h", "h2", "inv_h", "poly6", "spiky", "bspline",
                 "dt", "max_pressure", "max_voltage", "wall_hit",
                 "world_x", "world_y", "world_z")  # from slot 16 on
# csrc/fused_sweeps.cu (enum Slot) reads the same 32-slot layout


def _derived_consts(cfg: SimConfig) -> dict:
    """The 14 dynamic scalars from a (possibly overridden) config."""
    return dict(
        velocity_mixing=cfg.velocity_mixing,
        k_stiffness=cfg.k_stiffness,
        stand_density=cfg.stand_density,
        voltage_constant=cfg.voltage_constant,
        fh_vr=cfg.fh_vr,
        fh_denom=cfg.fh_vp - cfg.fh_vr,
        fh_asd=(cfg.fh_vt - cfg.fh_vr) / (cfg.fh_vp - cfg.fh_vr),
        fh_c1=cfg.fh_c1, fh_c2=cfg.fh_c2, fh_c3=cfg.fh_c3, fh_c4=cfg.fh_c4,
        cm_capacitance=cfg.cm_capacitance,
        mu_viscosity=cfg.mu_viscosity,
        vm_scale=cfg.sigma / (cfg.beta_sv_ratio * cfg.cm_capacitance),
    )


def _static_consts(cfg: SimConfig) -> tuple:
    """Static slots: each value computed in double, rounded to f32 once
    (the JAX kernels bake `jnp.float32(<double expression>)`)."""
    vals = (cfg.kernel_h, cfg.kernel_h * cfg.kernel_h, 1.0 / cfg.kernel_h,
            cfg.poly6_constant, cfg.spiky_constant, cfg.b_spline_constant,
            cfg.time_delta, cfg.max_pressure, cfg.max_voltage, cfg.wall_hit,
            *cfg.world_size)
    return tuple(float(v) for v in vals) + (0.0,) * (16 - len(vals))


def build_dynp(cfg_eff: SimConfig, device="cpu") -> torch.Tensor:
    """(1, 16) f32 dynamic-params operand from a resolve_params'd config.
    Fields may be 0-dim tensors; a slot derived from one keeps its autograd
    graph, so gradients reach the `params` overrides. Python-float slots
    come from the per-device constant cache (no host-to-device copy)."""
    vals = _derived_consts(cfg_eff)
    floats = const_tensor(tuple(
        0.0 if torch.is_tensor(vals[k]) else float(vals[k])
        for k in _DYN_SLOTS) + (0.0,) * (16 - len(_DYN_SLOTS)),
        torch.device(device))
    vec = [vals[k].to(device, torch.float32).reshape(())
           if torch.is_tensor(vals[k]) else floats[i]
           for i, k in enumerate(_DYN_SLOTS)]
    return torch.stack(vec + list(floats[len(_DYN_SLOTS):])).reshape(1, 16)


def kernel_params(cfg: SimConfig, dynp=None, device="cpu") -> torch.Tensor:
    """(32,) f32 physics-constant vector: `dynp` (or cfg's own dynamic
    values) followed by the static constants of `cfg`."""
    device = torch.device(device)
    static = _static_consts(cfg)
    if dynp is None:
        vals = _derived_consts(cfg)
        dyn = tuple(float(vals[k]) for k in _DYN_SLOTS) \
            + (0.0,) * (16 - len(_DYN_SLOTS))
        return const_tensor(dyn + static, device)
    return torch.cat([dynp.reshape(16).to(device, torch.float32),
                      const_tensor(static, device)])


class _Phys:
    """Named 0-dim views into a kernel_params vector."""

    def __init__(self, prm: torch.Tensor):
        for i, k in enumerate(_DYN_SLOTS):
            setattr(self, k, prm[i])
        for i, k in enumerate(_STATIC_SLOTS):
            setattr(self, k, prm[16 + i])
        self.world = (self.world_x, self.world_y, self.world_z)


# --- epilogues (shared by the plain versions; the kernels mirror them) -----

def _a_epilogue(cfg: SimConfig, with_ep: bool, mass, vm, stim, iion, w_rec,
                dens, P: _Phys):
    """EOS pressure + stim gate + FHN reaction on gathered densities
    (cpp:483-503, 575-593). Returns (dens', pres, react, iion', w')."""
    if cfg.quirk_double_self_density:                    # cpp:483
        dens = dens + mass * (P.poly6 * P.h2 * P.h2 * P.h2)
    pres = P.k_stiffness * (dens - P.stand_density)      # cpp:486
    if with_ep:
        pres = pres - vm * P.voltage_constant            # cpp:491
    pres_c = torch.clamp(pres, -P.max_pressure, P.max_pressure)
    if cfg.quirk_pressure_stim_gate:                     # cpp:493-503
        pres = torch.where(stim > 0.0, pres_c, torch.full_like(pres_c, -0.0))
    else:
        pres = pres_c
    if with_ep:
        u = (vm - P.fh_vr) / P.fh_denom
        d_iion = P.dt * (P.fh_c1 * u * (u - P.fh_asd) * (u - 1.0)
                         + P.fh_c2 * w_rec) / mass
        iion_n = (iion + d_iion) if cfg.quirk_iion_accumulate else d_iion
        w_n = w_rec + P.dt * P.fh_c3 * (u - P.fh_c4 * w_rec) / mass
        react = (iion_n - stim * (P.dt / mass)) / P.cm_capacitance  # cpp:571
    else:
        zero = torch.zeros_like(dens)
        iion_n, w_n, react = zero, zero, zero
    return dens, pres, react, iion_n, w_n


def _b_epilogue(cfg: SimConfig, with_ep: bool, qpos, qiv, qvm, dens, react,
                mass, acc_raw, lap, P: _Phys):
    """Acceleration normalization + voltage update + semi-implicit Euler +
    walls (cpp:568-571, 596-651). Returns (pos', vel', vm', inter_vm, acc)."""
    dens_g = torch.where(dens > 0.0, dens, torch.ones_like(dens))
    acc = acc_raw / dens_g                               # cpp:568
    dtm = P.dt / mass
    if with_ep:
        inter_vm = lap + P.vm_scale * lap - react        # cpp:571
        vm_new = torch.clamp(qvm + inter_vm * dtm, -P.max_voltage,
                             P.max_voltage)              # cpp:612
    else:
        inter_vm = torch.zeros_like(qvm)
        vm_new = qvm
    vel = qiv + acc * dtm                                # cpp:608
    pos = qpos + vel * P.dt                              # cpp:609
    p_cols, v_cols = [], []
    for ax in range(3):
        wlim = P.world[ax]
        p = pos[:, ax:ax + 1]
        v = vel[:, ax:ax + 1]
        low = p < 0.0
        high = p >= wlim
        v = torch.where(low | high, v * P.wall_hit, v)
        p = torch.where(low, torch.zeros_like(p), p)
        p = torch.where(high, wlim - 1e-4, p)
        p_cols.append(torch.minimum(torch.clamp(p, min=0.0), wlim))  # cpp:649
        v_cols.append(v)
    return (torch.cat(p_cols, dim=1), torch.cat(v_cols, dim=1), vm_new,
            inter_vm, acc)


def _epi_a(cfg: SimConfig, raw_d, raw_x, fs, dynp=None,
           with_ep: bool = True) -> torch.Tensor:
    """Sweep A's epilogue and copies: pair sums (raw_d (N,) density, raw_x
    (N, 3) XSPH) + QM_A -> OUT_A (the counterpart of the JAX package's
    `_epi_a_jnp`). The plain version and the sweep-A kernel compute the same
    operations, so autograd over this function is the epilogue's VJP."""
    P = _Phys(kernel_params(cfg, dynp, fs.device))
    ivel = fs[:, 3:6] + raw_x * P.velocity_mixing            # cpp:699
    mass, vm = fs[:, 6:7], fs[:, 8:9]
    dens, pres, react, iion_n, w_n = _a_epilogue(
        cfg, with_ep, mass, vm, fs[:, 9:10], fs[:, 10:11], fs[:, 11:12],
        raw_d[:, None], P)
    return torch.cat([fs[:, 0:3], ivel, pres, vm, dens, react, mass, iion_n,
                      fs[:, 12:15], w_n], dim=1)


def _epi_b(cfg: SimConfig, raw_acc, raw_lap, out_a, dynp=None,
           with_ep: bool = True) -> torch.Tensor:
    """Sweep B's epilogue and copies: pair sums (raw_acc (N, 3), raw_lap
    (N,)) + OUT_A -> OUT_B (the counterpart of `_epi_b_jnp`)."""
    P = _Phys(kernel_params(cfg, dynp, out_a.device))
    dens, qp = out_a[:, 8:9], out_a[:, 6:7]
    pos_n, vel_n, vm_new, inter_vm, acc = _b_epilogue(
        cfg, with_ep, out_a[:, 0:3], out_a[:, 3:6], out_a[:, 7:8], dens,
        out_a[:, 9:10], out_a[:, 10:11], raw_acc, raw_lap[:, None], P)
    return torch.cat([pos_n, vel_n, vm_new, dens, qp, out_a[:, 11:12],
                      out_a[:, 15:16], inter_vm, acc,
                      torch.zeros_like(dens)], dim=1)


# --- plain versions: dense masked pair sums over every candidate -----------

def _rows_per_chunk(n: int, device: torch.device) -> int:
    budget = (1 << 24) if device.type == "cuda" else (1 << 21)
    return max(1, budget // max(n, 1))


def _qcol(q, i: int):
    """Column i of query rows q (..., R, 16) as (..., R, 1)."""
    return q[..., i:i + 1]


def _crow(c, i: int):
    """Feature row i of candidates c (..., 16, C) as (..., 1, C)."""
    return c[..., i:i + 1, :]


def _stencil(q, c, gm: float, full: bool) -> torch.Tensor:
    """Exact v4 cell stencil between query rows `q` (..., R, 16) and
    candidates `c` (..., 16, C): the cyz test of any of the three
    slow-plane windows, the cx test when `full`, both rows live. A pair
    passes under at most one window (G_mid >= 3), so 'any' counts it
    once."""
    qcyz, ccyz = _qcol(q, 13), _crow(c, 13)
    m = ((qcyz - gm - ccyz).abs() <= 1.0) | ((qcyz - ccyz).abs() <= 1.0) \
        | ((qcyz + gm - ccyz).abs() <= 1.0)
    if full:
        m &= (_qcol(q, 12) - _crow(c, 12)).abs() <= 1.0
    return m & (_qcol(q, 12) >= 0.0) & (_crow(c, 12) >= 0.0)


def _stencil_hash9(q, c, gx: int, gy: int) -> torch.Tensor:
    """Exact v3 stencil: |qh + d_r - ch| <= 1 on the linear cell hash (row
    and column 12) for one of the nine run offsets d_r = Gx*(dy + Gy*dz),
    both rows live. The offsets differ by >= Gx > 2, so a pair passes
    under at most one of them."""
    qh, ch = _qcol(q, 12), _crow(c, 12)
    m = torch.zeros(torch.broadcast_shapes(qh.shape, ch.shape),
                    dtype=torch.bool, device=q.device)
    for dy, dz in RUN_OFFSETS:
        m |= ((qh + float(gx * (dy + gy * dz))) - ch).abs() <= 1.0
    return m & (qh >= 0.0) & (ch >= 0.0)


def _stencil_cells(q, c) -> torch.Tensor:
    """Exact v5 stencil: |dcf|, |dcm|, |dcs| <= 1 on the per-axis cell
    coordinates in rows and columns 12-14 (dead rows carry a cf
    sentinel)."""
    m = (_qcol(q, 12) - _crow(c, 12)).abs() <= 1.0
    for i in (13, 14):
        m = m & ((_qcol(q, i) - _crow(c, i)).abs() <= 1.0)
    return m


def _g_mid(cfg: SimConfig) -> int:
    return cfg.grid_size[hash_axis_perm(cfg)[1]]


def _mask_a_full(cfg: SimConfig) -> bool:
    """Sweep A's v4 mask: the cyz half alone when Poly6's support (h) is
    within one cell (cells >= 2 apart are > h apart, so the weight itself
    is 0); the full 27-cell mask on a finer grid."""
    return cfg.cell_size < cfg.kernel_h


def _window_mask(cfg: SimConfig, stencil: str, sweep_a: bool):
    """mask(q, c) of the v4 ("xyz3") or v3 ("hash9") sweeps. Under hash9
    sweep A takes the full hash mask: the "yz" shortcut is xyz3's."""
    if stencil == "xyz3":
        gm = float(_g_mid(cfg))
        full = not sweep_a or _mask_a_full(cfg)
        return lambda q, c: _stencil(q, c, gm, full)
    if stencil == "hash9":
        gx, gy, _ = cfg.grid_size
        return lambda q, c: _stencil_hash9(q, c, gx, gy)
    raise ValueError(f"unknown stencil {stencil!r} (expected xyz3 / hash9)")


def _terms_a(q, c, m, P: _Phys) -> torch.Tensor:
    """(..., R, 4) [a_d, a_x, a_y, a_z]: Poly6 density and XSPH sums of
    query rows q (..., R, 16) over candidates c (..., 16, C) under the mask
    m, in the reference's per-pair difference form (cpp:483, 688-695)."""
    dx = _qcol(q, 0) - _crow(c, 0)
    dy = _qcol(q, 1) - _crow(c, 1)
    dz = _qcol(q, 2) - _crow(c, 2)
    r2 = dx * dx + dy * dy + dz * dz
    t = torch.clamp(P.h2 - r2, min=0.0)
    w6 = torch.where(m, P.poly6 * t * t * t, torch.zeros_like(t))
    wv = w6 * _crow(c, 6)                                # * vol_prev_j
    return torch.stack([
        (w6 * _crow(c, 7)).sum(-1),
        (wv * (_crow(c, 3) - _qcol(q, 3))).sum(-1),
        (wv * (_crow(c, 4) - _qcol(q, 4))).sum(-1),
        (wv * (_crow(c, 5) - _qcol(q, 5))).sum(-1)], dim=-1)


def _terms_b(q, c, m, P: _Phys, with_ep: bool) -> torch.Tensor:
    """(..., R, 4) [a_ax, a_ay, a_az, a_lap]: Spiky pressure + viscosity
    and the B-spline-2 Vm Laplacian (cpp:546-563) under the mask m with the
    r^2 > 1e-12 pair guard."""
    dx = _qcol(q, 0) - _crow(c, 0)
    dy = _qcol(q, 1) - _crow(c, 1)
    dz = _qcol(q, 2) - _crow(c, 2)
    r2 = dx * dx + dy * dy + dz * dz
    p = m & (r2 > _PAIR_EPS)
    inv_rr = torch.rsqrt(torch.where(p, r2, torch.ones_like(r2)))
    rr = r2 * inv_rr
    volm = torch.where(p, _crow(c, 6), torch.zeros_like(r2))
    hr = torch.clamp(P.kernel_h - rr, min=0.0)
    common = volm * (P.spiky * hr)
    f_p = common * (hr * (-0.5) * inv_rr) * (_qcol(q, 6) + _crow(c, 7))
    f_v = P.mu_viscosity * common
    cols = [(f_v * (_crow(c, 3 + k) - _qcol(q, 3 + k)) - f_p * d).sum(-1)
            for k, d in enumerate((dx, dy, dz))]
    if with_ep:
        qr = rr * P.inv_h
        w2 = P.bspline * (1.5 * torch.clamp(2.0 - qr, min=0.0)
                          - 6.0 * torch.clamp(1.0 - qr, min=0.0))
        cols.append(((volm * w2) * (_crow(c, 8) - _qcol(q, 7))).sum(-1))
    else:
        cols.append(torch.zeros_like(cols[0]))
    return torch.stack(cols, dim=-1)


def _dense_sums(qm, feats, mask, terms) -> torch.Tensor:
    """(N, 4) pair sums of every query row of qm (N, 16) over all
    candidates feats (16, N), in row chunks: terms(q, feats, mask(q,
    feats))."""
    rows = _rows_per_chunk(qm.shape[0], qm.device)
    return torch.cat([terms(q, feats, mask(q, feats))
                      for q in qm.split(rows)])


def _slab_sums(qm, slabs, terms) -> torch.Tensor:
    """(N, 4) pair sums of each sub-block of qm (N, 16) over its own packed
    slab of slabs (B, 16, kb) under the v5 cell mask, in chunks of
    blocks."""
    b, _, kb = slabs.shape
    q = qm.reshape(b, -1, 16)
    per = max(1, _rows_per_chunk(q.shape[1] * kb, qm.device))
    return torch.cat([terms(qb, sb, _stencil_cells(qb, sb))
                      for qb, sb in zip(q.split(per), slabs.split(per))]
                     ).reshape(-1, 4)


def sweep_a3_plain(fs, feats_a, cfg: SimConfig, with_ep: bool = True,
                   dynp=None, stencil: str = "xyz3") -> torch.Tensor:
    """Plain PyTorch sweep A: QM_A (N,16) + sweep-A features (16,N) ->
    OUT_A (N,16). Dense over all candidates (no window bounds) under the
    v4 ("xyz3") or v3 ("hash9") stencil; dead query rows (cell sentinel in
    column 12) get zero sums."""
    P = _Phys(kernel_params(cfg, dynp, fs.device))
    s = _dense_sums(fs, feats_a, _window_mask(cfg, stencil, True),
                    lambda q, c, m: _terms_a(q, c, m, P))
    return _epi_a(cfg, s[:, 0], s[:, 1:4], fs, dynp, with_ep)


def sweep_b3_plain(out_a, feats_b, cfg: SimConfig, with_ep: bool = True,
                   dynp=None, stencil: str = "xyz3") -> torch.Tensor:
    """Plain PyTorch sweep B: OUT_A (N,16) + sweep-B features (16,N) ->
    OUT_B (N,16)."""
    P = _Phys(kernel_params(cfg, dynp, out_a.device))
    s = _dense_sums(out_a, feats_b, _window_mask(cfg, stencil, False),
                    lambda q, c, m: _terms_b(q, c, m, P, with_ep))
    return _epi_b(cfg, s[:, 0:3], s[:, 3], out_a, dynp, with_ep)


def sweep_a5_plain(fs, packed_a, cfg: SimConfig,
                   with_ep: bool = True) -> torch.Tensor:
    """Plain PyTorch v5 sweep A: QM_A (N,16) with cf cm cs in columns
    12-14 + the sub-blocks' packed slabs (B,16,kb) -> OUT_A (N,16), each
    sub-block of N/B rows over its whole slab under the per-axis cell mask
    (the padding slots add exactly 0), constants from `cfg`."""
    P = _Phys(kernel_params(cfg, None, fs.device))
    s = _slab_sums(fs, packed_a, lambda q, c, m: _terms_a(q, c, m, P))
    return _epi_a(cfg, s[:, 0], s[:, 1:4], fs, None, with_ep)


def sweep_b5_plain(out_a, packed_b, cfg: SimConfig,
                   with_ep: bool = True) -> torch.Tensor:
    """Plain PyTorch v5 sweep B: OUT_A (N,16) + packed slabs (B,16,kb) ->
    OUT_B (N,16)."""
    P = _Phys(kernel_params(cfg, None, out_a.device))
    s = _slab_sums(out_a, packed_b,
                   lambda q, c, m: _terms_b(q, c, m, P, with_ep))
    return _epi_b(cfg, s[:, 0:3], s[:, 3], out_a, None, with_ep)


# --- wrappers ----------------------------------------------------------------

def _check_cuda_operands(qm, *operands) -> None:
    """On a CUDA query matrix: qm and every (name, tensor, dtype) operand
    contiguous, of that dtype, on qm's device."""
    if qm.device.type == "cpu":
        return
    for name, t, dt in (("qm", qm, torch.float32),) + operands:
        if t.device != qm.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{qm.device}, got {t.dtype} on {t.device}")


def _check_sweep_inputs(qm, feats, blk_lo, blk_hi, sub_q: int,
                        stride: int = 4) -> None:
    """Shapes of a window sweep: `stride` bounds per sub-block (4 for the
    v4 windows, 16 for the v3 runs)."""
    n = qm.shape[0]
    if qm.dim() != 2 or qm.shape[1] != 16:
        raise ValueError(f"query matrix must be (N, 16), got {tuple(qm.shape)}")
    if n == 0 or n % sub_q or sub_q % 32 or not 32 <= sub_q <= 1024:
        raise ValueError(f"{n} query rows must be a positive multiple of "
                         f"sub_q={sub_q} (a multiple of 32 in [32, 1024])")
    if tuple(feats.shape) != (16, n):
        raise ValueError(f"features must be (16, {n}), got "
                         f"{tuple(feats.shape)}")
    want = (n // sub_q) * stride
    for name, t in (("blk_lo", blk_lo), ("blk_hi", blk_hi)):
        if tuple(t.shape) != (want,):
            raise ValueError(f"{name} must be ({want},), got "
                             f"{tuple(t.shape)}")
    _check_cuda_operands(qm, ("feats", feats, torch.float32),
                         ("blk_lo", blk_lo, torch.int32),
                         ("blk_hi", blk_hi, torch.int32))


def _check_slab_inputs(qm, slabs, trips, sub_q: int, w_chunk: int) -> None:
    """Shapes of a v5 sweep: (N, 16) queries, one (16, kb) slab and one
    trip count per sub-block of `sub_q` rows, kb a multiple of w_chunk."""
    n = qm.shape[0]
    if qm.dim() != 2 or qm.shape[1] != 16:
        raise ValueError(f"query matrix must be (N, 16), got {tuple(qm.shape)}")
    if n == 0 or not 1 <= sub_q <= 1024 or n % sub_q:
        raise ValueError(f"{n} query rows must be a positive multiple of "
                         f"sub_q={sub_q} (in [1, 1024])")
    b = n // sub_q
    if slabs.dim() != 3 or tuple(slabs.shape[:2]) != (b, 16):
        raise ValueError(f"slabs must be ({b}, 16, kb), got "
                         f"{tuple(slabs.shape)}")
    if w_chunk <= 0 or slabs.shape[2] % w_chunk:
        raise ValueError(f"kb={slabs.shape[2]} must be a multiple of "
                         f"w_chunk={w_chunk}")
    if tuple(trips.shape) != (b,):
        raise ValueError(f"trips must be ({b},), got {tuple(trips.shape)}")
    _check_cuda_operands(qm, ("slabs", slabs, torch.float32),
                         ("trips", trips, torch.int32))


def _launch(fn, qm, *operands, out_cols: int = 16) -> torch.Tensor:
    """Launch fn(qm, *tensors, out, N, *ints, stream) on qm's device and
    stream into a new (N, out_cols) f32 output: `operands` are the tensor
    inputs after qm, then the int arguments. Raises on a CPU tensor and on
    a launch error."""
    if qm.device.type != "cuda":
        raise ValueError(f"no sweep kernel for device {qm.device}")
    tensors = [t.data_ptr() for t in operands if torch.is_tensor(t)]
    ints = [i for i in operands if not torch.is_tensor(i)]
    out = qm.new_empty((qm.shape[0], out_cols))
    with torch.cuda.device(qm.device):
        stream = torch.cuda.current_stream(qm.device).cuda_stream
        rc = fn(qm.data_ptr(), *tensors, out.data_ptr(), qm.shape[0], *ints,
                stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {rc} "
                           f"({cuda_lib.error_string(rc)})")
    return out


def _quirks(cfg: SimConfig) -> tuple:
    return (int(cfg.quirk_double_self_density),
            int(cfg.quirk_pressure_stim_gate),
            int(cfg.quirk_iion_accumulate))


def sweep_a3(fs, feats_a, blk_lo, blk_hi, cfg: SimConfig,
             with_ep: bool = True, sub_q: int = 128, dynp=None,
             stencil: str = "xyz3"):
    """QM_A (N,16) + sweep-A features (16,N) -> OUT_A (N,16), sorted order,
    over the three merged windows per sub-block of `sub_q` rows
    (blk_lo/blk_hi from sweeps.sweep_bookkeeping3). `dynp`: optional
    (1, 16) dynamic physics constants (build_dynp). On a CUDA tensor this
    launches the sweep-A kernel; on a CPU tensor it runs sweep_a3_plain.
    stencil="hash9" runs sweep_a3_hash9 (the v3 run windows) instead: the
    JAX package's signature, kept so code written against it ports as is;
    the step calls sweep_a3_hash9 directly."""
    if stencil == "hash9":
        return sweep_a3_hash9(fs, feats_a, blk_lo, blk_hi, cfg, with_ep,
                              sub_q, dynp)
    if stencil != "xyz3":
        raise ValueError(f"unknown stencil {stencil!r}")
    _check_sweep_inputs(fs, feats_a, blk_lo, blk_hi, sub_q)
    if fs.device.type == "cpu":
        return sweep_a3_plain(fs, feats_a, cfg, with_ep, dynp)
    lib = cuda_lib.load()
    out = _launch(lib.sph_sweep_a3, fs, feats_a, blk_lo, blk_hi,
                  kernel_params(cfg, dynp, fs.device), sub_q, int(with_ep),
                  int(_mask_a_full(cfg)), _g_mid(cfg), *_quirks(cfg))
    sweep_a3.launches += 1
    return out


sweep_a3.launches = 0


def sweep_b3(out_a, feats_b, blk_lo, blk_hi, cfg: SimConfig,
             with_ep: bool = True, sub_q: int = 128, dynp=None,
             stencil: str = "xyz3"):
    """OUT_A (N,16) + sweep-B features (16,N) -> OUT_B (N,16), sorted order.
    On a CUDA tensor this launches the sweep-B kernel; on a CPU tensor it
    runs sweep_b3_plain. stencil="hash9" runs sweep_b3_hash9 instead (the
    JAX package's signature, as in sweep_a3)."""
    if stencil == "hash9":
        return sweep_b3_hash9(out_a, feats_b, blk_lo, blk_hi, cfg, with_ep,
                              sub_q, dynp)
    if stencil != "xyz3":
        raise ValueError(f"unknown stencil {stencil!r}")
    _check_sweep_inputs(out_a, feats_b, blk_lo, blk_hi, sub_q)
    if out_a.device.type == "cpu":
        return sweep_b3_plain(out_a, feats_b, cfg, with_ep, dynp)
    lib = cuda_lib.load()
    out = _launch(lib.sph_sweep_b3, out_a, feats_b, blk_lo, blk_hi,
                  kernel_params(cfg, dynp, out_a.device), sub_q,
                  int(with_ep), _g_mid(cfg))
    sweep_b3.launches += 1
    return out


sweep_b3.launches = 0


# --- the v3 sweeps: nine hash run windows (sweeps.sweep_bookkeeping2) --------

def sweep_a3_hash9(fs, feats_a, blk_lo, blk_hi, cfg: SimConfig,
                   with_ep: bool = True, sub_q: int = 64, dynp=None):
    """Sweep A over the nine run windows per sub-block (blk_lo/blk_hi, 9
    used of each 16, from sweeps.sweep_bookkeeping2) with the linear-hash
    mask; QM_A carries the hash in column 12 and 0 in column 13. On a CUDA
    tensor this launches the hash9 sweep-A kernel; on a CPU tensor it runs
    sweep_a3_plain(stencil="hash9")."""
    _check_sweep_inputs(fs, feats_a, blk_lo, blk_hi, sub_q, stride=16)
    if fs.device.type == "cpu":
        return sweep_a3_plain(fs, feats_a, cfg, with_ep, dynp, "hash9")
    gx, gy, _ = cfg.grid_size
    out = _launch(cuda_lib.load().sph_sweep_a3_hash9, fs, feats_a, blk_lo,
                  blk_hi, kernel_params(cfg, dynp, fs.device), sub_q,
                  int(with_ep), gx, gy, *_quirks(cfg))
    sweep_a3_hash9.launches += 1
    return out


sweep_a3_hash9.launches = 0


def sweep_b3_hash9(out_a, feats_b, blk_lo, blk_hi, cfg: SimConfig,
                   with_ep: bool = True, sub_q: int = 64, dynp=None):
    """Sweep B over the nine run windows per sub-block with the
    linear-hash mask. On a CUDA tensor this launches the hash9 sweep-B
    kernel; on a CPU tensor it runs sweep_b3_plain(stencil="hash9")."""
    _check_sweep_inputs(out_a, feats_b, blk_lo, blk_hi, sub_q, stride=16)
    if out_a.device.type == "cpu":
        return sweep_b3_plain(out_a, feats_b, cfg, with_ep, dynp, "hash9")
    gx, gy, _ = cfg.grid_size
    out = _launch(cuda_lib.load().sph_sweep_b3_hash9, out_a, feats_b, blk_lo,
                  blk_hi, kernel_params(cfg, dynp, out_a.device), sub_q,
                  int(with_ep), gx, gy)
    sweep_b3_hash9.launches += 1
    return out


sweep_b3_hash9.launches = 0


# --- the v5 sweeps: per-sub-block packed slabs (sweeps.sweep_bookkeeping5) ---

def sweep_a5(fs, packed_a, trips, cfg: SimConfig, with_ep: bool = True,
             sub_q: int = 32, w_chunk: int = 128,
             static_trips: bool = False):
    """QM_A (N,16) + packed slabs (B,16,kb) -> OUT_A (N,16), sorted order:
    each sub-block of `sub_q` rows over the first trips[b]*w_chunk slots of
    its slab (the whole slab with `static_trips`, the v5s form), constants
    baked from `cfg`. On a CUDA tensor this launches the v5 sweep-A kernel;
    on a CPU tensor it runs sweep_a5_plain."""
    _check_slab_inputs(fs, packed_a, trips, sub_q, w_chunk)
    if fs.device.type == "cpu":
        return sweep_a5_plain(fs, packed_a, cfg, with_ep)
    out = _launch(cuda_lib.load().sph_sweep_a5, fs, packed_a, trips,
                  kernel_params(cfg, None, fs.device), sub_q,
                  packed_a.shape[2], w_chunk, int(static_trips),
                  int(with_ep), *_quirks(cfg))
    sweep_a5.launches += 1
    return out


sweep_a5.launches = 0


def sweep_b5(out_a, packed_b, trips, cfg: SimConfig, with_ep: bool = True,
             sub_q: int = 32, w_chunk: int = 128,
             static_trips: bool = False):
    """OUT_A (N,16) + packed slabs (B,16,kb) -> OUT_B (N,16). On a CUDA
    tensor this launches the v5 sweep-B kernel; on a CPU tensor it runs
    sweep_b5_plain."""
    _check_slab_inputs(out_a, packed_b, trips, sub_q, w_chunk)
    if out_a.device.type == "cpu":
        return sweep_b5_plain(out_a, packed_b, cfg, with_ep)
    out = _launch(cuda_lib.load().sph_sweep_b5, out_a, packed_b, trips,
                  kernel_params(cfg, None, out_a.device), sub_q,
                  packed_b.shape[2], w_chunk, int(static_trips),
                  int(with_ep))
    sweep_b5.launches += 1
    return out


sweep_b5.launches = 0


# --- the Laplacian-only sweep (frozen-cloud monodomain mode) ------------------

def sweep_lap3_plain(qm, feats, cfg: SimConfig) -> torch.Tensor:
    """Plain PyTorch Laplacian-only sweep: qm (N, 16) [x y z | vm | - ... |
    cx@12 cyz@13 | - -], feats (16, N) [x y z | vol | vm | - ... | cx@12
    cyz@13 | - -] -> (N, 16) with lap_i = sum_j vol_j W2(r_ij) vm_j -
    vm_i sum_j vol_j W2(r_ij) in column 0 and zeros elsewhere. The mask is
    the full per-axis cell test (W2's support is 2h, so the 27-cell
    truncation is part of the function) with the r^2 > 1e-12 pair guard;
    W2 is B_spline_2 in its relu form."""
    P = _Phys(kernel_params(cfg, None, qm.device))
    n = qm.shape[0]
    gm = float(_g_mid(cfg))
    a_vw, a_vwvm = [], []
    rows = _rows_per_chunk(n, qm.device)
    for s in range(0, n, rows):
        vw = lap_pair_weights(qm[s:s + rows], feats, gm, P)
        a_vw.append(vw.sum(1))
        a_vwvm.append((vw * feats[4][None, :]).sum(1))
    lap = torch.cat(a_vwvm) - torch.cat(a_vw) * qm[:, 3]
    return torch.cat([lap[:, None], qm.new_zeros((n, 15))], dim=1)


def lap_pair_weights(q, c, gm: float, P: _Phys) -> torch.Tensor:
    """(rows, N) Laplacian pair weights vol_j * W2(r_ij) of the query rows
    `q` against every candidate of `c` (layouts of sweep_lap3_plain), 0
    where the full cell mask or the r^2 > 1e-12 guard fails."""
    dx = q[:, 0:1] - c[0][None, :]
    dy = q[:, 1:2] - c[1][None, :]
    dz = q[:, 2:3] - c[2][None, :]
    r2 = dx * dx + dy * dy + dz * dz
    p = _stencil(q, c, gm, True) & (r2 > _PAIR_EPS)           # cpp:546
    inv_rr = torch.rsqrt(torch.where(p, r2, torch.ones_like(r2)))
    qr = (r2 * inv_rr) * P.inv_h
    w2 = P.bspline * (1.5 * torch.clamp(2.0 - qr, min=0.0)
                      - 6.0 * torch.clamp(1.0 - qr, min=0.0))
    return torch.where(p, c[3][None, :] * w2, torch.zeros_like(w2))


def sweep_lap3(qm, feats, blk_lo, blk_hi, cfg: SimConfig, sub_q: int = 128):
    """Laplacian-only sweep over the sub-blocks' three windows (see
    sweep_lap3_plain for the layouts) -> (N, 16), sorted order, the
    Laplacian in column 0. On a CUDA tensor this launches the Laplacian
    kernel; on a CPU tensor it runs sweep_lap3_plain."""
    _check_sweep_inputs(qm, feats, blk_lo, blk_hi, sub_q)
    if qm.device.type == "cpu":
        return sweep_lap3_plain(qm, feats, cfg)
    lib = cuda_lib.load()
    out = _launch(lib.sph_sweep_lap3, qm, feats, blk_lo, blk_hi,
                  kernel_params(cfg, None, qm.device), sub_q, _g_mid(cfg))
    sweep_lap3.launches += 1
    return out


sweep_lap3.launches = 0


# --- glue ---------------------------------------------------------------------

def _safe_div(num, den, ok):
    """num / den where `ok`, else 0, with no inf or NaN in either branch
    (so autograd through it stays finite)."""
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def feats_b(out_a):
    """(16, N) sweep-B candidate features of OUT_A, with the current
    volume mass / dens (0 where dens <= 0)."""
    return feats_from_out_a(out_a, vol_now(out_a))


def feats_from_out_a(out_a, vol):
    """(16, N) candidate features for sweep B from OUT_A columns."""
    z = torch.zeros_like(vol)
    return torch.stack([out_a[:, 0], out_a[:, 1], out_a[:, 2],
                        out_a[:, 3], out_a[:, 4], out_a[:, 5],
                        vol, out_a[:, 6], out_a[:, 7], z, z, z,
                        out_a[:, 12], out_a[:, 13], z, z], dim=0)


def build_qm_feats(state, f1, f2, order):
    """Sorted QM_A matrix + sweep-A candidate features. f1/f2: the stencil
    feature columns (cx, cyz) in ORIGINAL order. Returns (fs (N,16),
    feats_a (16,N)); requires state.corrected_vel to be current. The query
    matrix keeps the real mass (the FHN epilogue divides by it)."""
    n = state.pos.shape[0]
    fields = torch.cat([
        state.pos, state.corrected_vel, state.mass[:, None],
        state.dens[:, None], state.vm[:, None], state.stim[:, None],
        state.iion[:, None], state.w[:, None], f1[:, None], f2[:, None],
        torch.zeros((n, 2), dtype=state.pos.dtype, device=state.device)],
        dim=1)
    fs = fields[order]
    return fs, feats_a_from_fs(fs)


def feats_a_from_fs(fs):
    """(16, N) sweep-A candidate features from a QM_A matrix — the sweep-A
    inert-row rule: dead rows (cx sentinel) get mass = vol = 0, since the
    "yz" sweep-A mask does not test cx and every sweep-A term scales by one
    of the two."""
    z = torch.zeros_like(fs[:, 0])
    live = fs[:, 12] >= 0.0
    mass_c = torch.where(live, fs[:, 6], z)
    vol_prev = _safe_div(fs[:, 6], fs[:, 7], live & (fs[:, 7] > 0.0))
    return torch.stack([fs[:, 0], fs[:, 1], fs[:, 2], fs[:, 3], fs[:, 4],
                        fs[:, 5], vol_prev, mass_c, z, z, z, z,
                        fs[:, 12], fs[:, 13], z, z], dim=0)


def build_qm_feats5(state, cf, cm, cs, order):
    """Sorted QM_A (N,16) for the v5 step: the build_qm_feats layout with
    the three per-axis cell coordinates (ORIGINAL order in, from
    sweeps.sweep_bookkeeping5) at columns 12-14."""
    n = state.pos.shape[0]
    fields = torch.cat([
        state.pos, state.corrected_vel, state.mass[:, None],
        state.dens[:, None], state.vm[:, None], state.stim[:, None],
        state.iion[:, None], state.w[:, None], cf[:, None], cm[:, None],
        cs[:, None], torch.zeros((n, 1), dtype=state.pos.dtype,
                                 device=state.device)], dim=1)
    return fields[order]


def _pack_candidates(cols, src, kb: int) -> torch.Tensor:
    """Row-gather 16 candidate feature columns (N,) each, SORTED order,
    into per-sub-block slabs (B, 16, kb): slot k of block b holds row
    src[b*kb + k]. The sentinel src = N selects a zero row with a sentinel
    cf (row 12), which fails every live query's mask and carries zero
    volume and mass."""
    feats = torch.stack(cols, dim=0)                          # (16, N)
    pad = torch.zeros((16, 1), dtype=feats.dtype, device=feats.device)
    pad[12] = _COORD_SENTINEL
    feats = torch.cat([feats, pad], dim=1)
    b = src.shape[0] // kb
    return feats[:, src].reshape(16, b, kb).transpose(0, 1).contiguous()


def pack_feats_a5(fs, src, kb: int) -> torch.Tensor:
    """Sweep-A candidate slabs from the sorted v5 QM_A matrix: [pos3 |
    cvel3 | vol_prev | mass | - - - - | cf cm cs | -]. No inert-row rule
    here: the v5 mask tests cf, and dead rows never enter a slab."""
    vol_prev = _safe_div(fs[:, 6], fs[:, 7], fs[:, 7] > 0.0)
    z = torch.zeros_like(vol_prev)
    return _pack_candidates(
        [fs[:, 0], fs[:, 1], fs[:, 2], fs[:, 3], fs[:, 4], fs[:, 5],
         vol_prev, fs[:, 6], z, z, z, z, fs[:, 12], fs[:, 13], fs[:, 14], z],
        src, kb)


def pack_feats_b5(out_a, vol_now, src, kb: int) -> torch.Tensor:
    """Sweep-B candidate slabs from OUT_A: [pos3 | ivel3 | vol | pres | vm
    | - - - | cf cm cs | -]."""
    z = torch.zeros_like(vol_now)
    return _pack_candidates(
        [out_a[:, 0], out_a[:, 1], out_a[:, 2], out_a[:, 3], out_a[:, 4],
         out_a[:, 5], vol_now, out_a[:, 6], out_a[:, 7], z, z, z,
         out_a[:, 12], out_a[:, 13], out_a[:, 14], z], src, kb)


def vol_now(out_a) -> torch.Tensor:
    """Current volume mass / dens of OUT_A rows (0 where dens <= 0)."""
    return _safe_div(out_a[:, 10], out_a[:, 8], out_a[:, 8] > 0.0)


def apply_out_fused(state, out_a, out_b, inv=None):
    """Unsort OUT_A/OUT_B (inv=None skips the unsort) and write the step's
    results back: pos/vel only where active & ~fixed, vm only where active,
    dens/pres/iion/w/inter_vm/acc/inter_vel unconditionally."""
    ou = torch.cat([out_b, out_a[:, 3:6]], dim=1)
    if inv is not None:
        ou = ou[inv]
    act = state.active
    upd = act & ~state.fixed
    return state.replace(
        pos=torch.where(upd[:, None], ou[:, 0:3], state.pos),
        vel=torch.where(upd[:, None], ou[:, 3:6], state.vel),
        vm=torch.where(act, ou[:, 6], state.vm),
        dens=ou[:, 7], pres=ou[:, 8], iion=ou[:, 9], w=ou[:, 10],
        inter_vm=ou[:, 11], acc=ou[:, 12:15], inter_vel=ou[:, 16:19])


"""v4 fused coupled step: two neighbor sweeps with fused pointwise epilogues
(mirror of `sph_sm_monodomain_tpu.ops.fused_step` for `stencil="xyz3"`).

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
version in this module (`sweep_a3_plain` / `sweep_b3_plain` /
`sweep_lap3_plain`), which the tests hold to the JAX package and
chip_smoke.py holds the kernels to.
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
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from . import cuda_lib
from .constants import const_tensor
from .sweeps import _PAIR_EPS, hash_axis_perm

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


def _stencil(q, c, gm: float, full: bool) -> torch.Tensor:
    """Exact v4 cell stencil between query rows `q` (rows, 16) and all
    candidates `c` (16, N): the cyz test of any of the three slow-plane
    windows, the cx test when `full`, both rows live. A pair passes under
    at most one window (G_mid >= 3), so 'any' counts it once."""
    qcyz, ccyz = q[:, 13:14], c[13][None, :]
    m = ((qcyz - gm - ccyz).abs() <= 1.0) | ((qcyz - ccyz).abs() <= 1.0) \
        | ((qcyz + gm - ccyz).abs() <= 1.0)
    if full:
        m &= (q[:, 12:13] - c[12][None, :]).abs() <= 1.0
    return m & (q[:, 12:13] >= 0.0) & (c[12] >= 0.0)[None, :]


def _g_mid(cfg: SimConfig) -> int:
    return cfg.grid_size[hash_axis_perm(cfg)[1]]


def _mask_a_full(cfg: SimConfig) -> bool:
    """Sweep A's mask: the cyz half alone when Poly6's support (h) is within
    one cell (cells >= 2 apart are > h apart, so the weight itself is 0);
    the full 27-cell mask on a finer grid."""
    return cfg.cell_size < cfg.kernel_h


def _pair_sums_a(fs, feats, cfg: SimConfig, P: _Phys):
    """(a_d, a_x, a_y, a_z) (N, 1) each: Poly6 density and XSPH sums in the
    reference's per-pair difference form (cpp:483, 688-695)."""
    n = fs.shape[0]
    gm, full = float(_g_mid(cfg)), _mask_a_full(cfg)
    c = feats
    sums = []
    rows = _rows_per_chunk(n, fs.device)
    for s in range(0, n, rows):
        q = fs[s:s + rows]
        dx = q[:, 0:1] - c[0][None, :]
        dy = q[:, 1:2] - c[1][None, :]
        dz = q[:, 2:3] - c[2][None, :]
        r2 = dx * dx + dy * dy + dz * dz
        t = torch.clamp(P.h2 - r2, min=0.0)
        w6 = torch.where(_stencil(q, c, gm, full), P.poly6 * t * t * t,
                         torch.zeros_like(t))
        wv = w6 * c[6][None, :]                          # * vol_prev_j
        sums.append(torch.stack([
            (w6 * c[7][None, :]).sum(1),
            (wv * (c[3][None, :] - q[:, 3:4])).sum(1),
            (wv * (c[4][None, :] - q[:, 4:5])).sum(1),
            (wv * (c[5][None, :] - q[:, 5:6])).sum(1)], dim=1))
    return torch.cat(sums).unbind(1)


def _pair_sums_b(qm, feats, cfg: SimConfig, with_ep: bool, P: _Phys):
    """(a_ax, a_ay, a_az, a_lap): Spiky pressure + viscosity and the
    B-spline-2 Vm Laplacian (cpp:546-563), full 27-cell mask, r^2 > 1e-12
    pair guard."""
    n = qm.shape[0]
    gm = float(_g_mid(cfg))
    c = feats
    sums = []
    rows = _rows_per_chunk(n, qm.device)
    for s in range(0, n, rows):
        q = qm[s:s + rows]
        dx = q[:, 0:1] - c[0][None, :]
        dy = q[:, 1:2] - c[1][None, :]
        dz = q[:, 2:3] - c[2][None, :]
        r2 = dx * dx + dy * dy + dz * dz
        p = _stencil(q, c, gm, True) & (r2 > _PAIR_EPS)
        inv_rr = torch.rsqrt(torch.where(p, r2, torch.ones_like(r2)))
        rr = r2 * inv_rr
        volm = torch.where(p, c[6][None, :], torch.zeros_like(r2))
        hr = torch.clamp(P.kernel_h - rr, min=0.0)
        common = volm * (P.spiky * hr)
        f_p = common * (hr * (-0.5) * inv_rr) * (q[:, 6:7] + c[7][None, :])
        f_v = P.mu_viscosity * common
        cols = [(f_v * (c[3 + k][None, :] - q[:, 3 + k:4 + k])
                 - f_p * d).sum(1) for k, d in enumerate((dx, dy, dz))]
        if with_ep:
            qr = rr * P.inv_h
            w2 = P.bspline * (1.5 * torch.clamp(2.0 - qr, min=0.0)
                              - 6.0 * torch.clamp(1.0 - qr, min=0.0))
            cols.append(((volm * w2) * (c[8][None, :] - q[:, 7:8])).sum(1))
        else:
            cols.append(torch.zeros_like(cols[0]))
        sums.append(torch.stack(cols, dim=1))
    return torch.cat(sums).unbind(1)


def sweep_a3_plain(fs, feats_a, cfg: SimConfig, with_ep: bool = True,
                   dynp=None) -> torch.Tensor:
    """Plain PyTorch sweep A: QM_A (N,16) + sweep-A features (16,N) ->
    OUT_A (N,16). Dense over all candidates (no window bounds); dead query
    rows (cx sentinel) get zero sums."""
    P = _Phys(kernel_params(cfg, dynp, fs.device))
    a_d, a_x, a_y, a_z = _pair_sums_a(fs, feats_a, cfg, P)
    return _epi_a(cfg, a_d, torch.stack([a_x, a_y, a_z], dim=1), fs, dynp,
                  with_ep)


def sweep_b3_plain(out_a, feats_b, cfg: SimConfig, with_ep: bool = True,
                   dynp=None) -> torch.Tensor:
    """Plain PyTorch sweep B: OUT_A (N,16) + sweep-B features (16,N) ->
    OUT_B (N,16)."""
    P = _Phys(kernel_params(cfg, dynp, out_a.device))
    a_ax, a_ay, a_az, a_lap = _pair_sums_b(out_a, feats_b, cfg, with_ep, P)
    return _epi_b(cfg, torch.stack([a_ax, a_ay, a_az], dim=1), a_lap, out_a,
                  dynp, with_ep)


# --- wrappers ----------------------------------------------------------------

def _check_sweep_inputs(qm, feats, blk_lo, blk_hi, sub_q: int) -> None:
    n = qm.shape[0]
    if qm.dim() != 2 or qm.shape[1] != 16:
        raise ValueError(f"query matrix must be (N, 16), got {tuple(qm.shape)}")
    if n == 0 or n % sub_q or sub_q % 32 or not 32 <= sub_q <= 1024:
        raise ValueError(f"{n} query rows must be a positive multiple of "
                         f"sub_q={sub_q} (a multiple of 32 in [32, 1024])")
    if tuple(feats.shape) != (16, n):
        raise ValueError(f"features must be (16, {n}), got "
                         f"{tuple(feats.shape)}")
    want = (n // sub_q) * 4
    for name, t in (("blk_lo", blk_lo), ("blk_hi", blk_hi)):
        if tuple(t.shape) != (want,):
            raise ValueError(f"{name} must be ({want},), got "
                             f"{tuple(t.shape)}")
    if qm.device.type != "cpu":
        for name, t, dt in (("qm", qm, torch.float32),
                            ("feats", feats, torch.float32),
                            ("blk_lo", blk_lo, torch.int32),
                            ("blk_hi", blk_hi, torch.int32)):
            if t.device != qm.device or t.dtype != dt \
                    or not t.is_contiguous():
                raise ValueError(f"{name} must be a contiguous {dt} tensor "
                                 f"on {qm.device}, got {t.dtype} on "
                                 f"{t.device}")


def _launch(fn, qm, feats, blk_lo, blk_hi, prm, *ints) -> torch.Tensor:
    if qm.device.type != "cuda":
        raise ValueError(f"no sweep kernel for device {qm.device}")
    out = torch.empty_like(qm)
    with torch.cuda.device(qm.device):
        stream = torch.cuda.current_stream(qm.device).cuda_stream
        rc = fn(qm.data_ptr(), feats.data_ptr(), blk_lo.data_ptr(),
                blk_hi.data_ptr(), prm.data_ptr(), out.data_ptr(),
                qm.shape[0], *ints, stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {rc} "
                           f"({cuda_lib.error_string(rc)})")
    return out


def sweep_a3(fs, feats_a, blk_lo, blk_hi, cfg: SimConfig,
             with_ep: bool = True, sub_q: int = 128, dynp=None):
    """QM_A (N,16) + sweep-A features (16,N) -> OUT_A (N,16), sorted order,
    over the three merged windows per sub-block of `sub_q` rows
    (blk_lo/blk_hi from sweeps.sweep_bookkeeping3). `dynp`: optional
    (1, 16) dynamic physics constants (build_dynp). On a CUDA tensor this
    launches the sweep-A kernel; on a CPU tensor it runs sweep_a3_plain."""
    _check_sweep_inputs(fs, feats_a, blk_lo, blk_hi, sub_q)
    if fs.device.type == "cpu":
        return sweep_a3_plain(fs, feats_a, cfg, with_ep, dynp)
    lib = cuda_lib.load()
    out = _launch(lib.sph_sweep_a3, fs, feats_a, blk_lo, blk_hi,
                  kernel_params(cfg, dynp, fs.device), sub_q, int(with_ep),
                  int(_mask_a_full(cfg)), _g_mid(cfg),
                  int(cfg.quirk_double_self_density),
                  int(cfg.quirk_pressure_stim_gate),
                  int(cfg.quirk_iion_accumulate))
    sweep_a3.launches += 1
    return out


sweep_a3.launches = 0


def sweep_b3(out_a, feats_b, blk_lo, blk_hi, cfg: SimConfig,
             with_ep: bool = True, sub_q: int = 128, dynp=None):
    """OUT_A (N,16) + sweep-B features (16,N) -> OUT_B (N,16), sorted order.
    On a CUDA tensor this launches the sweep-B kernel; on a CPU tensor it
    runs sweep_b3_plain."""
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
    return feats_from_out_a(out_a, _safe_div(out_a[:, 10], out_a[:, 8],
                                             out_a[:, 8] > 0.0))


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


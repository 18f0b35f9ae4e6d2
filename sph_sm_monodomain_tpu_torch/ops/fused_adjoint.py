"""Differentiable v4 coupled step: the production fused sweeps forward,
hand-written backward sweeps (mirror of
`sph_sm_monodomain_tpu.ops.fused_adjoint`, `:94-488`).

The sweep kernels are opaque to autograd, so each sweep is a
`torch.autograd.Function` whose backward does three things:

1.  It recovers the pair sums from the sweep's own output (every epilogue
    is invertible on the saved inputs: ivel = cv + mixing*xsph, dens = raw
    + self-term, acc = raw/dens, inter_vm = (1+s)*lap - react).
2.  It takes the pointwise epilogue's VJP with `torch.autograd.grad` over
    `_epi_a` / `_epi_b`, the same epilogue functions the plain versions
    run and the kernels mirror: no pointwise calculus derived by hand.
3.  It runs ONE backward sweep over the same sorted windows for the pair
    sums' VJP. The stencil and the r^2 > eps self-exclusion are symmetric,
    so particle p's cotangent has two contributions, p as query i (terms
    weighted by p's own output cotangent) and p as candidate j (terms
    weighted by its neighbours' cotangents), and both are sums over the
    same neighbour set: the backward sweep gathers [neighbour state |
    neighbour cotangents] as candidate features and accumulates both roles
    in one pass. The chain terms of the features built from the state
    (vol = mass / dens) are applied outside the sweep.

Derivatives (pair forms; C = poly6_constant, S = spiky_constant,
t = max(h^2 - r^2, 0), w6 = C t^3, hr = max(h - r, 0), w2 = B_spline_2(r/h)):

sweep A   dens_i = sum_j w6 m_j ;  X_i = sum_j w6 vol_j (v_j - v_i)
  with s_ij = gd_i m_j + vol_j (gx_i . (v_j - v_i)) and D = pos_i - pos_j:
  d pos_p = -6C sum_q t^2 (s_pq + s_qp) D_pq
  d v_p   = -gx_p sum_q w6 vol_q + vol_p sum_q w6 gx_q
  d m_p   = sum_q w6 gd_q          (self-pair included, as in the forward)
  d vol_p = sum_q w6 (gx_q . (v_p - v_q))

sweep B   acc_i = sum_j [mu S vol_j hr (u_j - u_i)
                         + (S/2) vol_j hr^2/r (P_i + P_j) D]
          lap_i = sum_j vol_j w2 (vm_j - vm_i)
  d P_p   = (S/2) sum_q hr^2/r [vol_q (ga_p . D) - vol_p (ga_q . D)]
  d u_p   = mu S sum_q hr [vol_p ga_q - vol_q ga_p]
  d vm_p  = sum_q w2 [vol_p gl_q - vol_q gl_p]
  d vol_p = sum_q l_qp / vol_p     (every forward term is linear in vol_j)
  d pos_p = sum_q (G_pq - G_qp)    (G = per-pair d/d pos_i)
  d mu    = sum_pairs S vol_j hr (ga_i . (u_j - u_i))

mu is the only pair-side physics constant. Every other dynamic constant
(config.PARAM_FIELDS) enters an epilogue, so its cotangent comes out of
step 2, which is what makes gradients w.r.t. (K, mu, sigma, FHN constants,
...) flow through this path. Gradients are defined w.r.t. the continuous
pair math; the sort and the windows are per-step geometry bookkeeping.

On a CUDA tensor each backward sweep is one hand-written kernel
(csrc/fused_adjoint.cu: `sweep_bwd_a`, `sweep_bwd_b`); on a CPU tensor the
wrapper runs its plain PyTorch version in this module.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from . import cuda_lib
from .fused_step import (_DYN_SLOTS, _Phys, _check_sweep_inputs, _epi_a,
                         _epi_b, _g_mid, _launch, _rows_per_chunk,
                         _safe_div, _stencil, feats_a_from_fs, feats_b,
                         kernel_params, sweep_a3, sweep_b3)
from .sweeps import _PAIR_EPS

_MIX = _DYN_SLOTS.index("velocity_mixing")
_MU = _DYN_SLOTS.index("mu_viscosity")
_VM_SCALE = _DYN_SLOTS.index("vm_scale")


# --- plain versions: dense masked pair sums over every candidate -----------

def sweep_bwd_a_plain(qm, feats, cfg: SimConfig) -> torch.Tensor:
    """Plain PyTorch VJP of sweep A's pair sums (`_kernel_bwd_a`).
    qm (N, 16): [pos3 | v3 | vol | mass | gd | gx3 | cx | cyz | - -] with
    gd / gx3 the cotangents of the density / XSPH sums; feats = qm.T.
    Returns (N, 16): [d_pos3 | d_v3 | d_vol | d_mass | 0 x 8]. Full
    per-axis stencil, both rows live."""
    P = _Phys(kernel_params(cfg, None, qm.device))
    n = qm.shape[0]
    gm = float(_g_mid(cfg))
    c = feats
    outs = []
    rows = _rows_per_chunk(n, qm.device)
    for s in range(0, n, rows):
        q = qm[s:s + rows]
        d = [q[:, k:k + 1] - c[k][None, :] for k in range(3)]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        tm = torch.where(_stencil(q, c, gm, True),
                         torch.clamp(P.h2 - r2, min=0.0),
                         torch.zeros_like(r2))
        t2 = tm * tm
        w6 = P.poly6 * (t2 * tm)
        dv = [c[3 + k][None, :] - q[:, 3 + k:4 + k] for k in range(3)]
        qvol, qgx = q[:, 6:7], [q[:, 9 + k:10 + k] for k in range(3)]
        volq, gdq = c[6][None, :], c[8][None, :]
        gxq = [c[9 + k][None, :] for k in range(3)]
        s_pq = q[:, 8:9] * c[7][None, :] + volq * (
            qgx[0] * dv[0] + qgx[1] * dv[1] + qgx[2] * dv[2])
        xq = -(gxq[0] * dv[0] + gxq[1] * dv[1] + gxq[2] * dv[2])
        s_qp = gdq * q[:, 7:8] + qvol * xq
        tt = t2 * (s_pq + s_qp)
        s_b = (w6 * volq).sum(1, keepdim=True)
        cols = [(-6.0 * P.poly6) * (tt * d[k]).sum(1, keepdim=True)
                for k in range(3)]
        cols += [qvol * (w6 * gxq[k]).sum(1, keepdim=True) - qgx[k] * s_b
                 for k in range(3)]
        cols += [(w6 * xq).sum(1, keepdim=True),
                 (w6 * gdq).sum(1, keepdim=True),
                 q.new_zeros((q.shape[0], 8))]
        outs.append(torch.cat(cols, dim=1))
    return torch.cat(outs)


def sweep_bwd_b_plain(qm, feats, cfg: SimConfig, dynp=None) -> torch.Tensor:
    """Plain PyTorch VJP of sweep B's pair sums (`_kernel_bwd_b`).
    qm (N, 16): [pos3 | u3 | vol | P | vm | ga3 | cx | cyz | gl | -] with
    ga3 / gl the cotangents of the acceleration / Laplacian sums;
    feats = qm.T. Returns (N, 16): [d_pos3 | d_u3 | d_P | d_vm | d_vol |
    d_mu partial | 0 x 6]. Full per-axis stencil, r^2 > 1e-12 guard."""
    P = _Phys(kernel_params(cfg, dynp, qm.device))
    n = qm.shape[0]
    gm = float(_g_mid(cfg))
    musp, hspk = P.mu_viscosity * P.spiky, 0.5 * P.spiky
    bsd = P.bspline * P.inv_h
    c = feats
    outs = []
    rows = _rows_per_chunk(n, qm.device)
    for s in range(0, n, rows):
        q = qm[s:s + rows]
        d = [q[:, k:k + 1] - c[k][None, :] for k in range(3)]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        p = _stencil(q, c, gm, True) & (r2 > _PAIR_EPS)       # cpp:546
        zero = torch.zeros_like(r2)
        inv_r = torch.where(p, torch.rsqrt(torch.where(p, r2,
                                                       torch.ones_like(r2))),
                            zero)
        rr = r2 * inv_r
        hrm = torch.where(p, torch.clamp(P.kernel_h - rr, min=0.0), zero)
        qr = rr * P.inv_h
        w2m = torch.where(p, P.bspline * (
            1.5 * torch.clamp(2.0 - qr, min=0.0)
            - 6.0 * torch.clamp(1.0 - qr, min=0.0)), zero)
        # w2' on its active pieces (subgradient 0 at the kinks)
        w2pm = torch.where(p, bsd * (6.0 * (qr < 1.0).to(r2.dtype)
                                     - 1.5 * (qr < 2.0).to(r2.dtype)), zero)
        qvol, qP, qvm, qgl = q[:, 6:7], q[:, 7:8], q[:, 8:9], q[:, 14:15]
        qga = [q[:, 9 + k:10 + k] for k in range(3)]
        volq, Pq, vmq, glq = (c[6][None, :], c[7][None, :], c[8][None, :],
                              c[14][None, :])
        gaq = [c[9 + k][None, :] for k in range(3)]
        du = [c[3 + k][None, :] - q[:, 3 + k:4 + k] for k in range(3)]
        dot = lambda a, b: a[0] * b[0] + a[1] * b[1] + a[2] * b[2]  # noqa: E731
        gaP_d, gaQ_d = dot(qga, d), dot(gaq, d)
        gaP_du, gaQ_du = dot(qga, du), dot(gaq, du)
        psum = qP + Pq
        hr2ir = hrm * hrm * inv_r
        a_p = hr2ir * (volq * gaP_d - qvol * gaQ_d)
        a_u = [hrm * (qvol * gaq[k] - volq * qga[k]) for k in range(3)]
        a_vm = w2m * (qvol * glq - volq * qgl)
        a_vol = musp * hrm * (-gaQ_du) - hspk * hr2ir * psum * gaQ_d \
            + w2m * glq * (qvm - vmq)
        a_mu = P.spiky * volq * hrm * gaP_du
        # d_pos, both roles; the viscosity term gates on Spiky's support
        visc = torch.where(hrm > 0.0, musp * inv_r, zero) \
            * (qvol * gaQ_du - volq * gaP_du)
        cpre = hspk * psum
        radial = cpre * (2.0 * hrm + hr2ir) * inv_r * inv_r \
            * (volq * gaP_d - qvol * gaQ_d)
        lapr = w2pm * inv_r * (volq * qgl * (vmq - qvm)
                               + qvol * glq * (qvm - vmq))
        scal = visc - radial + lapr
        iso = cpre * hr2ir
        red = lambda a: a.sum(1, keepdim=True)  # noqa: E731
        cols = [red(scal * d[k] + iso * (volq * qga[k] - qvol * gaq[k]))
                for k in range(3)]
        cols += [musp * red(a_u[k]) for k in range(3)]
        cols += [hspk * red(a_p), red(a_vm), red(a_vol), red(a_mu),
                 q.new_zeros((q.shape[0], 6))]
        outs.append(torch.cat(cols, dim=1))
    return torch.cat(outs)


# --- wrappers ----------------------------------------------------------------

def sweep_bwd_a(qm, feats, blk_lo, blk_hi, cfg: SimConfig, sub_q: int = 128):
    """VJP of sweep A's pair sums over the sub-blocks' three windows (see
    sweep_bwd_a_plain for the layouts). On a CUDA tensor this launches the
    backward sweep-A kernel; on a CPU tensor it runs sweep_bwd_a_plain."""
    _check_sweep_inputs(qm, feats, blk_lo, blk_hi, sub_q)
    if qm.device.type == "cpu":
        return sweep_bwd_a_plain(qm, feats, cfg)
    lib = cuda_lib.load()
    out = _launch(lib.sph_sweep_bwd_a, qm, feats, blk_lo, blk_hi,
                  kernel_params(cfg, None, qm.device), sub_q, _g_mid(cfg))
    sweep_bwd_a.launches += 1
    return out


sweep_bwd_a.launches = 0


def sweep_bwd_b(qm, feats, blk_lo, blk_hi, cfg: SimConfig, sub_q: int = 128,
                dynp=None):
    """VJP of sweep B's pair sums (see sweep_bwd_b_plain for the layouts);
    `dynp` supplies mu. On a CUDA tensor this launches the backward sweep-B
    kernel; on a CPU tensor it runs sweep_bwd_b_plain."""
    _check_sweep_inputs(qm, feats, blk_lo, blk_hi, sub_q)
    if qm.device.type == "cpu":
        return sweep_bwd_b_plain(qm, feats, cfg, dynp)
    lib = cuda_lib.load()
    out = _launch(lib.sph_sweep_bwd_b, qm, feats, blk_lo, blk_hi,
                  kernel_params(cfg, dynp, qm.device), sub_q, _g_mid(cfg))
    sweep_bwd_b.launches += 1
    return out


sweep_bwd_b.launches = 0


# --- backward-sweep inputs ------------------------------------------------------

def bwd_a_query(fs, g_rd, g_rx) -> torch.Tensor:
    """(N, 16) query matrix of the backward sweep A: QM_A's positions and
    velocities, sweep A's candidate volume and mass (feats_a_from_fs), the
    cotangents of the density (g_rd (N,)) and XSPH (g_rx (N, 3)) sums, and
    the cell features."""
    fa = feats_a_from_fs(fs)
    return torch.cat([fs[:, 0:6], fa[6:8].T, g_rd[:, None], g_rx,
                      fs[:, 12:14], fs.new_zeros((fs.shape[0], 2))], dim=1)


def bwd_b_query(out_a, g_ra, g_rl) -> torch.Tensor:
    """(N, 16) query matrix of the backward sweep B: OUT_A's positions,
    velocities, volume (sweep B's candidate feature), pressure and Vm, the
    cotangents of the acceleration (g_ra (N, 3)) and Laplacian (g_rl (N,))
    sums, and the cell features."""
    vol = feats_b(out_a)[6]
    return torch.cat([out_a[:, 0:6], vol[:, None], out_a[:, 6:8], g_ra,
                      out_a[:, 12:14], g_rl[:, None],
                      out_a.new_zeros((out_a.shape[0], 1))], dim=1)


# --- autograd functions --------------------------------------------------------

def _epilogue_vjp(epi, g, *inputs):
    """Cotangents of `inputs` from autograd over the epilogue `epi`."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_() for x in inputs]
        grads = torch.autograd.grad(epi(*xs), xs, g, allow_unused=True)
    return [torch.zeros_like(x) if gx is None else gx
            for x, gx in zip(xs, grads)]


class SweepA3Fn(torch.autograd.Function):
    """Sweep A (QM_A -> OUT_A) with its hand-written VJP. Inputs (fs, dynp,
    blk_lo, blk_hi, cfg, sub_q); `fs` and `dynp` receive cotangents."""

    @staticmethod
    def forward(ctx, fs, dynp, blk_lo, blk_hi, cfg, sub_q):
        out = sweep_a3(fs, feats_a_from_fs(fs), blk_lo, blk_hi, cfg,
                       sub_q=sub_q, dynp=dynp)
        ctx.save_for_backward(fs, dynp, blk_lo, blk_hi, out)
        ctx.cfg, ctx.sub_q = cfg, sub_q
        return out

    @staticmethod
    def backward(ctx, g):
        fs, dynp, blk_lo, blk_hi, out = ctx.saved_tensors
        cfg = ctx.cfg
        # 1. the pair sums the epilogue consumed (fused_adjoint.py:380-388)
        mix = dynp[0, _MIX]
        raw_x = _safe_div(out[:, 3:6] - fs[:, 3:6], mix, mix != 0.0)
        raw_d = out[:, 8]
        if cfg.quirk_double_self_density:                    # cpp:483
            P = _Phys(kernel_params(cfg, dynp, fs.device))
            raw_d = raw_d - fs[:, 6] * (P.poly6 * P.h2 * P.h2 * P.h2)
        # 2. the epilogue's VJP
        g_rd, g_rx, d_fs, d_dynp = _epilogue_vjp(
            lambda rd, rx, f, dp: _epi_a(cfg, rd, rx, f, dp), g,
            raw_d, raw_x, fs, dynp)
        # 3. the pair sums' VJP: one backward sweep, both roles per pass
        qm = bwd_a_query(fs, g_rd, g_rx)
        kout = sweep_bwd_a(qm, qm.T.contiguous(), blk_lo, blk_hi, cfg,
                           ctx.sub_q)
        # vol_prev = mass / dens_prev chain (live rows only)
        live = fs[:, 12] >= 0.0
        ok = live & (fs[:, 7] > 0.0)
        inv_dp = _safe_div(torch.ones_like(fs[:, 7]), fs[:, 7], ok)
        d_vol = kout[:, 6]
        d_fs = d_fs + torch.cat([
            kout[:, 0:6],
            (torch.where(live, kout[:, 7], torch.zeros_like(d_vol))
             + d_vol * inv_dp)[:, None],
            (-d_vol * qm[:, 6] * inv_dp)[:, None],
            torch.zeros_like(kout[:, 8:16])], dim=1)
        return d_fs, d_dynp, None, None, None, None


class SweepB3Fn(torch.autograd.Function):
    """Sweep B (OUT_A -> OUT_B) with its hand-written VJP. Inputs (out_a,
    dynp, blk_lo, blk_hi, cfg, sub_q); `out_a` and `dynp` receive
    cotangents, mu's pair-side part summed over the rows by torch.sum."""

    @staticmethod
    def forward(ctx, out_a, dynp, blk_lo, blk_hi, cfg, sub_q):
        out = sweep_b3(out_a, feats_b(out_a), blk_lo, blk_hi, cfg,
                       sub_q=sub_q, dynp=dynp)
        ctx.save_for_backward(out_a, dynp, blk_lo, blk_hi, out)
        ctx.cfg, ctx.sub_q = cfg, sub_q
        return out

    @staticmethod
    def backward(ctx, g):
        out_a, dynp, blk_lo, blk_hi, out = ctx.saved_tensors
        cfg = ctx.cfg
        # 1. the pair sums: acc = raw / dens_g; inter_vm = (1+s) lap - react
        densg = torch.where(out_a[:, 8:9] > 0.0, out_a[:, 8:9],
                            torch.ones_like(out_a[:, 8:9]))
        raw_acc = out[:, 12:15] * densg
        raw_lap = (out[:, 11] + out_a[:, 9]) / (1.0 + dynp[0, _VM_SCALE])
        # 2. the epilogue's VJP
        g_ra, g_rl, d_oa, d_dynp = _epilogue_vjp(
            lambda ra, rl, oa, dp: _epi_b(cfg, ra, rl, oa, dp), g,
            raw_acc, raw_lap, out_a, dynp)
        # 3. the pair sums' VJP
        qm = bwd_b_query(out_a, g_ra, g_rl)
        kout = sweep_bwd_b(qm, qm.T.contiguous(), blk_lo, blk_hi, cfg,
                           ctx.sub_q, dynp)
        # vol = mass / dens chain (live rows only)
        ok = (out_a[:, 12] >= 0.0) & (out_a[:, 8] > 0.0)
        inv_d = _safe_div(torch.ones_like(out_a[:, 8]), out_a[:, 8], ok)
        d_vol = kout[:, 8] * inv_d
        z = torch.zeros_like(d_vol)[:, None]
        d_oa = d_oa + torch.cat([
            kout[:, 0:8],                                    # pos, u, P, vm
            (-d_vol * qm[:, 6])[:, None], z,                 # dens, react
            d_vol[:, None], torch.zeros_like(kout[:, 11:16])], dim=1)
        mu_hot = torch.zeros_like(d_dynp)
        mu_hot[0, _MU] = kout[:, 9].sum()
        return d_oa, d_dynp + mu_hot, None, None, None, None


# --- entry point ----------------------------------------------------------------

def make_diff_sweeps(cfg: SimConfig, sub_q: int = 128):
    """(sweep_a, sweep_b): the differentiable v4 sweeps for `cfg`. Each takes
    (qm, dynp, blk_lo, blk_hi) and returns the production kernel's (N, 16)
    output; `qm` and the (1, 16) `dynp` (build_dynp) receive cotangents.
    The counterpart of the JAX package's make_diff_sweeps, without its TPU
    tiling arguments; models.monodomain.step_fused_diff runs the step with
    them."""
    return (lambda fs, dynp, blk_lo, blk_hi:
            SweepA3Fn.apply(fs, dynp, blk_lo, blk_hi, cfg, sub_q),
            lambda out_a, dynp, blk_lo, blk_hi:
            SweepB3Fn.apply(out_a, dynp, blk_lo, blk_hi, cfg, sub_q))


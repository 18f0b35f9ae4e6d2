"""Plain PyTorch reference of the coupled SPH + shape-matching + monodomain
step, of the frozen-cloud monodomain wave, and of the material fit's loss.

Written from the reference application's equations (Hagen23/SPH-SM-Monodomain,
SPH_SM_monodomain.cpp: external forces 215-232, shape matching 234-446,
XSPH 669-701, density and pressure 448-513, FHN 575-593, forces and the Vm
Laplacian 515-573, integration and walls 596-651, turnOffStim 764-783), as
the float64 oracle of the repository's tests is, and sharing no code with
the package under test: explicit pair lists from a cell list instead of
sorted windows, index sums instead of kernels, a Newton iteration instead
of Jacobi sweeps for the polar factor. Each run is a dict of tensors over
the live particles only, in the dtype the caller picks (float64 for the
check; float32 with `rnd=tf32` for the lower-precision control).

The pair set is the reference's 27-cell stencil (cell edge = cell_size),
which truncates the B-spline's 2h support at one cell, as the reference
engine does.

`rnd` rounds both operands of every product that a pair sum or a moment
sums (the multiply-accumulates a matrix product would do): the identity
for the check, `tf32` for the control.
"""

from __future__ import annotations

import math

import torch

_PAIR_EPS = 1e-12
FIELDS = ("pos", "vel", "goal", "dens", "vm", "w", "iion")


def ident(x: torch.Tensor) -> torch.Tensor:
    return x


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to the nearest TF32 value (10 mantissa bits, ties
    to even): the input rounding of a TF32 matrix product. The gradient
    passes through unrounded."""
    if x.dtype != torch.float32:
        raise TypeError("tf32 rounds float32 tensors")
    i = x.detach().contiguous().view(torch.int32)
    r = ((i + 0xFFF + ((i >> 13) & 1)) & -8192).view(torch.float32)
    return x + (r - x.detach())


class Physics:
    """The model constants of a configuration file's "physics" object, and
    the ones the reference derives from them (cpp:17-57, h:72-94)."""

    def __init__(self, d: dict):
        self.__dict__.update(d)
        fixed = {"quadratic_match": False, "volume_conservation": True,
                 "allow_flip": False, "quirk_double_self_density": True,
                 "quirk_pressure_stim_gate": True,
                 "quirk_iion_accumulate": True}
        bad = {k: d.get(k) for k, v in fixed.items() if d.get(k) != v}
        if bad:
            raise ValueError(f"the reference computes {fixed}; got {bad}")
        vmax = math.sqrt(sum(v * v for v in self.max_vel))
        h = self.kernel_h
        self.dt = self.dt_cfl_factor * h / vmax
        self.poly6 = 315.0 / (64.0 * math.pi * h ** 9)
        self.spiky = 45.0 / (math.pi * h ** 6)
        self.bspline = 1.0 / (math.pi * h ** 3)
        sigma = self.sigma_i * self.sigma_e / (self.sigma_i + self.sigma_e)
        self.vm_scale = sigma / (self.beta_sv_ratio * self.cm_capacitance)
        self.dims = tuple(int(math.ceil(w / self.cell_size - 1e-9))
                          for w in self.world_size)


# --- the scene ---------------------------------------------------------------

def anchors(pos32: torch.Tensor, tile_w: float | None) -> torch.Tensor:
    """turnOnStim_Mesh's tendon anchors (cpp:745-762) on float32 positions:
    x in [0, 0.07], or x >= 0.90 and y >= 0.80, with x taken within its
    tile on a tiled cloud."""
    x, y = pos32[:, 0], pos32[:, 1]
    if tile_w is not None:
        x = torch.remainder(x, torch.tensor(tile_w, dtype=x.dtype,
                                            device=x.device))
    return ((x >= 0.0) & (x <= 0.07)) | ((x >= 0.90) & (y >= 0.80))


def initial_state(pos32: torch.Tensor, vm32: torch.Tensor, P: Physics,
                  clusters: int, dtype=torch.float64) -> dict:
    """Init_Fluid (cpp:93-125) and turnOnStim_Mesh on the live cloud
    `pos32` (float32), with vm = `vm32`: every particle stimulated, the
    anchors fixed; `clusters` shape-matching clusters, one per equal x-tile
    of the world."""
    n = pos32.shape[0]
    tile_w = P.world_size[0] / clusters if clusters > 1 else None
    f = dict(dtype=dtype, device=pos32.device)
    pos = pos32.to(dtype)
    z1, z3 = torch.zeros(n, **f), torch.zeros(n, 3, **f)
    tile = torch.tensor(P.world_size[0] / clusters, dtype=torch.float32,
                        device=pos32.device)
    cid = torch.clamp(torch.floor(pos32[:, 0] / tile), 0, clusters - 1)
    return {"pos": pos, "vel": z3, "pv": z3, "cv": z3, "iv": z3,
            "orig": pos, "goal": pos,
            "mass": torch.full((n,), P.particle_mass, **f),
            "dens": torch.full((n,), P.stand_density, **f), "pres": z1,
            "vm": vm32.to(dtype), "inter_vm": z1, "iion": z1,
            "stim": torch.full((n,), P.stim_strength, **f), "w": z1,
            "fixed": anchors(pos32, tile_w), "cid": cid.long(),
            "clusters": clusters}


def turn_off_stim(s: dict) -> dict:
    """turnOffStim (cpp:764-783): stim = pres = -10000, vm, inter_vm, iion
    and w zeroed."""
    s = dict(s)
    for k, v in (("stim", -10000.0), ("pres", -10000.0), ("vm", 0.0),
                 ("inter_vm", 0.0), ("iion", 0.0), ("w", 0.0)):
        s[k] = torch.full_like(s[k], v)
    return s


# --- pairs ---------------------------------------------------------------------

@torch.no_grad()
def stencil_pairs(pos: torch.Tensor, P: Physics):
    """(i, j) of every ordered pair of particles whose cells (edge
    cell_size, truncated) differ by at most one along each axis, self pairs
    included, from a cell list: the particles sorted by cell, and for each
    of the 27 neighbour cells the run of its particles."""
    n = pos.shape[0]
    # cells from float32 positions by a float32 division, as the
    # configuration's float32 arithmetic bins them: a float64 division
    # would bin a particle on a cell face differently
    cell = torch.tensor(P.cell_size, dtype=torch.float32, device=pos.device)
    c = torch.floor(pos.float() / cell).long() + 1
    g0, g1 = P.dims[0] + 3, P.dims[1] + 3
    key = c[:, 0] + g0 * (c[:, 1] + g1 * c[:, 2])
    sk, order = torch.sort(key, stable=True)
    rows = torch.arange(n, device=pos.device)
    ii, jj = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                nk = key + (dx + g0 * (dy + g1 * dz))
                lo = torch.searchsorted(sk, nk)
                cnt = torch.searchsorted(sk, nk, right=True) - lo
                total = int(cnt.sum())
                i = torch.repeat_interleave(rows, cnt, output_size=total)
                first = torch.cumsum(cnt, 0) - cnt
                k = torch.arange(total, device=pos.device) \
                    - torch.repeat_interleave(first, cnt, output_size=total)
                ii.append(i)
                jj.append(order[torch.repeat_interleave(lo, cnt,
                                                        output_size=total)
                                + k])
    return torch.cat(ii), torch.cat(jj)


def _sum(i, vals, n):
    """Per-particle sums of pair values over their first index."""
    shape = (n,) + tuple(vals.shape[1:])
    return vals.new_zeros(shape).index_add(0, i, vals)


# --- shape matching ------------------------------------------------------------

def polar_rotation(a: torch.Tensor, iters: int = 30) -> torch.Tensor:
    """The rotation factor R of A = R S by Newton's iteration
    X <- (X + X^-T) / 2 from X = A / |A| (quadratic convergence for a
    non-singular A; the polar factor does not depend on the scale)."""
    x = a / torch.linalg.matrix_norm(a)[..., None, None]
    for _ in range(iters):
        x = 0.5 * (x + torch.linalg.inv(x).transpose(-1, -2))
    return x


def _moment(cid, k, u, v, rnd):
    """(K, 3, 3) per-cluster sums of u v^T."""
    outer = rnd(u)[:, :, None] * rnd(v)[:, None, :]
    return outer.new_zeros((k, 3, 3)).index_add(0, cid, outer)


def goals(s: dict, P: Physics, rnd=ident) -> torch.Tensor:
    """Shape matching's goal positions (cpp:234-329, linear match, volume
    conservation, anti-flip): fixed particles weigh x100 in each cluster's
    centre of mass only; fixed particles keep their goal."""
    k, cid, m = s["clusters"], s["cid"], s["mass"]
    mcm = m * torch.where(s["fixed"], P.fixed_mass_scale, 1.0).to(m.dtype)
    msum = mcm.new_zeros(k).index_add(0, cid, mcm)

    def centre(x):
        num = x.new_zeros((k, 3)).index_add(0, cid, rnd(mcm)[:, None]
                                            * rnd(x))
        return num / msum[:, None]

    cm, ocm = centre(s["pos"]), centre(s["orig"])
    p, q = s["pos"] - cm[cid], s["orig"] - ocm[cid]
    apq = _moment(cid, k, m[:, None] * p, q, rnd)
    aqq = _moment(cid, k, m[:, None] * q, q, rnd)
    flip = torch.tensor([[1.0, -1.0, 1.0], [1.0, -1.0, 1.0],
                         [1.0, 1.0, -1.0]], dtype=apq.dtype,
                        device=apq.device)
    neg = torch.linalg.det(apq) < 0.0
    apq = torch.where(neg[:, None, None], apq * flip, apq)
    r = polar_rotation(apq)
    a = apq @ torch.linalg.inv(aqq)
    det = torch.linalg.det(a)
    nz = det != 0.0
    scale = torch.clamp(1.0 / torch.sqrt(torch.where(nz, det, 1.0).abs()),
                        max=2.0)
    a = a * torch.where(nz, scale, 1.0)[:, None, None]
    t = r * (1.0 - P.sm_beta) + a * P.sm_beta
    goal = (t[cid] @ q[:, :, None])[:, :, 0] + cm[cid]
    return torch.where(s["fixed"][:, None], s["goal"], goal)


# --- the coupled step ----------------------------------------------------------

def _poly6(r2, P):
    h2 = P.kernel_h ** 2
    return torch.where(r2 <= h2, P.poly6 * torch.clamp(h2 - r2, min=0) ** 3,
                       torch.zeros_like(r2))


def _bspline2(r, P):
    q = r / P.kernel_h
    c = P.bspline
    return torch.where(q < 1.0, c * (-3.0 + 4.5 * q),
                       torch.where(q < 2.0, c * 1.5 * (2.0 - q),
                                   torch.zeros_like(q)))


def density(pos, mass, i, j, d2, P, rnd=ident):
    """Poly6 density over the stencil pairs, with the reference's second
    self term (cpp:483)."""
    w6 = _poly6(d2, P)
    return _sum(i, rnd(w6) * rnd(mass[j]), pos.shape[0]) \
        + mass * P.poly6 * P.kernel_h ** 6


def step(s: dict, P: Physics, k_stiff=None, mu=None, rnd=ident) -> dict:
    """One coupled step (compute_SPH_SM_monodomain, cpp:794-824);
    `k_stiff` / `mu` override the EOS stiffness and the viscosity (tensors
    for the fit's gradient)."""
    k_stiff = P.k_stiffness if k_stiff is None else k_stiff
    mu = P.mu_viscosity if mu is None else mu
    dt, n = P.dt, s["pos"].shape[0]
    pos, m, fixed = s["pos"], s["mass"], s["fixed"]
    g = torch.tensor(P.gravity, dtype=pos.dtype, device=pos.device)

    pv = torch.where(fixed[:, None], s["pv"],
                     s["vel"] + g * (dt / m)[:, None])
    s = dict(s, pv=pv)
    goal = goals(s, P, rnd)
    cv = pv + (goal - pos) * (P.sm_alpha / dt)

    i, j = stencil_pairs(pos.detach(), P)
    d = pos[i] - pos[j]
    d2 = (d * d).sum(1)
    w6 = _poly6(d2, P)
    volm = m / s["dens"]
    iv = cv + P.velocity_mixing * _sum(
        i, rnd(w6 * volm[j])[:, None] * rnd(cv[j] - cv[i]), n)
    dens = density(pos, m, i, j, d2, P, rnd)
    pres = k_stiff * (dens - P.stand_density) - s["vm"] * P.voltage_constant
    pres = torch.where(s["stim"] > 0,
                       torch.clamp(pres, -P.max_pressure, P.max_pressure),
                       torch.zeros_like(pres))

    denom = P.fh_vp - P.fh_vr
    asd = (P.fh_vt - P.fh_vr) / denom
    u = (s["vm"] - P.fh_vr) / denom
    iion = s["iion"] + dt * (P.fh_c1 * u * (u - asd) * (u - 1.0)
                             + P.fh_c2 * s["w"]) / m
    w = s["w"] + dt * P.fh_c3 * (u - P.fh_c4 * s["w"]) / m

    keep = d2 > _PAIR_EPS
    i, j, d, d2 = i[keep], j[keep], d[keep], d2[keep]
    r = torch.sqrt(d2)
    h = P.kernel_h
    inside = r <= h
    volj = (m / dens)[j]
    spiky = torch.where(inside, -P.spiky * (h - r) ** 2, torch.zeros_like(r))
    visco = torch.where(inside, P.spiky * (h - r), torch.zeros_like(r))
    f_p = volj * (pres[i] + pres[j]) * 0.5 * spiky / r
    acc = -_sum(i, rnd(f_p)[:, None] * rnd(d), n)
    acc = acc + _sum(i, rnd(volj * mu * visco)[:, None]
                     * rnd(iv[j] - iv[i]), n)
    acc = acc / dens[:, None]
    lap = _sum(i, rnd(volj * _bspline2(r, P)) * rnd(s["vm"][j] - s["vm"][i]),
               n)
    inter_vm = lap + P.vm_scale * lap \
        - (iion - s["stim"] * dt / m) / P.cm_capacitance

    vel = iv + acc * (dt / m)[:, None]
    new = pos + vel * dt
    vel = torch.where(fixed[:, None], s["vel"], vel)
    new = torch.where(fixed[:, None], pos, new)
    vm = torch.clamp(s["vm"] + inter_vm * dt / m, -P.max_voltage,
                     P.max_voltage)
    world = torch.tensor(P.world_size, dtype=pos.dtype, device=pos.device)
    low, high = new < 0.0, new >= world
    vel = torch.where(low | high, vel * P.wall_hit, vel)
    new = torch.where(low, torch.zeros_like(new), new)
    new = torch.where(high, (world - 1e-4).expand_as(new), new)
    new = torch.minimum(torch.clamp(new, min=0.0), world)
    return dict(s, pos=new, vel=vel, cv=cv, iv=iv, goal=goal, dens=dens,
                pres=pres, vm=vm, inter_vm=inter_vm, iion=iion, w=w)


@torch.no_grad()
def run_protocol(s: dict, P: Physics, steps: int, stim_off: int, keep,
                 rnd=ident) -> dict:
    """{step: state} after each step count in `keep` of the reference
    protocol: `steps` coupled steps, turnOffStim before step `stim_off`
    (main.cpp:329-334)."""
    out = {}
    for t in range(steps):
        if t == stim_off:
            s = turn_off_stim(s)
        s = step(s, P, rnd=rnd)
        if t + 1 in keep:
            out[t + 1] = s
    return out


# --- the frozen-cloud monodomain wave ------------------------------------------

@torch.no_grad()
def wave_operator(s: dict, P: Physics, rnd=ident):
    """(i, j, weight) of the frozen cloud's Vm Laplacian: vol_j W2(r_ij)
    over the stencil pairs with r^2 > eps, vol = m / the Poly6 density of
    the frozen cloud."""
    pos, m = s["pos"], s["mass"]
    i, j = stencil_pairs(pos, P)
    d = pos[i] - pos[j]
    d2 = (d * d).sum(1)
    dens = density(pos, m, i, j, d2, P, rnd)
    keep = d2 > _PAIR_EPS
    i, j, d2 = i[keep], j[keep], d2[keep]
    return i, j, (m / dens)[j] * _bspline2(torch.sqrt(d2), P), dens


@torch.no_grad()
def run_wave(s: dict, P: Physics, steps: int, rnd=ident) -> dict:
    """`steps` steps of the FHN reaction and the Vm diffusion on the frozen
    cloud (the reaction-diffusion core of cpp:562-593, 612-616)."""
    i, j, wgt, dens = wave_operator(s, P, rnd)
    n, dt, m = s["pos"].shape[0], P.dt, s["mass"]
    vm, w, iion, inter_vm = s["vm"], s["w"], s["iion"], s.get("inter_vm")
    denom = P.fh_vp - P.fh_vr
    asd = (P.fh_vt - P.fh_vr) / denom
    wr = rnd(wgt)
    for _ in range(steps):
        u = (vm - P.fh_vr) / denom
        iion = iion + dt * (P.fh_c1 * u * (u - asd) * (u - 1.0)
                            + P.fh_c2 * w) / m
        w = w + dt * P.fh_c3 * (u - P.fh_c4 * w) / m
        lap = _sum(i, wr * rnd(vm[j] - vm[i]), n)
        inter_vm = lap + P.vm_scale * lap \
            - (iion - s["stim"] * dt / m) / P.cm_capacitance
        vm = torch.clamp(vm + inter_vm * dt / m, -P.max_voltage,
                         P.max_voltage)
    return dict(s, vm=vm, w=w, iion=iion, inter_vm=inter_vm, dens=dens)

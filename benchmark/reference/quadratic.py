"""Plain PyTorch reference of the coupled step with quadratic shape matching
(the reference application's `quadraticMatch`, toggled by `flip_quadratic`,
SPH_SM_monodomain.h:154, SPH_SM_monodomain.cpp:331-445; Mueller et al.
2005, "Meshless Deformations Based on Shape Matching", section 4.3).

The goal transform is a 3 x 9 matrix over the rest shape's quadratic basis
q~ = (x, y, z, x^2, y^2, z^2, xy, yz, zx) of q = orig - ocm (cpp:348-350):
    A9pq = sum m p q~^T,  A9qq = sum m q~ q~^T         (cpp:352-388)
    A~ = beta A9pq A9qq^+ + (1 - beta) [R 0]            (cpp:390-403)
with R the rotation of the linear moment Apq (anti-flipped as in the
linear match, cpp:294-302); the determinant of A~'s linear block decides
the anti-flip signs of that block and the volume scale (cpp:405-427);
goal = A~ q~ + cm (cpp:429-443). A9qq^+ is m9Matrix::invert
(m9Matrix.cpp:10-102): exactly `pinv_rotations` max-pivot Jacobi
rotations (the configuration's; else its `jacobi_iterations`; else the
app's JACOBI_ITERATIONS, 20), each on the first largest |off-diagonal| in
row-major order,
stopping early only where that is 0, and each as m9Matrix::jacobiRotate
writes it (the diagonal moved by t a_pq, the pivot pair set to 0, the
other rows and columns of p and q rotated, the rotation kept in R's
columns); then R diag(1 / lambda) R^T with the reciprocal of an eigenvalue
of exactly 0 taken as 0. The app's 20 rotations do not diagonalise a 9 x 9
(36 off-diagonal pairs): with them the result is the app's under-converged
inverse; with ~100 it is the exact inverse of Mueller et al. section 4.3
to rounding.

Everything else of the step (external forces, XSPH, density and pressure,
FHN, forces and the Vm Laplacian, integration and walls) is physics.py's,
imported unchanged: `step` differs from physics.step only in its goals.

Departures from the app, beyond physics.py's own:
  - float64 throughout (the app computes in float32, `m3Real`), with
    `rnd` as in physics.py for the lower-precision control;
  - R by physics.polar_rotation (Newton's iteration to convergence), where
    the app takes R from 20 Jacobi rotations of Apq^T Apq
    (m3Matrix.cpp:73-113): a 3 x 3 Jacobi converges in far fewer, so the
    two agree to rounding;
  - one shape-matching cluster (the configuration's).
No code of the package under test is used.
"""

from __future__ import annotations

import torch

from . import physics
from .physics import ident

# m9Matrix::eigenDecomposition's rotations in the app (JACOBI_ITERATIONS)
JACOBI_ROTATIONS = 20

_FLIP = ((1.0, -1.0, 1.0), (1.0, -1.0, 1.0), (1.0, 1.0, -1.0))


class Physics(physics.Physics):
    """physics.Physics of a configuration whose `quadratic_match` is true
    (the other switches as physics.py requires them), with the rotations
    of its 9 x 9 inverse, `pinv_rotations`."""

    def __init__(self, d: dict):
        if d.get("quadratic_match") is not True:
            raise ValueError("the quadratic reference needs "
                             "quadratic_match: true")
        super().__init__(dict(d, quadratic_match=False))
        self.quadratic_match = True
        self.pinv_rotations = (d.get("pinv_rotations")
                               or d.get("jacobi_iterations", JACOBI_ROTATIONS))


def basis(q: torch.Tensor) -> torch.Tensor:
    """(N, 9) q~ of (N, 3) q (cpp:348-350)."""
    x, y, z = q[:, 0], q[:, 1], q[:, 2]
    return torch.stack([x, y, z, x * x, y * y, z * z, x * y, y * z, z * x],
                       dim=1)


def jacobi_pinv(a: torch.Tensor, rotations: int = JACOBI_ROTATIONS):
    """(A^+, pivots) of a symmetric n x n matrix by m9Matrix::invert: at
    most `rotations` max-pivot Jacobi rotations, then R diag(1/lambda) R^T
    with 1/0 taken as 0. `pivots` lists each rotation's (p, q)."""
    a = a.clone()
    n = a.shape[0]
    r = torch.eye(n, dtype=a.dtype, device=a.device)
    upper = torch.ones(n, n, dtype=torch.bool, device=a.device).triu(1)
    rows = torch.arange(n, device=a.device)
    pivots = []
    for _ in range(rotations):
        # torch.argmax returns the first of equal maxima, row-major here
        idx = int(torch.argmax(torch.where(upper, a.abs(),
                                           torch.full_like(a, -1.0))))
        p, q = divmod(idx, n)
        apq = a[p, q].clone()
        if float(apq.abs()) <= 0.0:
            break
        pivots.append((p, q))
        d = (a[p, p] - a[q, q]) / (2.0 * apq)
        t = 1.0 / (d.abs() + torch.sqrt(d * d + 1.0))
        if float(d) < 0.0:
            t = -t
        c = 1.0 / torch.sqrt(t * t + 1.0)
        s = t * c
        a[p, p] += t * apq
        a[q, q] -= t * apq
        a[p, q] = a[q, p] = 0.0
        other = (rows != p) & (rows != q)
        akp, akq = a[:, p].clone(), a[:, q].clone()
        new_p = torch.where(other, c * akp + s * akq, a[:, p])
        new_q = torch.where(other, -s * akp + c * akq, a[:, q])
        a[:, p], a[p, :] = new_p, new_p
        a[:, q], a[q, :] = new_q, new_q
        rkp, rkq = r[:, p].clone(), r[:, q].clone()
        r[:, p] = c * rkp + s * rkq
        r[:, q] = -s * rkp + c * rkq
    lam = torch.diagonal(a)
    nz = lam != 0.0
    inv = torch.where(nz, 1.0 / torch.where(nz, lam, torch.ones_like(lam)),
                      torch.zeros_like(lam))
    return (r * inv[None, :]) @ r.T, pivots


def rest_a9qq(orig: torch.Tensor, mass: torch.Tensor,
              fixed: torch.Tensor, P: Physics, rnd=ident) -> torch.Tensor:
    """A9qq of the rest shape (cpp:383-388): q about the rest centre of
    mass, in which fixed particles weigh fixed_mass_scale times."""
    mcm = mass * torch.where(fixed, P.fixed_mass_scale, 1.0).to(mass.dtype)
    ocm = (rnd(mcm)[:, None] * rnd(orig)).sum(0) / mcm.sum()
    q9 = basis(orig - ocm)
    return (rnd(mass[:, None] * q9)[:, :, None]
            * rnd(q9)[:, None, :]).sum(0)


def goals(s: dict, P: Physics, rnd=ident) -> torch.Tensor:
    """Quadratic shape matching's goal positions (cpp:234-302, 331-445):
    fixed particles weigh fixed_mass_scale times in each centre of mass
    only, and keep their goal."""
    if s["clusters"] != 1:
        raise ValueError("the quadratic reference matches one cluster")
    m, fixed = s["mass"], s["fixed"]
    mcm = m * torch.where(fixed, P.fixed_mass_scale, 1.0).to(m.dtype)

    def centre(x):
        return (rnd(mcm)[:, None] * rnd(x)).sum(0) / mcm.sum()

    cm, ocm = centre(s["pos"]), centre(s["orig"])
    p, q = s["pos"] - cm, s["orig"] - ocm
    q9 = basis(q)
    mp = m[:, None] * p

    def moment(u, v):
        return (rnd(u)[:, :, None] * rnd(v)[:, None, :]).sum(0)

    apq, a9pq = moment(mp, q), moment(mp, q9)
    a9qq = rest_a9qq(s["orig"], m, fixed, P, rnd)
    flip = torch.tensor(_FLIP, dtype=apq.dtype, device=apq.device)
    if float(torch.linalg.det(apq)) < 0.0:               # cpp:294-302
        apq = apq * flip
    r = physics.polar_rotation(apq[None])[0]
    pinv, _ = jacobi_pinv(a9qq, P.pinv_rotations)
    a9 = P.sm_beta * (a9pq @ pinv)                      # cpp:390-403
    a9 = torch.cat([a9[:, :3] + (1.0 - P.sm_beta) * r, a9[:, 3:]], dim=1)
    det = torch.linalg.det(a9[:, :3])                    # cpp:405-408
    if float(det) < 0.0:                                 # cpp:410-414
        a9 = torch.cat([a9[:, :3] * flip, a9[:, 3:]], dim=1)
    if float(det) != 0.0:                                # cpp:416-427
        a9 = a9 * torch.clamp(1.0 / torch.sqrt(det.abs()), max=2.0)
    goal = q9 @ a9.T + cm                                # cpp:429-443
    return torch.where(fixed[:, None], s["goal"], goal)


def step(s: dict, P: Physics, rnd=ident) -> dict:
    """One coupled step (compute_SPH_SM_monodomain, cpp:794-824) with
    quadratic shape matching: physics.step with these goals."""
    dt, n = P.dt, s["pos"].shape[0]
    pos, m, fixed = s["pos"], s["mass"], s["fixed"]
    g = torch.tensor(P.gravity, dtype=pos.dtype, device=pos.device)

    pv = torch.where(fixed[:, None], s["pv"],
                     s["vel"] + g * (dt / m)[:, None])
    s = dict(s, pv=pv)
    goal = goals(s, P, rnd)
    cv = pv + (goal - pos) * (P.sm_alpha / dt)

    i, j = physics.stencil_pairs(pos, P)
    d = pos[i] - pos[j]
    d2 = (d * d).sum(1)
    w6 = physics._poly6(d2, P)
    volm = m / s["dens"]
    iv = cv + P.velocity_mixing * physics._sum(
        i, rnd(w6 * volm[j])[:, None] * rnd(cv[j] - cv[i]), n)
    dens = physics.density(pos, m, i, j, d2, P, rnd)
    pres = P.k_stiffness * (dens - P.stand_density) \
        - s["vm"] * P.voltage_constant
    pres = torch.where(s["stim"] > 0,
                       torch.clamp(pres, -P.max_pressure, P.max_pressure),
                       torch.zeros_like(pres))

    denom = P.fh_vp - P.fh_vr
    asd = (P.fh_vt - P.fh_vr) / denom
    u = (s["vm"] - P.fh_vr) / denom
    iion = s["iion"] + dt * (P.fh_c1 * u * (u - asd) * (u - 1.0)
                             + P.fh_c2 * s["w"]) / m
    w = s["w"] + dt * P.fh_c3 * (u - P.fh_c4 * s["w"]) / m

    keep = d2 > physics._PAIR_EPS
    i, j, d, d2 = i[keep], j[keep], d[keep], d2[keep]
    r = torch.sqrt(d2)
    h = P.kernel_h
    inside = r <= h
    volj = (m / dens)[j]
    spiky = torch.where(inside, -P.spiky * (h - r) ** 2, torch.zeros_like(r))
    visco = torch.where(inside, P.spiky * (h - r), torch.zeros_like(r))
    f_p = volj * (pres[i] + pres[j]) * 0.5 * spiky / r
    acc = -physics._sum(i, rnd(f_p)[:, None] * rnd(d), n)
    acc = acc + physics._sum(i, rnd(volj * P.mu_viscosity * visco)[:, None]
                             * rnd(iv[j] - iv[i]), n)
    acc = acc / dens[:, None]
    lap = physics._sum(i, rnd(volj * physics._bspline2(r, P))
                       * rnd(s["vm"][j] - s["vm"][i]), n)
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

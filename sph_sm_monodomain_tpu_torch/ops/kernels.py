"""SPH smoothing kernels as elementwise tensor functions (mirror of
`sph_sm_monodomain_tpu.ops.kernels`, `:27-79`; reference
SPH_SM_monodomain.cpp:148-197).

Conventions of the reference:
  - Poly6 takes the SQUARED distance r2 (cpp:149-152);
  - Spiky is the pressure-gradient magnitude, already negated (cpp:155-158);
  - Visco is the viscosity Laplacian magnitude (cpp:161-164);
  - B_spline / B_spline_1 / B_spline_2 are the cubic B-spline and its first
    and second radial derivatives (cpp:166-197); B_spline_2 is the live
    Laplacian of the voltage diffusion (cpp:563).
Every function is branch-free (torch.where), so it runs on any shape.
"""

from __future__ import annotations

import torch

from ..config import SimConfig


def _zero(x):
    return torch.zeros_like(x)


def poly6(r2, cfg: SimConfig):
    """Poly6 density kernel on squared distance (cpp:149-152)."""
    h2 = cfg.kernel_h * cfg.kernel_h
    val = cfg.poly6_constant * (h2 - r2) ** 3
    return torch.where((r2 >= 0) & (r2 <= h2), val, _zero(val))


def spiky(r, cfg: SimConfig):
    """Spiky pressure-gradient magnitude (cpp:155-158); negative on its
    support."""
    h = cfg.kernel_h
    val = -cfg.spiky_constant * (h - r) * (h - r)
    return torch.where((r >= 0) & (r <= h), val, _zero(val))


def visco(r, cfg: SimConfig):
    """Viscosity Laplacian magnitude (cpp:161-164)."""
    h = cfg.kernel_h
    val = cfg.spiky_constant * (h - r)
    return torch.where((r >= 0) & (r <= h), val, _zero(val))


def _b_spline_pieces(r, cfg: SimConfig, inner_fn, outer_fn):
    q = r / cfg.kernel_h
    c = cfg.b_spline_constant
    inner, outer = c * inner_fn(q), c * outer_fn(q)
    return torch.where((q >= 0) & (q < 1), inner,
                       torch.where((q >= 1) & (q < 2), outer, _zero(outer)))


def b_spline(r, cfg: SimConfig):
    """Cubic B-spline kernel W(q), q = r/h (cpp:166-175)."""
    return _b_spline_pieces(r, cfg,
                            lambda q: 1.0 - 1.5 * q * q + 0.75 * q * q * q,
                            lambda q: 0.25 * (2.0 - q) ** 3)


def b_spline_1(r, cfg: SimConfig):
    """First radial derivative of the B-spline (cpp:177-186)."""
    return _b_spline_pieces(r, cfg, lambda q: -3.0 * q + 2.25 * q * q,
                            lambda q: -0.75 * (2.0 - q) ** 2)


def b_spline_2(r, cfg: SimConfig):
    """Second radial derivative of the B-spline (cpp:188-197): the kernel of
    the SPH-discretized monodomain Laplacian (Compute_Force, cpp:563)."""
    return _b_spline_pieces(r, cfg, lambda q: -3.0 + 4.5 * q,
                            lambda q: 1.5 * (2.0 - q))

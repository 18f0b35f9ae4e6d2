"""Shape matching (Mueller et al.) with velocity correction, single global
cluster (mirror of `sph_sm_monodomain_tpu.ops.shape_matching`, `:47-401`;
reference SPH_SM_monodomain.cpp:215-446, 653-667).

Reference quirks kept:
  - fixed particles weigh x100 in the center of mass only (cpp:247), plain
    mass in Apq / Aqq (cpp:267);
  - anti-flip negates entries (0,1), (1,1), (2,2) when det(Apq) < 0
    (cpp:294-299); in the quadratic path the same entries of A9's linear
    block, after the beta blend (cpp:410-414);
  - gravity overwrites any external-force contribution in strict mode
    (cpp:226-231 vs 218-223);
  - volume conservation clamps 1/sqrt(|det|) at 2.0 (cpp:311-320, 416-427);
  - corrected_vel has no fixed-particle skip (cpp:663-666).

The multi-cluster forms (`sm_clusters > 1`) are not ported yet and raise.
All reductions are fp32 matrix products; TF32 stays off on the run path
(models/monodomain.ensure_fp32).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SimConfig
from ..state import ParticleState
from .constants import const_tensor
from .linalg import det3, invert3, polar_decomposition, pseudo_inverse

# anti-flip sign pattern: negate (0,1), (1,1), (2,2) (cpp:296-298)
_FLIP_SIGNS = ((1.0, -1.0, 1.0),
               (1.0, -1.0, 1.0),
               (1.0, 1.0, -1.0))
_FLIP_SIGNS9 = tuple(row + (1.0,) * 6 for row in _FLIP_SIGNS)


def _single_cluster(cfg: SimConfig) -> None:
    if cfg.sm_clusters != 1:
        raise NotImplementedError(
            f"sm_clusters={cfg.sm_clusters}: the port runs the single "
            "global shape-matching cluster only")


def apply_external_forces(state: ParticleState, cfg: SimConfig,
                          external_forces=None) -> ParticleState:
    """predicted_vel = vel + g*dt/m for non-fixed particles (cpp:215-232).
    `external_forces` (N,3) counts only outside strict mode."""
    g = const_tensor(tuple(cfg.gravity), state.device)
    # a true division of dt by mass: Python's `dt / tensor` computes
    # reciprocal(mass) * dt, which rounds differently from the JAX package
    dtm = torch.full_like(state.mass, cfg.time_delta) / state.mass
    pv = state.vel + g[None, :] * dtm[:, None]
    if external_forces is not None and not cfg.strict_reference_mode:
        pv = pv + external_forces * dtm[:, None]
    pv = torch.where(state.fixed[:, None], state.predicted_vel, pv)
    return state.replace(predicted_vel=pv)


class SMInvariants(NamedTuple):
    """Step-invariant rest-shape moments: orig_pos, mass, fixed and active
    never change during a run, so the rest-shape side of the reference's
    per-step reductions (cpp:244-291) is computed once. `None` fields belong
    to the unused match path (linear vs quadratic)."""
    mass_cm_sum: torch.Tensor       # sum of cm-weighted masses (cpp:244-253)
    ocm: torch.Tensor               # (3,) rest-shape center of mass
    q: torch.Tensor                 # (N,3) orig_pos - ocm (cpp:263)
    mq: torch.Tensor                # (3,) sum of m*q
    aqq_inv: torch.Tensor | None    # (3,3) Aqq^-1 (cpp:281-291, 307)
    q9: torch.Tensor | None         # (N,9) quadratic basis (cpp:348-350)
    mq9: torch.Tensor | None        # (9,) sum of m*q9
    a9qq_pinv: torch.Tensor | None  # (9,9) pseudo-inverse (cpp:383-388)


def _masses(state: ParticleState, cfg: SimConfig):
    """Plain (cpp:267) and cm-weighted (cpp:247) masses, zero when inactive."""
    m = state.mass * state.active.to(state.mass.dtype)
    m_cm = m * torch.where(state.fixed, cfg.fixed_mass_scale, 1.0).to(m.dtype)
    return m, m_cm


def _quad_basis(q: torch.Tensor) -> torch.Tensor:
    x, y, z = q[:, 0], q[:, 1], q[:, 2]
    return torch.stack([x, y, z, x * x, y * y, z * z, x * y, y * z, z * x],
                       dim=1)


def sm_invariants(state: ParticleState, cfg: SimConfig) -> SMInvariants:
    """Precompute the rest-shape moments of `project_positions`."""
    _single_cluster(cfg)
    m, m_cm = _masses(state, cfg)
    mass_cm_sum = m_cm.sum()
    ocm = (m_cm @ state.orig_pos) / mass_cm_sum
    q = state.orig_pos - ocm
    mq = m @ q
    if not cfg.quadratic_match:
        aqq = (q * m[:, None]).T @ q
        return SMInvariants(mass_cm_sum, ocm, q, mq, invert3(aqq),
                            None, None, None)
    q9 = _quad_basis(q)
    mq9 = m @ q9
    a9qq = (q9 * m[:, None]).T @ q9
    return SMInvariants(mass_cm_sum, ocm, q, mq, None, q9, mq9,
                        pseudo_inverse(a9qq, cfg.jacobi_iterations))


def _volume_scale(det: torch.Tensor) -> torch.Tensor:
    """1/sqrt(|det|) clamped at 2, or 1 when det == 0 (cpp:311-320)."""
    nz = det != 0.0
    s = 1.0 / torch.sqrt(torch.where(nz, det, torch.ones_like(det)).abs())
    s = torch.clamp(s, max=2.0)
    return torch.where(nz, s, torch.ones_like(s))


def _anti_flip(A: torch.Tensor, det: torch.Tensor, signs) -> torch.Tensor:
    return torch.where(det < 0.0, A * signs, A)


def _linear_transform(Apq, aqq_inv, cfg: SimConfig):
    """Apq -> blended goal transform T (cpp:294-322)."""
    if not cfg.allow_flip:
        Apq = _anti_flip(Apq, det3(Apq), const_tensor(_FLIP_SIGNS,
                                                      Apq.device))
    R, _ = polar_decomposition(Apq, cfg.jacobi_iterations)
    A = Apq @ aqq_inv                                      # cpp:307-309
    if cfg.volume_conservation:
        A = A * _volume_scale(det3(A))                     # cpp:311-320
    return R * (1.0 - cfg.sm_beta) + A * cfg.sm_beta       # cpp:322


def _quadratic_transform(Apq, A9pq, a9qq_pinv, cfg: SimConfig):
    """(Apq, A9pq) -> quadratic goal transform A9 (3,9) (cpp:294-302,
    331-427)."""
    if not cfg.allow_flip:
        Apq = _anti_flip(Apq, det3(Apq), const_tensor(_FLIP_SIGNS,
                                                      Apq.device))
    R, _ = polar_decomposition(Apq, cfg.jacobi_iterations)
    A9 = (A9pq @ a9qq_pinv) * cfg.sm_beta
    A9 = torch.cat([A9[:, :3] + (1.0 - cfg.sm_beta) * R, A9[:, 3:]],
                   dim=1)                                  # cpp:390-403
    det = det3(A9[:, :3])                                  # cpp:405-408
    if not cfg.allow_flip:                                 # cpp:410-414
        A9 = _anti_flip(A9, det, const_tensor(_FLIP_SIGNS9, A9.device))
    if cfg.volume_conservation:                            # cpp:416-427
        A9 = A9 * _volume_scale(det)
    return A9


def project_positions(state: ParticleState, cfg: SimConfig,
                      sm_inv: SMInvariants | None = None) -> torch.Tensor:
    """Goal positions from the global best-fit transform (cpp:234-446);
    fixed particles keep their previous goal. The deforming-side moment
    splits as Apq = sum(m pos q^T) - cm (x) sum(m q), so the per-step work
    is one (3,N)@(N,3) product plus the cm reduction."""
    _single_cluster(cfg)
    if sm_inv is None:
        sm_inv = sm_invariants(state, cfg)
    m, m_cm = _masses(state, cfg)
    q = sm_inv.q
    posm = state.pos * m[:, None]
    cm = (m_cm @ state.pos) / sm_inv.mass_cm_sum           # cpp:244-253
    Apq = posm.T @ q - cm[:, None] * sm_inv.mq[None, :]    # cpp:269-279

    if not cfg.quadratic_match:
        # anti-flip BEFORE polar decomposition in the linear path
        T = _linear_transform(Apq, sm_inv.aqq_inv, cfg)
        goal = q @ T.T + cm                                # cpp:324-329
    else:
        q9 = sm_inv.q9                                     # cpp:348-350
        A9pq = posm.T @ q9 - cm[:, None] * sm_inv.mq9[None, :]
        A9 = _quadratic_transform(Apq, A9pq, sm_inv.a9qq_pinv, cfg)
        goal = q9 @ A9.T + cm                              # cpp:429-443
    return torch.where(state.fixed[:, None], state.goal_pos, goal)


def corrected_velocity(state: ParticleState, cfg: SimConfig,
                       sm_inv: SMInvariants | None = None,
                       external_forces=None) -> ParticleState:
    """Full SM velocity-correction phase (calculate_corrected_velocity,
    cpp:653-667): external forces -> goal positions -> corrected_vel."""
    state = apply_external_forces(state, cfg, external_forces)
    goal = project_positions(state, cfg, sm_inv=sm_inv)
    cv = state.predicted_vel + (goal - state.pos) * (
        (1.0 / cfg.time_delta) * cfg.sm_alpha)             # cpp:661-666
    return state.replace(goal_pos=goal, corrected_vel=cv)

"""Shape matching (Mueller et al.) with velocity correction, over one global
cluster or over `cfg.sm_clusters` independent ones (mirror of
`sph_sm_monodomain_tpu.ops.shape_matching`, `:47-401`; reference
SPH_SM_monodomain.cpp:215-446, 653-667).

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

With K = sm_clusters > 1 (multi-muscle scenes: one cluster per x-tile)
every moment carries a leading (K,) axis and the 3x3 algebra runs once on
the (K, 3, 3) batch, so a step's op count does not depend on K. The
per-cluster sums take one of the JAX package's three forms: blocked
(f*K <= _BLOCKED_MAX_LANES columns, f = 3 linear / 9 quadratic), contig
(tile-contiguous rows, `cfg.sm_tile_rows`) or one-hot. All reductions are
fp32 matrix products or sums, none atomic, so the card gives the same bits
on every run; each entry point here turns TF32 off (numerics.ensure_fp32).

`comm` (a parallel.comm.Comm, the counterpart of the JAX package's
`axis_name`): the rows are one rank's share of the particles, and every
global sum (mass sums, centers of mass, Apq / Aqq, the 9-D moments, the
clustered per-cluster sums, the float64 rest-shape ones too) is taken
over the ranks with `comm.all_sum`, the sums of one stage packed into one
collective; the 3x3 chain then runs replicated on every rank. Under
`comm` the clustered moments take the blocked or one-hot form, never the
contig one, which needs the tile-contiguous rows of one process.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SimConfig, pinv_rotations
from ..state import ParticleState
from ..utils import tracing
from .constants import const_tensor
from .linalg import (det3, invert3, polar_decomposition, pseudo_inverse,
                     small_matmul)
from .numerics import ensure_fp32, sqrt_rn

# anti-flip sign pattern: negate (0,1), (1,1), (2,2) (cpp:296-298)
_FLIP_SIGNS = ((1.0, -1.0, 1.0),
               (1.0, -1.0, 1.0),
               (1.0, 1.0, -1.0))
_FLIP_SIGNS9 = tuple(row + (1.0,) * 6 for row in _FLIP_SIGNS)

# widest blocked-q column count (f*K) that takes the blocked form; tests
# monkeypatch it to 0 to exercise the contig / one-hot forms at small K
_BLOCKED_MAX_LANES = 128


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
    to the unused match path (linear vs quadratic). With K clusters every
    moment has a leading (K,) axis; q / q9 stay per row, centered on the
    owning cluster's rest center."""
    mass_cm_sum: torch.Tensor       # sum of cm-weighted masses (cpp:244-253)
    ocm: torch.Tensor               # (3,) rest-shape center of mass
    q: torch.Tensor                 # (N,3) orig_pos - ocm (cpp:263)
    mq: torch.Tensor                # (3,) sum of m*q
    aqq_inv: torch.Tensor | None    # (3,3) Aqq^-1 (cpp:281-291, 307)
    q9: torch.Tensor | None         # (N,9) quadratic basis (cpp:348-350)
    mq9: torch.Tensor | None        # (9,) sum of m*q9
    a9qq_pinv: torch.Tensor | None  # (9,9) pseudo-inverse (cpp:383-388)
    # the blocked form's per-row hoists (K > 1 and f*K <= _BLOCKED_MAX_LANES;
    # row-aligned, so sm_rebind_rows refreshes them after a permutation)
    cid: torch.Tensor | None = None   # (N,) owning cluster
    w_cm: torch.Tensor | None = None  # (N,K) cm-weighted one-hot
    qb: torch.Tensor | None = None    # (N,K*f) block-sparse rest basis


def cluster_ids(orig_pos: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """(N,) int64 shape-matching cluster of each row: its rest-shape x-tile
    index (multi-muscle scenes tile the muscles along x at equal width,
    utils/io.scene_positions), clipped to [0, K-1] (dead rows' sentinel
    lands in cluster 0). A true fp32 division by a 0-dim tensor, as the JAX
    package divides: on the card a Python-scalar divisor becomes a multiply
    by its reciprocal, which would put a tile's first rows, at exactly
    k * tile_w, into tile k - 1."""
    k = cfg.sm_clusters
    tile_w = const_tensor(cfg.world_size[0] / k, orig_pos.device,
                          orig_pos.dtype)
    cid = torch.floor(orig_pos[:, 0] / tile_w)
    return torch.clamp(cid, 0, k - 1).long()


def _cluster_onehot(cid: torch.Tensor, k: int, dtype) -> torch.Tensor:
    """(N, K) one-hot cluster matrix: per-cluster sums become (K,N)@(N,F)
    products, the scatter-free form of a segment sum."""
    ar = torch.arange(k, device=cid.device)
    return (cid[:, None] == ar[None, :]).to(dtype)


def _masses(state: ParticleState, cfg: SimConfig):
    """Plain (cpp:267) and cm-weighted (cpp:247) masses, zero when inactive."""
    m = state.mass * state.active.to(state.mass.dtype)
    m_cm = m * torch.where(state.fixed, cfg.fixed_mass_scale, 1.0).to(m.dtype)
    return m, m_cm


def _allsum(comm, *parts):
    """The parts (tensors or None) summed over the ranks of `comm` in one
    collective, or unchanged without `comm`."""
    if comm is None:
        return parts
    live = [p for p in parts if p is not None]
    flat = comm.all_sum(torch.cat([p.reshape(-1) for p in live]))
    out, k = [], 0
    for p in parts:
        if p is None:
            out.append(None)
            continue
        out.append(flat[k:k + p.numel()].reshape(p.shape))
        k += p.numel()
    return tuple(out)


def _quad_basis(q: torch.Tensor) -> torch.Tensor:
    x, y, z = q[:, 0], q[:, 1], q[:, 2]
    return torch.stack([x, y, z, x * x, y * y, z * z, x * y, y * z, z * x],
                       dim=1)


def sm_invariants(state: ParticleState, cfg: SimConfig,
                  comm=None) -> SMInvariants:
    """Precompute the rest-shape moments of `project_positions` (summed
    over the ranks of `comm` when given)."""
    ensure_fp32()
    m, m_cm = _masses(state, cfg)
    k = cfg.sm_clusters
    if k > 1:
        return _clustered_invariants(state, cfg, m, m_cm, comm)
    if cfg.quadratic_match:
        return _quadratic_invariants(state, cfg, m, m_cm, comm)
    mass_cm_sum, ocm_num = _allsum(comm, m_cm.sum(), m_cm @ state.orig_pos)
    ocm = ocm_num / mass_cm_sum
    q = state.orig_pos - ocm
    mq, aqq = _allsum(comm, m @ q, (q * m[:, None]).T @ q)
    return SMInvariants(mass_cm_sum, ocm, q, mq, invert3(aqq),
                        None, None, None)


def _quadratic_invariants(state: ParticleState, cfg: SimConfig, m,
                          m_cm, comm=None) -> SMInvariants:
    """The quadratic moments of one cluster, computed in float64 and
    rounded once to the state's dtype, as _clustered_invariants' are (the
    JAX package sums in fp32): A9qq mixes the basis' linear and squared
    terms (condition number ~2e4 on the biceps clouds), and its
    pseudo-inverse carries the rounding of fp32 sums over the rows into
    every goal."""
    dtype, f64 = state.pos.dtype, torch.float64
    m, m_cm, orig = m.to(f64), m_cm.to(f64), state.orig_pos.to(f64)
    mass_cm_sum, ocm_num = _allsum(comm, m_cm.sum(), m_cm @ orig)
    ocm = ocm_num / mass_cm_sum
    q = orig - ocm
    q9 = _quad_basis(q)
    mq, mq9, a9qq = _allsum(comm, m @ q, m @ q9, (q9 * m[:, None]).T @ q9)
    fields = (mass_cm_sum, ocm, q, mq, None, q9, mq9,
              _pseudo_inverse(a9qq, cfg))
    return SMInvariants(*(None if x is None else x.to(dtype)
                          for x in fields))


def _pseudo_inverse(a9qq: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """A9qq's pseudo-inverse (cpp:383-388), of `pinv_rotations(cfg)`
    Jacobi rotations, computed on the host: each rotation is a chain of
    ~20 small dependent operations on a 9 x 9 (or K of them), which on the
    card would cost as many launches and a device sync for its pivot.
    While tracing is on, in the span `sm_invariants.pseudo_inverse`, whose
    attribute `pivots` keeps the (p, q) of each rotation, read after the
    span ends; the counter `sm_invariants.jacobi_rotations` counts the
    rotations."""
    rotations, host = pinv_rotations(cfg), a9qq.cpu()
    if not tracing.on():
        return pseudo_inverse(host, rotations).to(a9qq.device)
    pivots = []
    with tracing.span("sm_invariants.pseudo_inverse", pivots=pivots):
        out = pseudo_inverse(host, rotations, pivots).to(a9qq.device)
    pivots[:] = [(int(p), int(q)) for p, q in pivots]
    tracing.count("sm_invariants.jacobi_rotations", len(pivots))
    return out


def _clustered_invariants(state: ParticleState, cfg: SimConfig, m,
                          m_cm, comm=None) -> SMInvariants:
    """The moments of K clusters, each with a leading (K,) axis.

    Computed in float64 and rounded once to the state's dtype (the JAX
    package sums in fp32): they run once per run, and on a muscle far
    along x (x ~ 84 on biceps_full x56) fp32 sums of m * orig_pos over
    its 18,475 rows move the rest center, and the moments built on it,
    off by far more than fp32 rounding of the result; the fit carries that
    into every goal (tools/sm_precision.py). The sums take the rows as the
    step's form does: through the (K, R, .) reshape where that form is
    contig, so no (N, K) one-hot is built, else through the one-hot; under
    `comm` through the one-hot, summed over the ranks."""
    k, dtype, f64 = cfg.sm_clusters, state.pos.dtype, torch.float64
    n, tile_r = state.pos.shape[0], cfg.sm_tile_rows
    f = 9 if cfg.quadratic_match else 3
    cid = cluster_ids(state.orig_pos, cfg)
    m, m_cm, orig = m.to(f64), m_cm.to(f64), state.orig_pos.to(f64)
    if comm is None and f * k > _BLOCKED_MAX_LANES and tile_r > 0 \
            and k * tile_r <= n:
        def r3(v):
            return v[:k * tile_r].reshape(k, tile_r, -1)

        def seg_sum(v):                                    # (K, F)
            return r3(v).sum(1)

        def seg_outer(a, b):                               # (K, Fa, Fb)
            return r3(a).transpose(1, 2) @ r3(b)
    else:
        oh = _cluster_onehot(cid, k, f64)

        def seg_sum(v):
            return oh.T @ v

        def seg_outer(a, b):
            outer = a[:, :, None] * b[:, None, :]
            return (oh.T @ outer.reshape(n, -1)).reshape(
                k, a.shape[1], b.shape[1])
    mass_cm_sum, ocm_num = _allsum(comm, seg_sum(m_cm[:, None])[:, 0],
                                   seg_sum(m_cm[:, None] * orig))
    # an all-inactive cluster divides by 1e-30 instead of 0 (no NaN)
    mass_cm_sum = torch.clamp(mass_cm_sum, min=1e-30)
    ocm = ocm_num / mass_cm_sum[:, None]
    q = orig - ocm[cid]
    if not cfg.quadratic_match:
        mq, aqq = _allsum(comm, seg_sum(m[:, None] * q),
                          seg_outer(q * m[:, None], q))
        fields = (mass_cm_sum, ocm, q, mq, invert3(aqq), None, None, None)
    else:
        q9 = _quad_basis(q)
        mq, mq9, a9qq = _allsum(comm, seg_sum(m[:, None] * q),
                                seg_sum(m[:, None] * q9),
                                seg_outer(q9 * m[:, None], q9))
        fields = (mass_cm_sum, ocm, q, mq, None, q9, mq9,
                  _pseudo_inverse(a9qq, cfg))
    inv = SMInvariants(*(None if x is None else x.to(dtype)
                         for x in fields))
    return _hoist_blocked(inv, cid, m_cm.to(dtype), k)


def _hoist_blocked(sm_inv: SMInvariants, cid, m_cm,
                   k: int) -> SMInvariants:
    """Attach the blocked form's per-row hoists (cid, w_cm, qb) when f*K
    columns fit _BLOCKED_MAX_LANES; they are step-invariant, so no step
    rebuilds the (N,K) / (N,K*f) arrays."""
    qf = sm_inv.q if sm_inv.q9 is None else sm_inv.q9
    f = qf.shape[1]
    if f * k > _BLOCKED_MAX_LANES:
        return sm_inv
    oh = _cluster_onehot(cid, k, m_cm.dtype)
    qb = (oh[:, :, None] * qf[:, None, :]).reshape(qf.shape[0], k * f)
    return sm_inv._replace(cid=cid, w_cm=m_cm[:, None] * oh, qb=qb)


def sm_rebind_rows(sm_inv: SMInvariants, state: ParticleState,
                   cfg: SimConfig | None = None) -> SMInvariants:
    """Recompute the per-row members of hoisted invariants after a
    permutation or migration of the particle rows: the moments are
    permutation-invariant, q / q9 and the blocked hoists follow the rows.
    `cfg` is required for clustered invariants."""
    ensure_fp32()
    if sm_inv.ocm.dim() == 2:
        cid = cluster_ids(state.orig_pos, cfg)
        q = state.orig_pos - sm_inv.ocm[cid]
    else:
        q = state.orig_pos - sm_inv.ocm
    if sm_inv.q9 is None:
        sm_inv = sm_inv._replace(q=q)
    else:
        sm_inv = sm_inv._replace(q=q, q9=_quad_basis(q))
    if sm_inv.qb is not None:
        _, m_cm = _masses(state, cfg)
        sm_inv = _hoist_blocked(
            sm_inv._replace(cid=None, w_cm=None, qb=None), cid, m_cm,
            sm_inv.ocm.shape[0])
    return sm_inv


def _volume_scale(det: torch.Tensor) -> torch.Tensor:
    """1/sqrt(|det|) clamped at 2, or 1 when det == 0 (cpp:311-320), shaped
    to scale each matrix of a (..., r, c) batch."""
    nz = det != 0.0
    s = 1.0 / sqrt_rn(torch.where(nz, det, torch.ones_like(det)).abs())
    s = torch.clamp(s, max=2.0)
    return torch.where(nz, s, torch.ones_like(s))[..., None, None]


def _anti_flip(A: torch.Tensor, det: torch.Tensor, signs) -> torch.Tensor:
    return torch.where(det[..., None, None] < 0.0, A * signs, A)


def _linear_transform(Apq, aqq_inv, cfg: SimConfig):
    """Apq -> blended goal transform T (cpp:294-322), for one (3, 3) moment
    or a (K, 3, 3) batch."""
    if not cfg.allow_flip:
        Apq = _anti_flip(Apq, det3(Apq), const_tensor(_FLIP_SIGNS,
                                                      Apq.device))
    R, _ = polar_decomposition(Apq, cfg.jacobi_iterations)
    A = small_matmul(Apq, aqq_inv)                         # cpp:307-309
    if cfg.volume_conservation:
        A = A * _volume_scale(det3(A))                     # cpp:311-320
    return R * (1.0 - cfg.sm_beta) + A * cfg.sm_beta       # cpp:322


def _quadratic_transform(Apq, A9pq, a9qq_pinv, cfg: SimConfig):
    """(Apq, A9pq) -> quadratic goal transform A9 (3, 9) (cpp:294-302,
    331-427), or a (K, 3, 9) batch."""
    if not cfg.allow_flip:
        Apq = _anti_flip(Apq, det3(Apq), const_tensor(_FLIP_SIGNS,
                                                      Apq.device))
    R, _ = polar_decomposition(Apq, cfg.jacobi_iterations)
    A9 = small_matmul(A9pq, a9qq_pinv) * cfg.sm_beta
    A9 = torch.cat([A9[..., :3] + (1.0 - cfg.sm_beta) * R, A9[..., 3:]],
                   dim=-1)                                 # cpp:390-403
    det = det3(A9[..., :3])                                # cpp:405-408
    if not cfg.allow_flip:                                 # cpp:410-414
        A9 = _anti_flip(A9, det, const_tensor(_FLIP_SIGNS9, A9.device))
    if cfg.volume_conservation:                            # cpp:416-427
        A9 = A9 * _volume_scale(det)
    return A9


def _segment_form(sm_inv: SMInvariants, cfg: SimConfig, n: int,
                  comm=None) -> str:
    """The clustered form `project_positions` takes, by the JAX package's
    rule: "blocked" when the hoists exist (f*K <= _BLOCKED_MAX_LANES),
    "contig" when the rows are tile-contiguous (sm_tile_rows), K tiles fit
    the rows and no `comm` splits them over ranks, else "onehot"."""
    if sm_inv.qb is not None:
        return "blocked"
    k, tile_r = sm_inv.ocm.shape[0], cfg.sm_tile_rows
    return ("contig" if comm is None and tile_r > 0 and k * tile_r <= n
            else "onehot")


def _clustered_goal(state: ParticleState, cfg: SimConfig,
                    sm_inv: SMInvariants, m, m_cm,
                    comm=None) -> torch.Tensor:
    """Goal positions of K independent clusters (cfg.sm_clusters > 1):
    the per-cluster moments in the form `_segment_form` picks, one batched
    transform, and the goals.

    The moments are taken about each cluster's rest center, from
    pos - ocm = (pos - orig_pos) + q, where the JAX package sums m * pos
    about the world origin. The two are equal in exact arithmetic; in fp32
    a muscle far along x (x ~ 84 on biceps_full x56) makes every summand
    O(84) and the cm (x) sum(m q) split cancel to O(1): on the card those
    goals lie 4.7e-4 from float64 at x56, these 6.6e-6
    (tools/sm_precision.py; x alpha / dt ~ 97 in the corrected
    velocity). About the rest center every summand is O(1)."""
    k, n = sm_inv.ocm.shape[0], state.pos.shape[0]
    quad = sm_inv.q9 is not None
    f = 9 if quad else 3
    qf = sm_inv.q9 if quad else sm_inv.q
    mqf = sm_inv.mq9 if quad else sm_inv.mq
    rel = (state.pos - state.orig_pos) + sm_inv.q           # pos - ocm[cid]
    relm = rel * m[:, None]
    form = _segment_form(sm_inv, cfg, n, comm)
    if form == "blocked":
        # the cluster axis folded into the columns of a block-sparse q
        cm_num, afpq = _allsum(comm, sm_inv.w_cm.T @ rel, relm.T @ sm_inv.qb)
        cm = cm_num / sm_inv.mass_cm_sum[:, None]
        Afpq = afpq.reshape(3, k, f).permute(1, 0, 2) \
            - cm[:, :, None] * mqf[:, None, :]             # (K, 3, f)
    elif form == "contig":
        # torch.sum over each tile's rows, as the JAX package sums cm
        # here: a batched product (bmm) over a tile's 18,475 rows rounds
        # far worse on the card, and tile 0 of x56 then drifted 8x the x1
        # run's own one-ulp spread from it in 3 steps (tools/tile_drift.py)
        nk = k * cfg.sm_tile_rows

        def r3(v):
            return v[:nk].reshape(k, cfg.sm_tile_rows, -1)
        cm = r3(m_cm[:, None] * rel).sum(1) \
            / sm_inv.mass_cm_sum[:, None]                  # (K, 3)
        qf_r = r3(qf)
        outer = relm[:, :, None] * qf[:, None, :]          # (N, 3, f)
        Afpq = r3(outer.reshape(n, 3 * f)).sum(1).reshape(k, 3, f) \
            - cm[:, :, None] * mqf[:, None, :]
    else:
        cid = cluster_ids(state.orig_pos, cfg)
        oh = _cluster_onehot(cid, k, rel.dtype)
        outer = relm[:, :, None] * qf[:, None, :]          # (N, 3, f)
        cm_num, afpq = _allsum(comm, oh.T @ (m_cm[:, None] * rel),
                               oh.T @ outer.reshape(n, 3 * f))
        cm = cm_num / sm_inv.mass_cm_sum[:, None]
        Afpq = afpq.reshape(k, 3, f) - cm[:, :, None] * mqf[:, None, :]
    cm = cm + sm_inv.ocm                                   # world frame

    if quad:
        # Apq (for the polar R) is the first 3 columns of the 9-D moment
        # (q9[:, :3] == q, cpp:348-350)
        T = _quadratic_transform(Afpq[..., :3], Afpq, sm_inv.a9qq_pinv, cfg)
    else:
        T = _linear_transform(Afpq, sm_inv.aqq_inv, cfg)   # (K, 3, f)

    if form == "blocked":
        return sm_inv.qb @ T.transpose(1, 2).reshape(k * f, 3) \
            + cm[sm_inv.cid]
    if form == "contig":
        goal_nk = qf_r @ T.transpose(1, 2) + cm[:, None, :]
        # rows past the K tiles (padding) keep their goal
        return torch.cat([goal_nk.reshape(nk, 3), state.goal_pos[nk:]])
    return (qf[:, None, :] * T[cid]).sum(-1) + cm[cid]


def project_positions(state: ParticleState, cfg: SimConfig,
                      sm_inv: SMInvariants | None = None,
                      comm=None) -> torch.Tensor:
    """Goal positions from the best-fit transform of each cluster
    (cpp:234-446); fixed particles keep their previous goal. The deforming
    side of the moment splits as Apq = sum(m pos q^T) - cm (x) sum(m q), so
    the per-step work is one (3,N)@(N,f) product plus the cm reduction
    (and, under `comm`, one all_sum of both)."""
    ensure_fp32()
    if sm_inv is None:
        sm_inv = sm_invariants(state, cfg, comm)
    m, m_cm = _masses(state, cfg)
    if sm_inv.ocm.dim() == 2:
        goal = _clustered_goal(state, cfg, sm_inv, m, m_cm, comm)
        return torch.where(state.fixed[:, None], state.goal_pos, goal)
    posm = state.pos * m[:, None]
    q, q9 = sm_inv.q, sm_inv.q9
    cm_num, apq, a9pq = _allsum(comm, m_cm @ state.pos, posm.T @ q,
                                None if q9 is None else posm.T @ q9)
    cm = cm_num / sm_inv.mass_cm_sum                       # cpp:244-253
    Apq = apq - cm[:, None] * sm_inv.mq[None, :]           # cpp:269-279

    if not cfg.quadratic_match:
        # anti-flip BEFORE polar decomposition in the linear path
        T = _linear_transform(Apq, sm_inv.aqq_inv, cfg)
        goal = q @ T.T + cm                                # cpp:324-329
    else:
        # q9: cpp:348-350
        A9pq = a9pq - cm[:, None] * sm_inv.mq9[None, :]
        A9 = _quadratic_transform(Apq, A9pq, sm_inv.a9qq_pinv, cfg)
        goal = q9 @ A9.T + cm                              # cpp:429-443
    return torch.where(state.fixed[:, None], state.goal_pos, goal)


def corrected_velocity(state: ParticleState, cfg: SimConfig,
                       sm_inv: SMInvariants | None = None,
                       external_forces=None, comm=None) -> ParticleState:
    """Full SM velocity-correction phase (calculate_corrected_velocity,
    cpp:653-667): external forces -> goal positions -> corrected_vel;
    the moments summed over the ranks of `comm` when given."""
    state = apply_external_forces(state, cfg, external_forces)
    goal = project_positions(state, cfg, sm_inv=sm_inv, comm=comm)
    cv = state.predicted_vel + (goal - state.pos) * (
        (1.0 / cfg.time_delta) * cfg.sm_alpha)             # cpp:661-666
    return state.replace(goal_pos=goal, corrected_vel=cv)

"""Float32 precision of clustered shape matching far from the origin.

A multi-muscle scene tiles its muscles along x (biceps_full x56 reaches
x = 84), one shape-matching cluster a muscle. The JAX package sums each
cluster's moments in fp32 about the world origin: the rest center and
sum(m q), Aqq once per run, and per step Apq = sum(m pos q^T) - cm (x)
sum(m q), whose summands grow with x while the result does not. The port
takes the rest-shape invariants in float64 once per run and the per-step
moments about each cluster's rest center (ops/shape_matching.py).

This tool deforms every tile alike (a seeded displacement of up to ~0.03)
and prints, per tile, the largest distance of the goal positions from a
float64 evaluation: the port's, and those of the world-origin fp32 sums
(the JAX package's formula, each sum taken in one pass in row order). Each tile's goals should
be as far from float64 as tile 0's; a goal error e enters the corrected
velocity as e * sm_alpha / time_delta (~97 e).

    python -m sph_sm_monodomain_tpu_torch.tools.sm_precision \\
        [--replicate 56] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import shape_matching as sm
from ..utils.io import build_scene


def row_order_sums(terms: torch.Tensor, cid: torch.Tensor,
                   k: int) -> torch.Tensor:
    """(K, F) fp32 sums of the rows of `terms` (N, F) per cluster, in one
    pass in row order, as the reference's loops sum (cpp:244-279). Done on
    the host in numpy: elementwise fp32 adds, so no BLAS's blocking decides
    the rounding."""
    t = terms.detach().cpu().numpy().astype(np.float32)
    c = cid.cpu().numpy()
    counts = np.bincount(c, minlength=k)
    rows = np.zeros((k, int(counts.max()), t.shape[1]), np.float32)
    order = np.argsort(c, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for kk in range(k):
        rows[kk, :counts[kk]] = t[order[starts[kk]:starts[kk] + counts[kk]]]
    acc = np.zeros((k, t.shape[1]), np.float32)
    for j in range(rows.shape[1]):
        acc += rows[:, j]
    return torch.from_numpy(acc).to(terms.device)


def origin_goals(state, cfg) -> torch.Tensor:
    """Goals of the linear clustered match with every sum in fp32 about the
    world origin (the JAX package's formula), each sum taken in row order
    (`row_order_sums`). A blocked BLAS sum can hide the formula's loss on
    one host and not on another: MKL's GEMM on the CPU reads 3.5e-5 at a
    tile at x = 82.5, cuBLAS 4.69e-4 on biceps_full x56."""
    k = cfg.sm_clusters
    m, m_cm = sm._masses(state, cfg)
    cid = sm.cluster_ids(state.orig_pos, cfg)
    s = row_order_sums(torch.cat([m_cm[:, None],
                                  m_cm[:, None] * state.orig_pos], 1), cid, k)
    mass_cm_sum = torch.clamp(s[:, 0], min=1e-30)
    ocm = s[:, 1:] / mass_cm_sum[:, None]
    q = state.orig_pos - ocm[cid]
    posm = state.pos * m[:, None]
    s = row_order_sums(torch.cat([
        m[:, None] * q,
        ((q * m[:, None])[:, :, None] * q[:, None, :]).reshape(-1, 9),
        m_cm[:, None] * state.pos,
        (posm[:, :, None] * q[:, None, :]).reshape(-1, 9)], 1), cid, k)
    mq, aqq = s[:, :3], s[:, 3:12].reshape(k, 3, 3)
    cm = s[:, 12:15] / mass_cm_sum[:, None]
    apq = s[:, 15:].reshape(k, 3, 3) - cm[:, :, None] * mq[:, None, :]
    t = sm._linear_transform(apq, sm.invert3(aqq), cfg)
    goal = (q[:, None, :] * t[cid]).sum(-1) + cm[cid]
    return torch.where(state.fixed[:, None], state.goal_pos, goal)


def goal_errors(scene, seed: int = 0) -> dict:
    """{"port": [...], "origin": [...]}: per tile, the largest |goal -
    float64 goal| of the scene's state with every tile deformed alike."""
    st, cfg = scene.state, scene.cfg
    k = cfg.sm_clusters
    r = scene.num_particles // k
    rng = np.random.default_rng(seed)
    d = torch.from_numpy((rng.normal(size=(r, 3)) * 0.01).astype(
        np.float32)).to(st.device)
    pos = st.pos.clone()
    pos[:k * r] += d.repeat(k, 1)
    st = st.replace(pos=pos, predicted_vel=st.vel)
    st64 = st.replace(**{f: getattr(st, f).double() for f in (
        "pos", "orig_pos", "mass", "goal_pos", "vel", "predicted_vel")})
    want = sm.project_positions(st64, cfg)[:k * r].reshape(k, r, 3)
    out = {}
    for name, goal in (("port", sm.project_positions(st, cfg)),
                       ("origin", origin_goals(st, cfg))):
        err = (goal[:k * r].reshape(k, r, 3).double() - want).abs()
        out[name] = err.amax(dim=(1, 2)).tolist()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--replicate", type=int, default=56)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sc = build_scene("biceps_full", replicate=args.replicate,
                     device=args.device)
    errs = goal_errors(sc)
    print(f"biceps_full x{args.replicate} ({sc.state.device}): largest "
          "|goal - float64 goal| per tile", flush=True)
    for name, e in errs.items():
        print(f"  {name}: tile 0 {e[0]:.3g}, largest {max(e):.3g} (tile "
              f"{int(np.argmax(e))}); every tile "
              f"{[float(f'{v:.3g}') for v in e]}", flush=True)
    return errs


if __name__ == "__main__":
    main()

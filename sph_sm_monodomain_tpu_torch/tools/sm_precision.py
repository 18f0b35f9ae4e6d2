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
(the JAX package's formula, on the one-hot form). Each tile's goals should
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


def origin_goals(state, cfg) -> torch.Tensor:
    """Goals of the linear clustered match with every sum in fp32 about the
    world origin (the JAX package's formula, one-hot form)."""
    k = cfg.sm_clusters
    m, m_cm = sm._masses(state, cfg)
    cid = sm.cluster_ids(state.orig_pos, cfg)
    oh = sm._cluster_onehot(cid, k, m.dtype)
    mass_cm_sum = torch.clamp(m_cm @ oh, min=1e-30)
    ocm = (oh.T @ (m_cm[:, None] * state.orig_pos)) / mass_cm_sum[:, None]
    q = state.orig_pos - ocm[cid]
    mq = oh.T @ (m[:, None] * q)
    aqq = (oh.T @ ((q * m[:, None])[:, :, None] * q[:, None, :])
           .reshape(-1, 9)).reshape(k, 3, 3)
    cm = (oh.T @ (m_cm[:, None] * state.pos)) / mass_cm_sum[:, None]
    posm = state.pos * m[:, None]
    apq = (oh.T @ (posm[:, :, None] * q[:, None, :]).reshape(-1, 9)) \
        .reshape(k, 3, 3) - cm[:, :, None] * mq[:, None, :]
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

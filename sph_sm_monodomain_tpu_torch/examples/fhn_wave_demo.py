"""Monodomain-only demo: an FHN voltage wave on a frozen biceps cloud, on the
unfused monodomain path (the port of examples/fhn_wave_demo.py, without its
PNG frames: the renderer is not ported).

Stimulates a small region at the muscle's apex (its min-x end) and prints
the voltage range and the size of the active front after each block of
steps.

Run:
    python -m sph_sm_monodomain_tpu_torch.examples.fhn_wave_demo \\
        [steps] [--scene NAME] [--device cuda|cpu]
Defaults: 1000 steps of biceps_18475 (5,211 particles) on the card.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..models import variants
from ..ops.electrophysiology import set_stim
from ..utils.io import build_scene


def main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("steps", nargs="?", type=int, default=1000)
    ap.add_argument("--scene", default="biceps_18475")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    scene = build_scene(args.scene, stim=False, device=args.device)
    cfg, state = scene.cfg, scene.state
    n = scene.num_particles
    pts = state.pos[:n].cpu().numpy()
    apex = pts[np.argmin(pts[:, 0])]
    state = set_stim(state, tuple(apex), 0.005, cfg.stim_strength, cfg)
    n_stim = int((state.stim[:n] > 0).sum())
    print(f"{n} particles, {n_stim} stimulated at apex {apex.round(3)}",
          flush=True)

    tables = variants.monodomain_prepare(state, cfg,
                                         scene.neighbor_capacity)
    every = max(args.steps // 25, 1)
    for i in range(0, args.steps, every):
        state = variants.simulate_monodomain_only(state, tables, cfg,
                                                  num_steps=every)
        vm = state.vm[:n].cpu().numpy()
        print(f"step {i + every}: Vm [{vm.min():.1f}, {vm.max():.1f}], "
              f"active front: {int((np.abs(vm) > 1).sum())} particles",
              flush=True)
    return state.vm[:n].cpu().numpy()


if __name__ == "__main__":
    main()

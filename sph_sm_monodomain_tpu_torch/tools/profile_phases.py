"""Per-phase profile of the fused step for any scene size (mirror of the
JAX repository's tools/profile_phases.py; reference per-phase timing:
SPH_SM_monodomain.cpp:794-824).

Times the four incremental pipelines (bookkeeping -> +SM -> +sweep A ->
full step) over chained calls, on the card as replays of a captured
CUDA graph between CUDA events (utils/report.profile_phases_fused), and
prints the RAW pipeline times beside the clamped-difference attribution,
so a negative stage difference is visible instead of vanishing into a
zeroed column.

Usage:
  python -m sph_sm_monodomain_tpu_torch.tools.profile_phases \\
      --scene biceps_full [--replicate 56] [--impl v4] [--length 8]
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", default="biceps_full")
    ap.add_argument("--replicate", type=int, default=1)
    ap.add_argument("--impl", default=None)
    ap.add_argument("--length", type=int, default=None,
                    help="chained calls per timed pipeline (default: sized "
                         "from the scene's own cost)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..utils.io import build_scene
    from ..utils.report import profile_phases_fused

    t0 = time.time()

    def log(m):
        print(f"[{time.time() - t0:7.1f}s] {m}", flush=True)

    sc = build_scene(args.scene, replicate=args.replicate,
                     fused_impl=args.impl, device=args.device)
    log(f"scene {sc.name} x{args.replicate}: n={sc.num_particles} "
        f"impl={sc.fused_impl} sub_q={sc.sub_block} wc={sc.block_window} "
        f"clusters={sc.cfg.sm_clusters} device={sc.state.device}")
    ph = profile_phases_fused(sc, length=args.length)
    t1, t2, t3, t4 = ph["raw_pipeline_s"]
    log(f"raw pipelines: book={t1*1e3:.3f} +sm={t2*1e3:.3f} "
        f"+sweepA={t3*1e3:.3f} full={t4*1e3:.3f} ms")
    log(f"attributed: find_neighbors={ph['find_neighbors']*1e3:.3f} "
        f"corrected_velocity={ph['corrected_velocity']*1e3:.3f} "
        f"density_pressure={ph['density_pressure']*1e3:.3f} "
        f"compute_force={ph['compute_force']*1e3:.3f} "
        f"total={ph['total_step']*1e3:.3f} ms")
    return ph


if __name__ == "__main__":
    main()
    sys.exit(0)

"""End-to-end demo: the reference experiment, headless, on the card (the
port of examples/contraction_demo.py).

Replays the reference app's protocol (main.cpp:73, 329-334) on a biceps
scene, the coupled step with the stimulus switched off halfway, through
`run_protocol`'s frame callback, and writes:

  OUT/frames/frame_*.png   displacement-colored point renders (the GLUT
                           window's replacement, same colormap and
                           post-stim fade; raw PPM where PIL is missing)
  OUT/voltage_trace.png    action-potential trace at probe particles (only
                           where matplotlib is installed)

Run:
    python -m sph_sm_monodomain_tpu_torch.examples.contraction_demo \\
        [scene] [steps] [--device cuda|cpu] [--out DIR]
Defaults: biceps_18475 500 on the card, OUT = examples/out beside this
module.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ..models.monodomain import run_protocol
from ..utils.io import build_scene
from ..utils.render import render_points, save_png

OUT = Path(__file__).parent / "out"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scene", nargs="?", default="biceps_18475")
    ap.add_argument("steps", nargs="?", type=int, default=500)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    steps, out = args.steps, Path(args.out)
    record_every = max(steps // 20, 1)

    scene = build_scene(args.scene, device=args.device)
    n = scene.num_particles
    print(f"{args.scene}: {n} particles ({scene.state.device})", flush=True)
    frames_dir = out / "frames"
    frames_dir.mkdir(parents=True, exist_ok=True)

    probes = np.linspace(0, n - 1, 5).astype(int)
    vm_trace, disp_trace, t_axis, frames = [], [], [], []

    def cb(done, st):
        vm_trace.append(st.vm.detach().cpu().numpy()[probes])
        disp_trace.append(float(st.displacement()[:n].mean()))
        t_axis.append(done)
        fade = 1.0
        if done > steps // 2:
            fade = max(0.0, 1.0 - 0.008 * (done - steps // 2))
        img = render_points(st, scene.cfg, fade_ratio=fade, azimuth=0.4,
                            elevation=0.25)
        frames.append(save_png(str(frames_dir / f"frame_{done:05d}.png"),
                               img))

    t0 = time.perf_counter()
    state, aux, _ = run_protocol(scene, num_steps=steps, chunk=record_every,
                                 callback=cb)
    if state.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"{steps} steps in {wall:.1f}s ({wall / steps * 1e3:.2f} ms/step "
          f"with rendering), overflow={int(aux.overflow)}", flush=True)

    trace = None
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
        vm = np.asarray(vm_trace)
        for k, p in enumerate(probes):
            ax1.plot(t_axis, vm[:, k], label=f"particle {p}")
        ax1.axvline(steps // 2, ls="--", c="gray", label="stim off")
        ax1.set_ylabel("Vm")
        ax1.legend(fontsize=7)
        ax2.plot(t_axis, disp_trace)
        ax2.set_ylabel("mean displacement")
        ax2.set_xlabel("step")
        trace = out / "voltage_trace.png"
        fig.savefig(trace, dpi=120)
        print(f"trace -> {trace}", flush=True)
    except ImportError:
        pass

    print(f"{len(t_axis)} frames -> {frames_dir}", flush=True)
    return {"state": state, "frames": frames, "trace": trace,
            "mean_displacement": disp_trace, "wall_s": wall}


if __name__ == "__main__":
    main()

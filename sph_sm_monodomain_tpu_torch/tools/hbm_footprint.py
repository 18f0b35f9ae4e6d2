"""Per-scene device-memory footprint of the fused step on the card, and
the particle ceiling it projects (the port's counterpart of the JAX
repository's tools/hbm_footprint.py, which reads XLA's AOT memory
analysis; PyTorch has none).

For each scene this builds the state on the card and measures the peak of
torch.cuda.max_memory_allocated, less what the process held before the
scene was built, over one of two programs:
  - by default one prepared step of the scene's fused generation (after a
    warm-up step): state, hoisted invariants, the step's temporaries and
    its output;
  - with `--scan N`, the N-step simulate run, as run_protocol dispatches a
    chunk: the capture of a CUDA graph of `--unroll` steps and its replays
    (models/scan.py), with the graph's buffers, its memory pool and the
    result; with `--donate` the input state is a copy that the run
    overwrites (simulate_donated).
It prints the bytes resident before the measured program and the
footprint, the footprint per particle, and the ceiling it projects at the
card's own memory (torch.cuda.get_device_properties(0).total_memory),
taking the footprint as linear in the particle count.

Usage:
  python -m sph_sm_monodomain_tpu_torch.tools.hbm_footprint \\
      [--scenes biceps_full,biceps_full:7] [--scan N [--donate]
      [--unroll K]]

Scene spec: name[:replicate]. The card only: it exits with an error on a
host where torch sees no GPU.
"""

from __future__ import annotations

import argparse
import sys

DEFAULT = "biceps_full,biceps_full:7,biceps_full:56"


def footprint(scene, scan: int = 0, donate: bool = False,
              unroll: int = 1) -> tuple[int, int]:
    """(bytes allocated before the measured program, peak bytes allocated
    over it) of `scene`, whose state lives on the card; both include
    whatever the process held before. The program is one prepared fused
    step, or with `scan` > 0 two calls of the `scan`-step simulate (the
    first captures the graph, the second replays it), donated or not, with
    `unroll` steps a graph."""
    import torch
    from ..models import monodomain, scan as scan_mod
    from ..ops.shape_matching import sm_invariants

    dev = scene.state.device
    kw = dict(sub_q=scene.sub_block or None, impl=scene.fused_impl,
              pack_cap=scene.pack_cap, w_chunk=scene.block_window)
    with torch.no_grad():
        if scan > 0:
            scan_mod.clear_cache()
            sim = (monodomain.simulate_donated if donate
                   else monodomain.simulate)
            st = scan_mod.copy_state(scene.state) if donate \
                else scene.state
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            resident = torch.cuda.memory_allocated(dev)
            for _ in range(2):
                out = sim(st, scene.cfg, num_steps=scan, unroll=unroll,
                          **kw)[0]
                if donate:
                    st = out
                del out
            torch.cuda.synchronize(dev)
            peak = torch.cuda.max_memory_allocated(dev)
            del st
            scan_mod.clear_cache()
            return resident, peak
        sm_inv = sm_invariants(scene.state, scene.cfg)

        def step(st):
            return monodomain.step_fused(st, scene.cfg, sm_inv=sm_inv,
                                         **kw)[0]

        out = step(scene.state)                   # builds the kernels
        del out
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        resident = torch.cuda.memory_allocated(dev)
        out = step(scene.state)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        del out
    return resident, peak


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scenes", default=DEFAULT,
                    help="comma list of name[:replicate]")
    ap.add_argument("--scan", type=int, default=0,
                    help="measure the simulate run of this many steps (a "
                         "captured graph and its replays) instead of one "
                         "step")
    ap.add_argument("--donate", action="store_true",
                    help="with --scan: donate the input state "
                         "(run_protocol's dispatch on the fused paths)")
    ap.add_argument("--unroll", type=int, default=1,
                    help="with --scan: steps a captured graph holds "
                         "(run_protocol takes 4 above VERY_LARGE_CAP)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        sys.exit("hbm_footprint measures the card's allocator: torch sees "
                 "no CUDA GPU here")
    from ..utils.io import build_scene

    total = torch.cuda.get_device_properties(0).total_memory
    print(f"{torch.cuda.get_device_name(0)}: {total / 2**30:.2f} GiB")
    print(f"{'scene':>20} {'N':>9} {'resident MB':>11} {'peak MB':>9} "
          f"{'B/particle':>10} {'ceiling':>11}")
    rows = []
    for spec in args.scenes.split(","):
        parts = spec.split(":")
        rep = int(parts[1]) if len(parts) > 1 else 1
        name = parts[0] if rep == 1 else f"{parts[0]}_x{rep}"
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated(0)
        sc = build_scene(parts[0], replicate=rep, device="cuda")
        n = sc.num_particles
        try:
            resident, peak = footprint(sc, args.scan, args.donate,
                                       args.unroll)
            resident, peak = resident - held, peak - held
        except torch.cuda.OutOfMemoryError as e:  # a valid data point
            print(f"{name:>20} {n:>9} out of memory: "
                  f"{str(e).splitlines()[0][:60]}")
            continue
        finally:
            del sc
            torch.cuda.empty_cache()
        bpp = peak / n
        ceiling = int(total / bpp)
        print(f"{name:>20} {n:>9} {resident / 2**20:>11.1f} "
              f"{peak / 2**20:>9.1f} {bpp:>10.0f} {ceiling:>11,}")
        rows.append({"scene": name, "particles": n, "resident": resident,
                     "peak": peak, "bytes_per_particle": bpp,
                     "ceiling": ceiling, "total_memory": total,
                     "scan": args.scan, "donate": args.donate,
                     "unroll": args.unroll})
    return rows


if __name__ == "__main__":
    main()
    sys.exit(0)

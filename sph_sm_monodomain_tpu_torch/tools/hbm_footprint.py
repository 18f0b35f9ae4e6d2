"""Per-scene device-memory footprint of the fused step on the card, and
the particle ceiling it projects (the port's counterpart of the JAX
repository's tools/hbm_footprint.py, which reads XLA's AOT memory
analysis; PyTorch has none).

For each scene this builds the state on the card, hoists the
shape-matching invariants, runs one warm-up step, then resets the
allocator's peak and runs one more step of the scene's fused generation:
the peak of torch.cuda.max_memory_allocated over that step (state, hoisted
invariants, the step's temporaries and its output), less what the process
held before the scene was built, is the footprint. It prints the bytes
resident before the step and the footprint, the footprint per particle,
and the ceiling it projects at the card's own memory
(torch.cuda.get_device_properties(0).total_memory), taking the footprint
as linear in the particle count.

Usage:
  python -m sph_sm_monodomain_tpu_torch.tools.hbm_footprint \\
      [--scenes biceps_full,biceps_full:7]

Scene spec: name[:replicate]. The card only: it exits with an error on a
host where torch sees no GPU.
"""

from __future__ import annotations

import argparse
import sys

DEFAULT = "biceps_full,biceps_full:7,biceps_full:56"


def footprint(scene) -> tuple[int, int]:
    """(bytes allocated before the step, peak bytes allocated over one
    prepared fused step) of `scene`, whose state lives on the card; both
    include whatever the process held before."""
    import torch
    from ..models.monodomain import step_fused
    from ..ops.shape_matching import sm_invariants

    dev = scene.state.device
    with torch.no_grad():
        sm_inv = sm_invariants(scene.state, scene.cfg)

        def step(st):
            return step_fused(st, scene.cfg, scene.sub_block or None,
                              impl=scene.fused_impl, sm_inv=sm_inv,
                              pack_cap=scene.pack_cap,
                              w_chunk=scene.block_window)[0]

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
            resident, peak = footprint(sc)
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
                     "ceiling": ceiling, "total_memory": total})
    return rows


if __name__ == "__main__":
    main()
    sys.exit(0)

"""Benchmark rows in results_tpu.csv's schema, from the port (mirror of the
JAX repository's tools/bench_rows.py): "scene;particles;" + the reference
report schema (SPH_SM_monodomain.cpp:785-792) + "Phase Provenance".

Small scenes (<=200k particles) run the full chunked protocol, then the
fused phase profiler (utils/report.profile_phases_fused); --big adds the
biceps_full x56+ rows: the best of `--big-reps` chained 10-step chunks,
with the phase columns of the incremental-pipeline attribution rescaled
to that wall ("rescaled-to-wall").

--modes sph,monodomain adds the per-variant rows, tagged "scene[mode]":
each mode's run first, then its own profiler
(utils/report.profile_phases_{sph,monodomain}_fused).

--campaign adds the two full-length reproductions of the reference's
campaign (results_171107.csv: 2000 steps, sigma = 1, stim 500000;
results_171114.csv: 1000 steps, sigma 0.383, stim 800000), at the
campaign-era K = 0.8, alpha = 0.5, beta = 0.2 on biceps_18475. The
stimulus goes off at half the run, num_steps // 2, as the reference app
turns it off (main.cpp:329-334); the JAX tool turns it off at step 250
whatever the length.

Timings are the card's: give the card's name and power limit beside them.

Usage:
  python -m sph_sm_monodomain_tpu_torch.tools.bench_rows \\
      [--out results_torch.csv] [--big] [--modes coupled,sph,monodomain]
      [--scenes biceps_full,biceps_18475:1:500] [--campaign]
      [--profile-length N|auto] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

from ..config import SimConfig
from ..models.monodomain import VERY_LARGE_CAP, run_protocol, step_fused
from ..ops.shape_matching import sm_invariants
from ..utils.io import build_scene
from ..utils.report import (REPORT_HEADER, _chain_time, profile_phases_fused,
                            profile_phases_monodomain_fused,
                            profile_phases_sph_fused, report_row)

SMALL = [("biceps_full", 1, 500), ("biceps_18475", 1, 500),
         ("biceps_4944", 1, 500), ("biceps_full", 7, 200)]
BIG = [("biceps_full", 56, 60), ("biceps_full", 112, 60),
       ("biceps_full", 224, 60)]
VARIANT_ROWS = {
    "sph": [("susane", 1, 500), ("biceps_full", 1, 500)],
    "monodomain": [("biceps_18475", 1, 500), ("biceps_full", 1, 500),
                   ("biceps_full", 56, 100)],
}
# the reference campaign's two configurations (results_171107.csv,
# results_171114.csv): steps and constants; sigma is derived
# (sigma_i*sigma_e/(sigma_i+sigma_e)), so sigma = 1 needs
# sigma_i = sigma_e = 2, and the 171114 era ran the default 0.383
_ERA = dict(k_stiffness=0.8, sm_alpha=0.5, sm_beta=0.2)
CAMPAIGN = ((2000, dict(sigma_i=2.0, sigma_e=2.0, stim_strength=500000.0,
                        **_ERA)),
            (1000, dict(stim_strength=800000.0, **_ERA)))
HEADER = "scene;particles;" + REPORT_HEADER + ";Phase Provenance"


def _row_name(name, replicate):
    return name if replicate == 1 else f"multi_muscle_x{replicate}"


def _chunk_wall(scene, reps=6, length=10):
    """Best seconds per step of `length` chained fused steps, as one scan.

    Very large scenes (> models.monodomain.VERY_LARGE_CAP) time the same
    unrolled dispatch run_protocol takes there, chained in place
    (donated)."""
    state, cfg = scene.state, scene.cfg
    sm_inv = sm_invariants(state, cfg)

    def body(c):
        return step_fused(c, cfg, scene.sub_block or None,
                          impl=scene.fused_impl, sm_inv=sm_inv,
                          pack_cap=scene.pack_cap,
                          w_chunk=scene.block_window)[0]

    donate = state.pos.is_cuda and state.capacity > VERY_LARGE_CAP
    return _chain_time(body, state, length=length, reps=reps, donate=donate,
                       unroll=4 if donate else 1)


def _variant_row(sc, mode, steps, pk):
    """(avg_step_s, phases, row_cfg) for one SPH-only / monodomain-only
    row: the mode's run first (so the row is backed by an executed run),
    then the mode's profiler."""
    from ..models import variants

    state, cfg = sc.state, sc.cfg
    sub_q = sc.sub_block or 128
    if mode == "sph":
        row_cfg = variants.sph_only_config(cfg)
        out = variants.simulate_sph_only(
            state, row_cfg, sc.neighbor_capacity, num_steps=min(steps, 500),
            fused=state.pos.is_cuda, sub_q=sub_q)
        if int(out[1].overflow):
            raise RuntimeError("overflow during the SPH-only run")
        phases = profile_phases_sph_fused(sc, **pk)
    elif mode == "monodomain":
        row_cfg = cfg
        tables = variants.monodomain_prepare_fused(state, cfg, sub_q=sub_q)
        st = variants.simulate_monodomain_only_fused(
            state, tables, cfg, num_steps=min(steps, 500), sub_q=sub_q)
        float(st.vm[0])  # sync
        phases = profile_phases_monodomain_fused(sc, **pk)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return phases["total_step"], phases, row_cfg


def campaign_rows(pk: dict, device, log=print) -> list:
    """The rows of the two reference-campaign reproductions (CAMPAIGN):
    each a full-length run_protocol with the stimulus off at
    num_steps // 2, then the fused phase profile."""
    rows = []
    for steps, over in CAMPAIGN:
        sc = build_scene("biceps_18475", cfg=SimConfig().replace(**over),
                         device=device)
        log(f"campaign biceps_18475 x{steps}: n={sc.num_particles} {over}")
        _state, aux, _ = run_protocol(sc, num_steps=steps,
                                      stim_off_step=steps // 2, chunk=100)
        if int(aux.overflow):
            raise RuntimeError("overflow during the campaign run")
        phases = profile_phases_fused(sc, **pk)
        avg = phases["total_step"]
        rows.append(f"biceps_18475;{sc.num_particles};"
                    f"{report_row(sc.cfg, steps, avg, phases)};measured")
        log(f"  {avg * 1e3:.3f} ms/step [measured]")
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="results_torch.csv")
    ap.add_argument("--big", action="store_true",
                    help="include the biceps_full x56+ chunk-wall rows")
    ap.add_argument("--big-reps", type=int, default=6)
    ap.add_argument("--modes", default="coupled",
                    help="comma list of coupled,sph,monodomain — variant "
                         "rows are tagged 'scene[mode]' and use their mode "
                         "profilers")
    ap.add_argument("--campaign", action="store_true",
                    help="add the two full-length reference-campaign "
                         "reproduction rows (stim off at half the run)")
    ap.add_argument("--scenes", default=None,
                    help="comma list of name[:replicate[:steps]] overriding "
                         "the default row set")
    ap.add_argument("--profile-length", default="auto",
                    help="chained calls per profiled stage: an integer, or "
                         "'auto' (default) to size it from the scene's "
                         "measured cost")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    modes = [m.strip() for m in args.modes.split(",") if m.strip()]
    for m in modes:
        if m not in ("coupled",) + tuple(VARIANT_ROWS):
            raise SystemExit(f"unknown mode {m!r} (coupled/sph/monodomain)")

    rows = SMALL + (BIG if args.big else [])
    scene_rows = None
    if args.scenes:
        scene_rows = []
        for spec in args.scenes.split(","):
            parts = spec.split(":")
            scene_rows.append((parts[0],
                               int(parts[1]) if len(parts) > 1 and parts[1]
                               else 1,
                               int(parts[2]) if len(parts) > 2 and parts[2]
                               else 500))
        rows = scene_rows

    t0 = time.time()

    def log(m):
        print(f"[{time.time() - t0:7.1f}s] {m}", flush=True)

    pk = ({"length": None} if args.profile_length == "auto"
          else {"length": int(args.profile_length)})

    # incremental writes: header first, one append per row
    with open(args.out, "w") as f:
        f.write(HEADER + "\n")

    def emit(line):
        out_rows.append(line)
        with open(args.out, "a") as f:
            f.write(line + "\n")

    out_rows = []
    for mode in modes:
        mode_rows = rows if mode == "coupled" \
            else (scene_rows or VARIANT_ROWS[mode])
        for name, rep, steps in mode_rows:
            sc = build_scene(name, replicate=rep, device=args.device)
            n = sc.num_particles
            tag = _row_name(name, rep) + (
                "" if mode == "coupled" else f"[{mode}]")
            log(f"{tag}: n={n}")
            big = n > 200_000
            # "measured" = the profiler's own numbers; "rescaled-to-wall" =
            # the incremental attribution rescaled so the columns sum to
            # the chunk wall (the sum check then holds by construction)
            prov = "rescaled-to-wall" if (big and mode == "coupled") \
                else "measured"
            if mode != "coupled":
                avg, phases, row_cfg = _variant_row(sc, mode, steps, pk)
            elif not big:
                _state, aux, _ = run_protocol(sc, num_steps=steps,
                                              chunk=min(100, steps))
                if int(aux.overflow):
                    raise RuntimeError("overflow during the protocol")
                phases = profile_phases_fused(sc, **pk)
                avg = phases["total_step"]
                row_cfg = sc.cfg
            else:
                avg = _chunk_wall(sc, reps=args.big_reps)
                phases = profile_phases_fused(sc, **pk)
                s = sum(phases[k] for k in
                        ("find_neighbors", "corrected_velocity",
                         "density_pressure", "compute_force"))
                scale = avg / s if s > 0 else 0.0
                phases = {k: (v * scale if isinstance(v, float) else v)
                          for k, v in phases.items()}
                row_cfg = sc.cfg
            emit(f"{tag};{n};{report_row(row_cfg, steps, avg, phases)};"
                 f"{prov}")
            log(f"  {avg * 1e3:.3f} ms/step [{prov}]")

    if args.campaign:
        for line in campaign_rows(pk, args.device, log):
            emit(line)

    log(f"{len(out_rows)} rows -> {args.out}")
    return out_rows


if __name__ == "__main__":
    main()
    sys.exit(0)

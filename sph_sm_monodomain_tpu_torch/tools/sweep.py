"""Parameter-sweep benchmark campaign of the port (mirror of the JAX
repository's tools/sweep.py): the re-issue of the reference's committed
run-log campaign.

The reference ships 109 + 133 full-run rows (results_171107.csv /
results_171114.csv, schema printed by print_report,
SPH_SM_monodomain.cpp:785-792). Their parameter columns are CONSTANT
within each file: the campaign is two configurations, (sigma=1,
stim=500000) and (sigma=0.383, stim=800000), measured repeatedly. This
tool reproduces both anchors and extends them with a grid over the
headline physics constants (K, alpha, beta, mu — cpp:40, 64-65, 49),
emitting one print_report-schema row per configuration.

Timing: each row's step time is the wall of the whole `simulate` call
(stimulus off at half the run), ended with a synchronize and a host fetch,
best of two runs after a warm-up run. The find_neighbors /
corrected_velocity / density_pressure stages are profiled once per scene
at the anchor configuration and reused across rows; each row's
compute_force column is its measured total minus those shared stage
costs, so its phase columns sum to its own step time.

On the card the rows run the fused v4 step; with --device cpu, the unfused
step (as the JAX tool runs off the TPU).

Usage:
  python -m sph_sm_monodomain_tpu_torch.tools.sweep --scene biceps_18475 \\
      --steps 500 --out results_torch_sweep.csv [--quick] [--grid full]
      [--dynamic] [--repeat N] [--device cuda|cpu]
  python -m sph_sm_monodomain_tpu_torch.tools.sweep --summarize \\
      --out results_tpu_sweep.csv [--summary-out PATH.md]
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
import time


def reference_anchor_configs(base):
    """The two configurations of the committed reference campaign.

    sigma is derived (sigma_i*sigma_e/(sigma_i+sigma_e), cpp:26):
    sigma=1 needs sigma_i=sigma_e=2; the 171114 file's 0.3828 is the
    checked-in default. K/alpha/beta in the logs predate the checked-in
    constants (K=0.8, a=0.5, b=0.2 vs ctor 0.5/0.3/0.4)."""
    common = dict(k_stiffness=0.8, sm_alpha=0.5, sm_beta=0.2,
                  mu_viscosity=100.0)
    return [
        base.replace(sigma_i=2.0, sigma_e=2.0, stim_strength=500000.0,
                     **common),
        base.replace(stim_strength=800000.0, **common),
    ]


def grid_configs(base, full: bool = False):
    """K x alpha/beta x mu grid around the reference constants; --grid full
    crosses in the two axes the reference anchors vary (sigma, stim)."""
    cfgs = []
    ep_axes = [(None, None)]  # (sigma_i/e override, stim override)
    if full:
        ep_axes = [(None, 300.0), (None, 800000.0),
                   (2.0, 300.0), (2.0, 500000.0)]
    for k, (al, be), mu, (sig, stim) in itertools.product(
            (0.3, 0.5, 0.8),
            ((0.3, 0.4), (0.5, 0.2)),
            (50.0, 100.0, 200.0),
            ep_axes):
        kw = dict(k_stiffness=k, sm_alpha=al, sm_beta=be, mu_viscosity=mu)
        if sig is not None:
            kw.update(sigma_i=sig, sigma_e=sig)
        if stim is not None:
            kw.update(stim_strength=stim)
        cfgs.append(base.replace(**kw))
    return cfgs


def summarize(csv_path: str, out_md: str | None) -> int:
    """Analysis pass over a campaign CSV — the stand-in for the
    reference's results.ods spreadsheet: per-parameter sensitivity of the
    avg step time, campaign extremes, and phase-share sanity. Its text is
    the JAX tool's, so the two read a campaign file alike."""
    import numpy as np
    rows = []
    with open(csv_path) as f:
        for ln in f:
            if ln.startswith("#") or ln.startswith("Avg FPS"):
                continue
            cols = ln.strip().split(";")
            if len(cols) < 23:
                continue
            rows.append([float(c) for c in cols])
    if not rows:
        print(f"no rows in {csv_path}")
        return 1
    a = np.array(rows)
    step_ms = a[:, 1] * 1e3
    # schema indices: 1=step, 3..9=phases, 10=K, 11=alpha, 12=beta,
    # 13=mu, 14=sigma, 15=stim
    lines = [
        "# Sweep campaign analysis",
        "",
        f"Source: `{os.path.basename(csv_path)}` — {len(rows)} runs, "
        f"{int(a[0, 2])} steps each (stim-off at half), biceps_18475 "
        "anchor scene. The TPU re-issue of the analysis the reference "
        "keeps in `results.ods` over results_171107/171114.csv.",
        "",
        f"- avg step: min {step_ms.min():.3f} ms / median "
        f"{np.median(step_ms):.3f} ms / max {step_ms.max():.3f} ms",
        f"- throughput spread across the whole physics grid: "
        f"{step_ms.max() / step_ms.min():.2f}x",
        "",
        "Per-parameter sensitivity (mean step ms per value; the step time "
        "is dominated by candidate-lane enumeration, so physics constants "
        "only move it through density/contraction state):",
        "",
        "| param | value -> mean ms/step |",
        "|---|---|",
    ]
    for name, col in (("K", 10), ("alpha", 11), ("beta", 12), ("mu", 13),
                      ("sigma", 14), ("stim", 15)):
        vals = sorted(set(a[:, col]))
        cells = ", ".join(
            f"{v:g} -> {step_ms[a[:, col] == v].mean():.3f}" for v in vals)
        lines.append(f"| {name} | {cells} |")
    head = a[:, 3] + a[:, 4] + a[:, 6]   # find + corrvel + dens-pressure
    share = (head + a[:, 8]) / a[:, 1]   # + compute_force
    lines += [
        "",
        f"Phase-column reconciliation: phases sum to "
        f"{share.mean() * 100:.1f}% of the row step on average "
        f"(min {share.min() * 100:.1f}%, by construction ~100).",
    ]

    obs_path = csv_path.rsplit(".", 1)[0] + "_obs.csv"
    if os.path.exists(obs_path):
        # physics-observable sensitivity (dynamic campaigns): how the peak
        # contraction at stim-off moves with each swept constant
        orows = []
        with open(obs_path) as f:
            for ln in f:
                if ln.startswith("#") or ln.startswith("K;"):
                    continue
                orows.append([float(c) for c in ln.strip().split(";")])
        if orows:
            b = np.array(orows)
            lines += [
                "",
                "Physics sensitivity (mean displacement at stim-off — peak "
                "contraction — per parameter value; "
                f"`{os.path.basename(obs_path)}`):",
                "",
                "| param | value -> mean disp_mid |",
                "|---|---|",
            ]
            for name, col in (("K", 0), ("alpha", 1), ("beta", 2),
                              ("mu", 3), ("sigma", 4), ("stim", 5)):
                vals = sorted(set(b[:, col]))
                cells = ", ".join(
                    f"{v:g} -> {b[b[:, col] == v, 6].mean():.4f}"
                    for v in vals)
                lines.append(f"| {name} | {cells} |")
    text = "\n".join(lines) + "\n"
    if out_md:
        with open(out_md, "w") as f:
            f.write(text)
        print(f"summary -> {out_md}")
    else:
        print(text)
    return 0


def _shared_profile(scene0, fused: bool) -> dict:
    """The stage profile shared by every row, at the anchor configuration:
    every phase but compute_force, which each row fills with its residual."""
    from ..utils.report import profile_phases, profile_phases_fused
    if fused:
        shared = profile_phases_fused(scene0)
        for k in ("total_step", "raw_pipeline_s", "compute_force"):
            shared.pop(k)
        return shared
    shared = profile_phases(scene0.state, scene0.cfg,
                            scene0.neighbor_capacity)
    shared.pop("compute_force")
    return shared


def run_dynamic(args, cfgs, scene0) -> int:
    """One set of kernels for the whole grid: every configuration runs
    with its physics constants as runtime params (config.PARAM_FIELDS; on
    the card they reach the v4 sweeps through the physics-constant vector,
    ops/fused_step.build_dynp). stim_strength lives in state.stim (set at
    scene build), so rows that change it rescale the stimulated entries.
    The protocol runs as two half-length calls (stim-on, then stim-off
    from its first step)."""
    import numpy as np
    import torch
    from ..models.monodomain import simulate
    from ..utils.profiling import sync
    from ..utils.report import REPORT_HEADER, report_row

    base_cfg = cfgs[0]  # the static config; physics arrive as params
    state0 = scene0.state
    stim_mask = state0.stim > 0.0
    dyn_fields = ("k_stiffness", "sm_alpha", "sm_beta", "mu_viscosity",
                  "sigma_i", "sigma_e")
    fused = state0.pos.is_cuda
    if fused and scene0.fused_impl != "v4":
        raise SystemExit(f"--dynamic rides the v4 fused kernels; scene "
                         f"tuned to impl={scene0.fused_impl!r} (use --impl "
                         "v4)")
    half = args.steps // 2
    print(f"dynamic campaign: {len(cfgs)} configs x {args.steps} steps on "
          f"{args.scene} ({scene0.num_particles} particles), ONE compile "
          f"(one kernel build), path={'fused-v4' if fused else 'unfused'}, "
          f"device={state0.device}", flush=True)

    def run_row(cfg):
        """Full stim-on -> stim-off protocol; returns (mid state, end
        state) so each row also yields physics observables."""
        st = state0.replace(stim=torch.where(
            stim_mask, torch.tensor(cfg.stim_strength, dtype=torch.float32,
                                    device=state0.device), state0.stim))
        params = {f: float(getattr(cfg, f)) for f in dyn_fields}
        kw = dict(fused=fused, sub_q=scene0.sub_block or None,
                  impl="v4", params=params,
                  neighbor_capacity=scene0.neighbor_capacity)
        mid, _ = simulate(st, base_cfg, num_steps=half, stim_off_step=-1,
                          **kw)
        end, _ = simulate(mid, base_cfg, num_steps=args.steps - half,
                          stim_off_step=0, **kw)
        return mid, end

    n_act = scene0.num_particles

    def observables(mid, end):
        """Host-side physics summary of one run (active rows only)."""
        o = {}
        for tag, st in (("mid", mid), ("end", end)):
            disp = np.linalg.norm(
                (st.pos[:n_act] - st.orig_pos[:n_act]).cpu().numpy(), axis=1)
            vm = st.vm[:n_act].cpu().numpy()
            o[f"disp_mean_{tag}"] = float(disp.mean())
            o[f"disp_max_{tag}"] = float(disp.max())
            o[f"vm_min_{tag}"] = float(vm.min())
            o[f"vm_max_{tag}"] = float(vm.max())
        return o

    t0 = time.time()
    sync(run_row(cfgs[0])[1])  # builds the kernels
    build_s = time.time() - t0
    shared = _shared_profile(scene0, fused)
    head = sum(shared.values())
    print(f"built+warm in {build_s:.0f}s; shared phase head "
          f"{head*1e3:.3f}ms", flush=True)

    write_header = not os.path.exists(args.out)
    with open(args.out, "a") as f:
        if write_header:
            f.write("# Re-issue of the reference benchmark campaign "
                    "(dynamic-params mode: one kernel build, physics "
                    "constants as runtime inputs to the v4 fused "
                    "kernels).\n")
            f.write(REPORT_HEADER + "\n")
        else:
            f.write("# --- dynamic-params rows below (one build for the "
                    "whole grid) ---\n")
        obs_path = args.out.rsplit(".", 1)[0] + "_obs.csv"
        obs_keys = ("disp_mean_mid", "disp_max_mid", "vm_min_mid",
                    "vm_max_mid", "disp_mean_end", "disp_max_end",
                    "vm_min_end", "vm_max_end")
        with open(obs_path, "a") as obs_f:
            if obs_f.tell() == 0:
                obs_f.write("# Physics observables per campaign row "
                            "(active particles; 'mid' = at stim-off, step "
                            f"{half}; 'end' = after relaxation, step "
                            f"{args.steps}).\n")
                obs_f.write("K;Alpha;Beta;Mu;sigma;Stim strength;"
                            + ";".join(obs_keys) + "\n")
            for i, cfg in enumerate(cfgs):
                avg_step = 1e9
                for _ in range(2):
                    t0 = time.perf_counter()
                    mid, end = run_row(cfg)
                    sync(end)
                    avg_step = min(avg_step,
                                   (time.perf_counter() - t0) / args.steps)
                phases = dict(shared)
                phases["compute_force"] = max(avg_step - head, 0.0)
                f.write(report_row(cfg, args.steps, avg_step, phases) + "\n")
                f.flush()
                o = observables(mid, end)
                obs_f.write(";".join(
                    [f"{cfg.k_stiffness:g}", f"{cfg.sm_alpha:g}",
                     f"{cfg.sm_beta:g}", f"{cfg.mu_viscosity:g}",
                     f"{cfg.sigma:.6g}", f"{cfg.stim_strength:g}"]
                    + [f"{o[k]:.6g}" for k in obs_keys]) + "\n")
                obs_f.flush()
                print(f"[{i + 1}/{len(cfgs)}] K={cfg.k_stiffness} "
                      f"a={cfg.sm_alpha} b={cfg.sm_beta} "
                      f"mu={cfg.mu_viscosity} sigma={cfg.sigma:.3f} "
                      f"stim={cfg.stim_strength:g}: "
                      f"{avg_step*1e3:.2f} ms/step "
                      f"disp_mid={o['disp_mean_mid']:.4f}", flush=True)
    print(f"campaign -> {args.out}; observables -> {obs_path}")
    return 0


def _at_least_one(s: str) -> int:
    v = int(s)
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1 (got {v})")
    return v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", default="biceps_18475",
                    help="reference app scene (5,211 particles)")
    ap.add_argument("--steps", type=int, default=500,
                    help="steps per run (reference: 500..2000)")
    ap.add_argument("--out", default="results_torch_sweep.csv")
    ap.add_argument("--quick", action="store_true",
                    help="anchors + a 6-point grid (smoke test)")
    ap.add_argument("--grid", default="default",
                    choices=("default", "full"),
                    help="'full' crosses in the sigma/stim anchor axes "
                         "(74 configs, ~reference campaign breadth)")
    ap.add_argument("--impl", default=None, help="fused impl override")
    ap.add_argument("--dynamic", action="store_true",
                    help="one kernel build for every configuration: the "
                         "physics constants go in as runtime params "
                         "(config.PARAM_FIELDS); stim differences rescale "
                         "state.stim")
    ap.add_argument("--repeat", type=_at_least_one, default=1, metavar="N",
                    help="variance mode: run ONLY the two reference anchor "
                         "configurations, N raw timed runs each, one row "
                         "per run (no best-of filtering) — the artifact "
                         "shape the reference committed "
                         "(results_171107/171114.csv: 108 + 132 repeats of "
                         "one configuration each)")
    ap.add_argument("--summarize", action="store_true",
                    help="analyze an existing campaign CSV (no device work)")
    ap.add_argument("--summary-out", default=None, metavar="PATH.md")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.summarize:
        return summarize(args.out, args.summary_out)
    if args.dynamic and args.repeat > 1:
        raise SystemExit("--repeat is not supported with --dynamic (the "
                         "one-build campaign emits best-of rows); run "
                         "variance mode without --dynamic")

    from ..config import SimConfig
    from ..models.monodomain import simulate
    from ..utils.io import build_scene
    from ..utils.profiling import sync
    from ..utils.report import REPORT_HEADER, report_row

    base = SimConfig()
    if args.repeat > 1:
        cfgs = reference_anchor_configs(base)  # the committed campaign
    else:
        cfgs = reference_anchor_configs(base) + grid_configs(
            base, full=args.grid == "full")
    if args.quick:
        cfgs = cfgs[:8]
    scene0 = build_scene(args.scene, cfgs[0], fused_impl=args.impl,
                         device=args.device)
    if args.dynamic:
        return run_dynamic(args, cfgs, scene0)
    fused = scene0.state.pos.is_cuda
    print(f"campaign: {len(cfgs)} configs x {args.steps} steps on "
          f"{args.scene} ({scene0.num_particles} particles), "
          f"impl={scene0.fused_impl}, device={scene0.state.device}",
          flush=True)

    # shared stage profile at the first anchor (see the module docstring)
    shared = {}
    if fused:
        t0 = time.time()
        shared = _shared_profile(scene0, fused)
        print(f"shared stage profile in {time.time() - t0:.0f}s: "
              f"book={shared['find_neighbors']*1e3:.3f}ms "
              f"sm={shared['corrected_velocity']*1e3:.3f}ms "
              f"sweepA={shared['density_pressure']*1e3:.3f}ms", flush=True)

    write_header = not os.path.exists(args.out)
    with open(args.out, "a") as f:
        if write_header:
            f.write("# Re-issue of the reference benchmark campaign "
                    "(results_171107/171114.csv). One row per run; "
                    "find_neighbors/corrected_velocity/density_pressure "
                    "profiled once per scene at the anchor config, "
                    "compute_force = row total - those (columns sum to "
                    "the row's avg step).\n")
            f.write(REPORT_HEADER + "\n")
        for i, cfg in enumerate(cfgs):
            sc = build_scene(args.scene, cfg, fused_impl=args.impl,
                             device=args.device)

            def run():
                out = simulate(sc.state, cfg, num_steps=args.steps,
                               stim_off_step=args.steps // 2, fused=fused,
                               sub_q=sc.sub_block or None,
                               impl=sc.fused_impl, pack_cap=sc.pack_cap,
                               w_chunk=sc.block_window,
                               neighbor_capacity=sc.neighbor_capacity)
                sync(out[0])

            t0 = time.time()
            run()  # warm-up (the first call builds the kernels)
            warm_s = time.time() - t0

            def emit(avg_step):
                phases = dict(shared)
                if shared:
                    phases["compute_force"] = max(
                        avg_step - sum(shared.values()), 0.0)
                f.write(report_row(cfg, args.steps, avg_step, phases)
                        + "\n")
                f.flush()

            samples = []
            for _ in range(max(args.repeat, 2)):
                t0 = time.perf_counter()
                run()
                samples.append((time.perf_counter() - t0) / args.steps)
                if args.repeat > 1:
                    # variance mode: one RAW row per run
                    emit(samples[-1])
            if args.repeat > 1:
                m = sum(samples) / len(samples)
                sd = (sum((s - m) ** 2 for s in samples)
                      / max(len(samples) - 1, 1)) ** 0.5
                print(f"[{i + 1}/{len(cfgs)}] anchor "
                      f"sigma={cfg.sigma:.3f} stim={cfg.stim_strength:g}: "
                      f"n={len(samples)} mean={m*1e3:.3f} ms/step "
                      f"sd={sd*1e3:.3f} CoV={sd/m*100:.2f}% "
                      f"min={min(samples)*1e3:.3f} "
                      f"max={max(samples)*1e3:.3f} "
                      f"(reference files: CoV 1.4% / 1.5%)", flush=True)
                continue
            avg_step = min(samples)
            emit(avg_step)
            print(f"[{i + 1}/{len(cfgs)}] K={cfg.k_stiffness} "
                  f"a={cfg.sm_alpha} b={cfg.sm_beta} mu={cfg.mu_viscosity} "
                  f"sigma={cfg.sigma:.3f} stim={cfg.stim_strength:g}: "
                  f"{avg_step*1e3:.2f} ms/step "
                  f"(warm-up {warm_s:.1f}s)", flush=True)
    print(f"campaign -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

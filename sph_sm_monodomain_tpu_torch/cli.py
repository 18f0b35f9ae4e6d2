"""Command-line driver of the PyTorch port (mirror of
`sph_sm_monodomain_tpu.cli`): the headless replacement for the reference's
GLUT app (main.cpp).

Replays the reference experiment protocol (500 steps, stim off at half,
main.cpp:73, 329-334) with the JAX package's flags, defaults and messages:
physics overrides, PNG frame rendering, a timing row in the reference's
print_report schema (cpp:785-792), checkpoint save/resume, a control file
and a binary trajectory. `--device` (default cuda) picks the card; a run
asks for the CPU with `--device cpu` and never falls back to it.

On the card each mode runs the fused kernels (coupled: the v4 sweeps
through run_protocol; monodomain: the Laplacian sweep; sph: the fused SPH
sweeps). On the CPU each mode runs the unfused path, which the JAX package
runs off the TPU, so a CPU run compares with the JAX package's.

Multi-device runs (`--devices N`, `--parallel gather|fused|halo`, coupled
mode): the command starts N ranks itself (one process each, on this host),
or, started by `torchrun`, joins the ranks it was given. On the CPU the
ranks talk gloo; on the card NCCL where every rank has a card of its own,
else gloo through host copies (ranks sharing one card); the run prints the
transport. `auto` takes the fused slab path on the card and the unfused
all-gather path on the CPU. Rank 0 prints, writes the trajectory, frames,
report and checkpoint; a halo run's state is compacted back to a dense
single-device state first, so its checkpoint resumes on one device.

Usage examples:
  python -m sph_sm_monodomain_tpu_torch --scene biceps_full --steps 500
  python -m sph_sm_monodomain_tpu_torch --scene susane --mode sph \\
      --steps 300 --report out.csv --device cpu
  python -m sph_sm_monodomain_tpu_torch --scene biceps_full --devices 2 \\
      --parallel halo
  torchrun --nproc-per-node 4 -m sph_sm_monodomain_tpu_torch \\
      --scene biceps_full --devices 4
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sph_sm_monodomain_tpu_torch",
        description="PyTorch + CUDA coupled SPH + shape matching + "
                    "monodomain muscle simulation")
    p.add_argument("--scene", default="biceps_18475",
                   help="scene name (biceps_18475, biceps_4944, cube, "
                        "susane, rectus_femoris, ...)")
    p.add_argument("--mode", default="coupled",
                   choices=["coupled", "sph", "sm", "monodomain"],
                   help="model variant")
    p.add_argument("--steps", type=int, default=500,
                   help="total steps (reference: 500, main.cpp:73)")
    p.add_argument("--stim-off-step", type=int, default=None,
                   help="turnOffStim before this step (default steps//2, "
                        "main.cpp:329); -1 disables")
    p.add_argument("--replicate", type=int, default=1,
                   help="tile the cloud k times along x (multi-muscle)")
    p.add_argument("--chunk", type=int, default=100,
                   help="steps per device dispatch")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu; a CUDA "
                        "device torch cannot see is an error")
    # physics overrides (the ~30 constants of the reference ctor)
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   help="override any SimConfig field, e.g. --set "
                        "mu_viscosity=50 --set quadratic_match=true")
    p.add_argument("--dynamic-set", action="append", default=[],
                   metavar="K=V",
                   help="override a physics constant as a runtime tensor "
                        "value (config.PARAM_FIELDS), e.g. --dynamic-set "
                        "mu_viscosity=50 — unlike --set, the value reaches "
                        "the kernels as an operand (the v4 sweeps' "
                        "physics-constant vector); coupled + monodomain "
                        "modes")
    p.add_argument("--corrected-physics", action="store_true",
                   help="disable the reference's quirks "
                        "(strict_reference_mode off)")
    # outputs
    p.add_argument("--report", default=None,
                   help="append a print_report-schema CSV row to this file")
    p.add_argument("--profile-phases", action="store_true",
                   help="measure per-phase timings for the report "
                        "(slower: times each phase separately)")
    p.add_argument("--render-every", type=int, default=0,
                   help="render every Nth step to PNG")
    p.add_argument("--render-dir", default="frames")
    p.add_argument("--render-mode", default="displacement",
                   choices=["displacement", "voltage"])
    p.add_argument("--vrange", default=None, metavar="LO,HI",
                   help="voltage colormap range for --render-mode voltage "
                        "(default: the reference's [-200, 200], which is "
                        "nearly flat over an FHN wave — try 0,15)")
    p.add_argument("--world-box", action="store_true",
                   help="draw the reference display()'s world wireframe "
                        "cube + origin axes in rendered frames")
    p.add_argument("--render-live", default=None, metavar="PATH.png",
                   help="re-render the CURRENT state to this one file "
                        "between chunks — the headless stand-in for "
                        "watching the reference's GLUT window during a "
                        "long run (main.cpp:318-352)")
    p.add_argument("--gif", default=None, metavar="PATH.gif",
                   help="with --render-every: also assemble the rendered "
                        "frames into one animated GIF")
    p.add_argument("--save-checkpoint", default=None, metavar="PATH.npz")
    p.add_argument("--load-checkpoint", default=None, metavar="PATH.npz")
    p.add_argument("--traj", default=None, metavar="PATH.bin",
                   help="stream per-chunk [pos3, vm] frames to a binary "
                        "trajectory file (native async writer)")
    p.add_argument("--devices", type=int, default=1,
                   help=">1: shard particles over N ranks (coupled mode), "
                        "one process each, started here unless a launcher "
                        "such as torchrun started them")
    p.add_argument("--control", default=None, metavar="PATH",
                   help="runtime control file, polled between chunks — the "
                        "headless equivalent of the reference's keyboard "
                        "handler (main.cpp:393-408). Write one command per "
                        "line: pause | resume | stim-off | save <ckpt.npz> "
                        "| stop. The file is append-only and consumed by "
                        "offset; while paused it is re-polled until "
                        "'resume' or 'stop' arrives. Use --chunk to set "
                        "the control granularity in steps.")
    p.add_argument("--pause-at", type=int, action="append", default=[],
                   metavar="STEP", help="pause when reaching this global "
                        "step (repeatable); resume via the --control file")
    p.add_argument("--parallel", default="auto",
                   choices=["auto", "gather", "fused", "halo"],
                   help="multi-device strategy with --devices>1: "
                        "'gather' = all-gather + unfused step, 'fused' = "
                        "all-gather + the v4 sweep kernels on each rank's "
                        "slab of sorted rows, 'halo' = slab ownership with "
                        "boundary-plane exchange and migration; 'auto' = "
                        "fused on the card, gather on the CPU")
    return p


class RunController:
    """Headless runtime control (the reference's interactive keys).

    The reference handles SPACE (pause), 'q' (turnOffStim) and ESC (exit)
    in its GLUT keyboard callback (main.cpp:393-408). This replacement
    polls a command file between chunks: `pause`, `resume`, `stim-off`,
    `save <path.npz>`, `stop` — one per line; the file is consumed by
    offset after each poll. Returns the command dict consumed by
    run_protocol's callback contract."""

    def __init__(self, path: str | None, pause_steps=(), save_fn=None,
                 poll_s: float = 0.3):
        self.path = path
        self.pause_steps = sorted(set(pause_steps))
        self.save_fn = save_fn
        self.poll_s = poll_s
        self.paused = False
        self.stopped = False
        self._pos = 0            # bytes of the control file consumed so far
        self._done = 0           # steps executed (forwarded to save_fn)

    def _drain(self, state):
        """Read NEW lines of the control file; apply local commands.

        The file is treated as append-only and consumed by offset (no
        truncation): truncating raced with a concurrent `echo cmd >> file`
        and could silently discard the command. If the user recreates or
        shrinks the file, consumption restarts from its beginning."""
        import os
        cmd = {}
        if not self.path or not os.path.exists(self.path):
            return cmd
        try:
            if os.path.getsize(self.path) < self._pos:
                self._pos = 0
            with open(self.path, "r") as f:
                f.seek(self._pos)
                data = f.read()
                self._pos += len(data)
            lines = [ln.strip() for ln in data.splitlines()]
        except OSError:
            return cmd
        for ln in lines:
            if not ln:
                continue
            if ln == "pause":
                self.paused = True
            elif ln == "resume":
                self.paused = False
            elif ln == "stim-off":
                cmd["stim_off"] = True
            elif ln == "stop":
                self.stopped = True
                self.paused = False
            elif ln.startswith("save ") and self.save_fn is not None:
                self.save_fn(ln[5:].strip(), state, self._done)
            else:
                print(f"control: ignoring unknown command {ln!r}",
                      file=sys.stderr)
        return cmd

    def __call__(self, done, state):
        self._done = done
        while self.pause_steps and done >= self.pause_steps[0]:
            self.pause_steps.pop(0)
            self.paused = True
        cmd = self._drain(state)
        if self.paused:
            print(f"paused at step {done} (write 'resume' or 'stop' to "
                  f"{self.path})", flush=True)
        while self.paused and not self.stopped:
            time.sleep(self.poll_s)
            cmd.update(self._drain(state))
        if self.stopped:
            cmd["stop"] = True
            print(f"control: stop at step {done}", flush=True)
        return cmd


def _apply_overrides(cfg, pairs):
    import dataclasses
    fields = {f.name: f.type for f in dataclasses.fields(cfg)}
    kw = {}
    for pair in pairs:
        k, _, v = pair.partition("=")
        if k not in fields:
            sys.exit(f"unknown config field {k!r}; have {sorted(fields)}")
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            kw[k] = v.lower() in ("1", "true", "yes", "on")
        elif isinstance(cur, int):
            kw[k] = int(v)
        elif isinstance(cur, float):
            kw[k] = float(v)
        elif isinstance(cur, tuple):
            kw[k] = tuple(float(x) for x in v.split(","))
        else:
            kw[k] = v
    return cfg.replace(**kw) if kw else cfg


def _host(x):
    return x.detach().cpu().numpy()


def _rank_main(comm, argv):
    """One rank of a multi-device run started by `main` (comm.spawn)."""
    rc = _run(build_parser().parse_args(argv), comm)
    if rc:
        raise RuntimeError(f"rank {comm.rank} ended with exit code {rc}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    multi = args.devices > 1
    if multi and args.mode != "coupled":
        sys.exit(f"--devices only supports --mode coupled "
                 f"(got --mode {args.mode})")
    if multi and args.parallel == "halo" and args.dynamic_set:
        sys.exit("--dynamic-set is not supported with --parallel halo "
                 "(as in the JAX package's command line; use gather/fused)")
    from .parallel import comm as comm_mod
    if comm_mod.launched_by_env():
        # started by a launcher (torchrun): join the ranks it was given
        from .state import resolve_device
        try:
            dev_type = resolve_device(args.device).type
        except RuntimeError as e:
            sys.exit(f"{e} (--device cpu)")
        comm = comm_mod.init_from_env(dev_type)
        try:
            if args.devices not in (1, comm.size):
                sys.exit(f"--devices {args.devices} but the launcher "
                         f"started {comm.size} ranks")
            return _run(args, comm if comm.size > 1 else None)
        finally:
            comm_mod.shutdown()
    if not multi:
        return _run(args, None)
    from .state import resolve_device
    try:
        dev_type = resolve_device(args.device).type
    except RuntimeError as e:
        sys.exit(f"{e} (--device cpu)")
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        comm_mod.spawn(_rank_main, args.devices, (argv,),
                       device_type=dev_type)
    except Exception as e:  # a rank failed: the others were ended
        sys.exit(f"multi-device run failed: {e}")
    return 0


def _run(args, comm) -> int:
    """The run itself, in one process (`comm` None) or as one rank of a
    multi-device run (rank 0 prints and writes the outputs)."""
    import numpy as np
    import torch
    from .config import SimConfig
    from .state import (FIELD_NAMES, load_checkpoint, resolve_device,
                        save_checkpoint)
    from .utils.io import build_scene
    from .utils import render as render_mod
    from .utils.report import (profile_phases, profile_phases_fused,
                               report_row, REPORT_HEADER)
    from .models import variants
    from .models.monodomain import run_protocol

    lead = comm is None or comm.rank == 0
    say = print if lead else (lambda *a, **k: None)
    if comm is not None:
        device = comm.device
    else:
        try:
            device = resolve_device(args.device)
        except RuntimeError as e:
            sys.exit(f"{e} (--device cpu)")
    on_card = device.type == "cuda"

    cfg = SimConfig()
    if args.corrected_physics:
        cfg = cfg.replace(strict_reference_mode=False,
                          quirk_double_self_density=False,
                          quirk_pressure_stim_gate=False,
                          quirk_iion_accumulate=False,
                          quirk_stim_radius_squared=False)
    if args.mode == "sph":
        cfg = variants.sph_only_config(cfg)
    cfg = _apply_overrides(cfg, args.set)

    params = None
    if args.dynamic_set:
        from .config import PARAM_FIELDS
        params = {}
        for kv in args.dynamic_set:
            k, sep, v = kv.partition("=")
            if not sep:
                sys.exit(f"--dynamic-set {kv!r}: expected K=V")
            if k not in PARAM_FIELDS:
                sys.exit(f"--dynamic-set {k}: not a dynamic field (choose "
                         f"from {sorted(PARAM_FIELDS)}; use --set for "
                         "static/geometry fields)")
            params[k] = float(v)
        if args.mode not in ("coupled", "monodomain"):
            sys.exit(f"--dynamic-set supports --mode coupled/monodomain "
                     f"(got --mode {args.mode})")

    def effective_cfg(c):
        """Config with the --dynamic-set values applied (plain floats):
        anything PERSISTED (checkpoints, report rows) must record the
        physics that actually ran, not the static defaults — a resume
        trusts the checkpoint's config snapshot as authoritative."""
        from .config import resolve_params
        return resolve_params(c, params) if params else c

    pad_to = None
    # the --parallel strategy ('auto': the fused slab path on the card,
    # the unfused all-gather path on the CPU)
    impl = None
    if comm is not None:
        impl = (args.parallel if args.parallel != "auto"
                else "fused" if on_card else "gather")
    if comm is not None:
        import math
        from .state import PAD_MULTIPLE
        # the capacity must divide evenly over the ranks
        probe = build_scene(args.scene, cfg, replicate=args.replicate,
                            stim=False, device="cpu")
        d = comm.size
        lcm = (PAD_MULTIPLE * d) // math.gcd(PAD_MULTIPLE, d)
        if args.parallel in ("auto", "fused"):
            # fused slabs: every rank owns whole sub-blocks of sorted rows
            lcm = max(lcm, d * (probe.sub_block or 128))
        pad_to = -(-probe.state.capacity // lcm) * lcm
    scene = build_scene(args.scene, cfg, replicate=args.replicate,
                        stim=args.mode in ("coupled", "monodomain"),
                        pad_to=pad_to, device=device)
    cfg = scene.cfg
    state = scene.state
    start_step = 0
    if args.load_checkpoint:
        state, start_step, ckpt_cfg = load_checkpoint(
            args.load_checkpoint, with_config=True, device=device)
        say(f"resumed from {args.load_checkpoint} at step {start_step}")
        if ckpt_cfg is not None:
            # the checkpoint's config snapshot is authoritative for the
            # physics (resume correctness must not depend on the user
            # re-passing identical flags); explicit --set overrides still
            # apply on top
            import dataclasses as _dc
            diffs = [f.name for f in _dc.fields(ckpt_cfg)
                     if getattr(ckpt_cfg, f.name) != getattr(cfg, f.name)]
            if diffs:
                say("config restored from checkpoint (overrides flag "
                    f"defaults for: {', '.join(diffs)})")
            cfg = _apply_overrides(ckpt_cfg, args.set)
            scene = scene._replace(cfg=cfg)
        if cfg.sm_tile_rows > 0:
            # the contig segment form assumes tile k owns rows
            # [k*R, (k+1)*R); a checkpoint of a row-migrating run (the
            # halo path) breaks that: verify on the host and fall back to
            # the order-insensitive forms if the layout doesn't hold
            k, r_rows = cfg.sm_clusters, cfg.sm_tile_rows
            tile_w = cfg.world_size[0] / k
            got = np.floor(_host(state.orig_pos[:k * r_rows, 0])
                           / tile_w).clip(0, k - 1).astype(int)
            want = np.repeat(np.arange(k), r_rows)
            if got.shape != want.shape or (got != want).any():
                say("checkpoint rows are not tile-contiguous; using the "
                    "order-insensitive clustered-SM forms")
                cfg = cfg.replace(sm_tile_rows=0)
                scene = scene._replace(cfg=cfg)
    stim_off = (args.steps // 2 if args.stim_off_step is None
                else args.stim_off_step)
    if args.mode != "coupled" and args.stim_off_step is not None:
        sys.exit(f"--stim-off-step only applies to --mode coupled; "
                 f"the {args.mode} variant has no stim-off protocol")
    if args.load_checkpoint and start_step:
        # resume protocol: run only the REMAINING steps and map the
        # stim-off event into the remaining window (or skip it if the
        # saved run already passed it)
        remaining = max(0, args.steps - start_step)
        stim_off = stim_off - start_step if stim_off >= start_step else -1
        say(f"protocol: {remaining} steps remain of {args.steps}; "
            f"stim-off {'at step ' + str(stim_off + start_step)
                        if stim_off >= 0 else 'already fired'}")
        args.steps = remaining
    say(f"scene={scene.name} n={scene.num_particles} "
        f"capacity={state.capacity} cell_cap={scene.cell_capacity} "
        f"nbr_cap={scene.neighbor_capacity} mode={args.mode} "
        f"device={device}")

    frames = []
    render_every = args.render_every
    traj_writer = None
    if args.traj and lead:
        from .runtime import TrajectoryWriter
        traj_writer = TrajectoryWriter(args.traj, scene.num_particles,
                                       fields=4)

    vrange = (tuple(float(x) for x in args.vrange.split(","))
              if args.vrange else None)

    def stream_frame(i, st):
        if traj_writer is not None:
            n_act = scene.num_particles
            payload = np.concatenate(
                [_host(st.pos)[:n_act], _host(st.vm)[:n_act, None]], axis=1)
            traj_writer.append(i, payload)
        if args.render_live:
            # one-file live view, atomically replaced so a watcher never
            # reads a half-written image
            import os
            img = render_mod.render_points(st, cfg, mode=args.render_mode,
                                           vrange=vrange,
                                           world_box=args.world_box)
            tmp = render_mod.save_png(args.render_live + ".tmp.png", img)
            target = args.render_live
            if tmp.endswith(".ppm"):
                # no-PIL fallback wrote raw PPM: keep the live file's
                # extension honest so viewers can decode it
                target = args.render_live.rsplit(".", 1)[0] + ".ppm"
                if not getattr(stream_frame, "_warned_ppm", False):
                    stream_frame._warned_ppm = True
                    print(f"no PIL: live view -> {target} (raw PPM)",
                          flush=True)
            os.replace(tmp, target)

    if comm is not None:
        from .parallel import halo_step as HS
        from .parallel import sharded_step as SS

        def full_state(st, allow_loss=True):
            """Every rank's rows as one dense state (a collective): the
            halo layout compacted back to rows [0, n)."""
            full = SS.gather_state(st, comm)
            if impl != "halo":
                return full
            return HS.unshard_state_halo(full, scene.num_particles, cfg,
                                         allow_loss=allow_loss)

    controller = None
    pending_saves = []
    if args.control or args.pause_at:
        if args.pause_at and not args.control:
            sys.exit("--pause-at needs --control (there is no other way "
                     "to resume a headless run)")

        def _save(path, st, done):
            if comm is not None:
                # a collective: every rank gathers after the broadcast
                pending_saves.append((path, done))
                return
            # record the GLOBAL step so a resume maps the protocol
            # correctly; the cfg snapshot carries any --dynamic-set values
            # (resume trusts it)
            save_checkpoint(path, st, step=start_step + done,
                            cfg=effective_cfg(cfg))
            print(f"control: checkpoint (step {start_step + done}) -> "
                  f"{path}", flush=True)
        if lead:
            controller = RunController(args.control, args.pause_at,
                                       save_fn=_save)

    def control(done, st):
        """The controller's command on every rank (rank 0 reads the
        control file, the others receive its command and saves)."""
        if comm is None:
            return controller(done, st) if controller is not None else {}
        cmd = controller(done, st) if controller is not None else {}
        cmd, saves = comm.broadcast_object((cmd, list(pending_saves)))
        pending_saves.clear()
        for path, at in saves:
            try:
                full = full_state(st, allow_loss=False)
            except ValueError as e:    # lossy: refuse, keep running
                say(f"control: NOT saving checkpoint: {e}", file=sys.stderr,
                    flush=True)
                continue
            if lead:
                save_checkpoint(path, full, step=start_step + at,
                                cfg=effective_cfg(cfg))
                print(f"control: checkpoint (step {start_step + at}) -> "
                      f"{path}", flush=True)
        return cmd

    has_control = args.control or args.pause_at
    t0 = time.time()
    executed = {"steps": 0}   # actual steps run (early stop may cut short)
    # every mode runs its chunked driver (never a per-step host read);
    # when rendering, the chunk size shrinks to the render interval so a
    # frame is captured every render_every steps
    var_chunk = (min(args.chunk, render_every) if render_every
                 else args.chunk)
    sub_q = scene.sub_block or 128
    if args.mode == "monodomain":
        fused = on_card
        if fused:
            # the Laplacian-only sweep on the scene's v4 windows
            ftab = variants.monodomain_prepare_fused(state, cfg, sub_q=sub_q)
        else:
            tables = variants.monodomain_prepare(state, cfg,
                                                 scene.neighbor_capacity)
        done = 0
        while done < args.steps:
            n_chunk = min(var_chunk, args.steps - done)
            if fused:
                state = variants.simulate_monodomain_only_fused(
                    state, ftab, cfg, num_steps=n_chunk, sub_q=sub_q,
                    params=params)
            else:
                state = variants.simulate_monodomain_only(
                    state, tables, cfg, num_steps=n_chunk, params=params)
            done += n_chunk
            executed["steps"] = done
            stream_frame(done, state)
            if render_every:
                frames.append((done, state))
            if controller is not None:
                cmd = controller(done, state)
                if cmd.get("stim_off"):
                    # the monodomain variant has a live stimulus: honor the
                    # control-file 'q' like the coupled path
                    from .ops.electrophysiology import turn_off_stim
                    state = turn_off_stim(state, cfg)
                if cmd.get("stop"):
                    break
        overflow = 0
    elif args.mode in ("sph", "sm"):
        fused = args.mode == "sph" and on_card
        overflow = 0
        done = 0
        while done < args.steps:
            n_chunk = min(var_chunk, args.steps - done)
            if args.mode == "sph":
                state, aux = variants.simulate_sph_only(
                    state, cfg, scene.neighbor_capacity, num_steps=n_chunk,
                    fused=fused, sub_q=sub_q)
            else:
                state, aux = variants.simulate_sm_only(state, cfg,
                                                       num_steps=n_chunk)
            overflow = max(overflow, int(aux.overflow))
            done += n_chunk
            executed["steps"] = done
            stream_frame(done, state)
            if render_every:
                frames.append((done, state))
            if controller is not None:
                cmd = controller(done, state)
                if cmd.get("stim_off"):
                    print(f"control: 'stim-off' has no effect in --mode "
                          f"{args.mode} (no electrophysiology)",
                          file=sys.stderr, flush=True)
                if cmd.get("stop"):
                    break
    elif comm is not None:
        from .ops.electrophysiology import turn_off_stim
        if impl == "halo":
            # each rank's slab capacity aligns to the scene's sub-blocks
            sharded, _s_cap, mig_cap, halo_cap = HS.shard_state_halo(
                state, comm, cfg, q_block=sub_q)

            def get_sim(n_chunk, off):
                return HS.make_halo_simulate(
                    comm, cfg, mig_cap, halo_cap, num_steps=n_chunk,
                    stim_off_step=off, sub_q=sub_q)
        else:
            sharded = SS.shard_state(state, comm)

            def get_sim(n_chunk, off):
                if impl == "fused":
                    return SS.make_sharded_simulate_fused(
                        comm, cfg, num_steps=n_chunk, stim_off_step=off,
                        sub_q=sub_q)
                return SS.make_sharded_simulate(
                    comm, cfg, scene.neighbor_capacity, num_steps=n_chunk,
                    stim_off_step=off)

        say(f"parallel impl: {impl} over {comm.size} devices, "
            f"{comm.describe()}, run loop {SS.run_loop(comm)[1]}",
            flush=True)
        overflow = 0
        done = 0
        while done < args.steps:
            n_chunk = min(args.chunk, args.steps - done)
            off = (stim_off - done
                   if done <= stim_off < done + n_chunk else -1)
            sim_fn = get_sim(n_chunk, off)
            sharded, ovf = sim_fn(sharded, params)
            overflow = max(overflow, int(ovf))
            done += n_chunk
            executed["steps"] = done
            if traj_writer is not None or render_every or args.render_live:
                # the outputs read a dense [0, n) state: gather (and, on
                # the halo path, compact) once a chunk
                view = full_state(sharded)
                if lead:
                    stream_frame(done, view)
                    if render_every:
                        frames.append((done, view))
            if has_control:
                cmd = control(done, sharded)
                if cmd.get("stim_off"):
                    sharded = turn_off_stim(sharded, cfg)
                    stim_off = -1
                if cmd.get("stop"):
                    break
        state = sharded
    else:
        scene = scene._replace(state=state)

        def cb(done, st):
            executed["steps"] = done
            if render_every:
                # the frames are rendered after the run: each keeps a
                # host copy
                frames.append((done, st.replace(**{
                    f: getattr(st, f).to("cpu", copy=True)
                    for f in FIELD_NAMES})))
            stream_frame(done, st)
            if controller is not None:
                return controller(done, st)
        state, aux, _ = run_protocol(
            scene, num_steps=args.steps, stim_off_step=stim_off,
            chunk=(min(args.chunk, max(render_every, 1)) if render_every
                   else args.chunk),
            callback=cb, fused=on_card, params=params)
        overflow = int(aux.overflow)
    if on_card:
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    steps_run = executed["steps"] or args.steps
    avg_step = wall / max(steps_run, 1)
    say(f"{steps_run} steps in {wall:.2f}s ({avg_step*1e3:.2f} ms/step, "
        f"incl. first-call builds), overflow={overflow}")
    if overflow:
        say("WARNING: neighbor-table overflow detected — rebuild the "
            "scene with larger cell/neighbor capacities for exact physics",
            file=sys.stderr)

    n = scene.num_particles
    if comm is not None:
        full = SS.gather_state(state, comm)
        # a halo layout holds its particles among padding rows: select by
        # the mask, not a row range
        keep = (_host(full.active) if impl == "halo"
                else np.arange(full.capacity) < n)
        disp = _host(full.displacement())[keep]
        vm = _host(full.vm)[keep]
    else:
        disp = _host(state.displacement())[:n]
        vm = _host(state.vm)[:n]
    say(f"displacement mean={disp.mean():.4f} max={disp.max():.4f} | "
        f"Vm [{vm.min():.2f}, {vm.max():.2f}]")

    if traj_writer is not None:
        written = traj_writer.close()
        print(f"trajectory ({written} frames) -> {args.traj}")

    exit_code = 0
    if args.save_checkpoint:
        ckpt_state = state
        if comm is not None:
            try:
                ckpt_state = (HS.unshard_state_halo(full, n, cfg)
                              if impl == "halo" else full)
            except ValueError as e:    # lossy state: refuse to persist it
                say(f"NOT writing checkpoint: {e}", file=sys.stderr,
                    flush=True)
                ckpt_state, exit_code = None, 1
        if ckpt_state is not None and lead:
            # accumulated step count: resumed steps + steps ACTUALLY
            # executed this run (an early `stop` must not claim
            # unexecuted steps)
            save_checkpoint(args.save_checkpoint, ckpt_state,
                            step=start_step + steps_run,
                            cfg=effective_cfg(cfg))
            print(f"checkpoint -> {args.save_checkpoint}")

    if render_every and lead:
        states = [s for _, s in frames]
        paths = render_mod.render_frames(
            states, cfg, args.render_dir,
            stim_off_step=(stim_off // max(render_every, 1)
                           if stim_off >= 0 else -1),
            mode=args.render_mode, vrange=vrange,
            world_box=args.world_box)
        print(f"{len(paths)} frames -> {args.render_dir}/")
        if args.gif and paths:
            from .utils.animate import read_png_rgb, write_gif
            write_gif(args.gif, [read_png_rgb(p) for p in paths], fps=15)
            print(f"animation -> {args.gif}")

    if args.report and lead:
        phases = {}
        if args.profile_phases:
            # profile the path that actually ran: the fused kernels on the
            # card, the unfused phases on the CPU
            if on_card and args.mode == "coupled":
                phases = profile_phases_fused(scene._replace(cfg=cfg))
                # raw incremental-pipeline times next to the clamped
                # attribution: a negative delta shows up here instead of
                # vanishing into a zero
                t1, t2, t3, t4 = phases["raw_pipeline_s"]
                attr = t1 + max(t2 - t1, 0) + max(t3 - t2, 0) \
                    + max(t4 - t3, 0)
                print(f"profile raw pipelines (ms): book={t1*1e3:.3f} "
                      f"+sm={t2*1e3:.3f} +sweepA={t3*1e3:.3f} "
                      f"full={t4*1e3:.3f}; attributed sum "
                      f"{attr*1e3:.3f} vs total {t4*1e3:.3f} "
                      f"({(attr/t4 - 1)*100:+.1f}%)")
            elif on_card and args.mode == "monodomain":
                from .utils.report import profile_phases_monodomain_fused
                phases = profile_phases_monodomain_fused(
                    scene._replace(cfg=cfg))
            elif on_card and args.mode == "sph":
                from .utils.report import profile_phases_sph_fused
                phases = profile_phases_sph_fused(scene._replace(cfg=cfg))
            else:
                if args.mode in ("sph", "sm"):
                    print("note: --profile-phases times the unfused "
                          f"COUPLED phases; --mode {args.mode} runs a "
                          "subset (its extra columns are upper-bound "
                          "estimates)", file=sys.stderr, flush=True)
                phases = profile_phases(scene.state, cfg,
                                        scene.neighbor_capacity)
        # prefer the profiled step time over the wall average (which
        # includes first-call builds and launch latency); the row's
        # parameter columns record the EFFECTIVE values
        row = report_row(effective_cfg(cfg), steps_run,
                         phases.get("total_step", avg_step), phases)
        import os
        write_header = not os.path.exists(args.report)
        with open(args.report, "a") as f:
            if write_header:
                f.write(REPORT_HEADER + "\n")
            f.write(row + "\n")
        print(f"report row -> {args.report}")
    return exit_code


if __name__ == "__main__":
    sys.exit(main())

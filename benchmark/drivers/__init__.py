"""The traffic drivers. A traffic mix's file names its driver
(`"driver": "<name>"` runs `benchmark.drivers.<name>`), whose `Job` builds
the cell's system under test from the configuration and the seed, runs one
unit of work at a time, measures for the traced run, and checks what the
timed path produced against the plain reference."""

from __future__ import annotations

import torch

from .. import flops, trace
from ..common import cloud, sync, vm_field
from ..reference import physics as ref

WALL_REPS = 3
# the reference's keys -> the package's ParticleState fields
PROG = {"pos": "pos", "vel": "vel", "pv": "predicted_vel",
        "cv": "corrected_vel", "iv": "inter_vel", "orig": "orig_pos",
        "goal": "goal_pos", "mass": "mass", "dens": "dens", "pres": "pres",
        "vm": "vm", "inter_vm": "inter_vm", "iion": "iion", "stim": "stim",
        "w": "w", "fixed": "fixed"}


def check_scene(sc, conf: dict) -> None:
    """The package's scene is the configuration: its size, clusters,
    generation and every physics constant the file states."""
    cfg = sc.cfg
    got = {"particles": sc.num_particles, "clusters": cfg.sm_clusters,
           "fused_impl": sc.fused_impl}
    bad = {k: v for k, v in got.items() if v != conf[k]}
    for k, v in conf["physics"].items():
        have = getattr(cfg, k)
        if (list(have) if isinstance(have, tuple) else have) != v:
            bad[k] = have
    if bad:
        raise RuntimeError(f"the package's scene differs from the "
                           f"configuration: {bad}")


class Job:
    """One run of one cell. Subclasses define `setup`, `unit` (one unit
    of work ending in a host fetch; returns the work it completed),
    `readings` (every number the check can compare, by name) and `control`
    (the same numbers of the lower-precision reference in the program's
    place), and for the traced run what they can measure; a measurement a
    cell cannot take returns None."""

    def __init__(self, conf: dict, traffic: dict, checks: dict, seed: int,
                 device):
        self.conf, self.traffic, self.checks = conf, traffic, checks
        self.seed, self.device = seed, device
        self.window = None      # (work, steps, seconds) of the window
        self._traced = None

    def build(self) -> None:
        """The package's scene of the configuration (its public
        `build_scene`, which stimulates the cloud and fixes its anchors),
        held to the configuration and to the benchmark's own cloud, with
        the seeded vm on its live rows: `sc`, `n`, `pts`, `vm0`."""
        from sph_sm_monodomain_tpu_torch.utils.io import build_scene
        c = self.conf
        sc = build_scene(c["scene"], replicate=c["replicate"],
                         fused_impl=c["fused_impl"], device=self.device)
        check_scene(sc, c)
        self.n = n = c["particles"]
        self.pts = torch.from_numpy(cloud(c)).to(self.device)
        if not torch.equal(sc.state.pos[:n], self.pts):
            raise RuntimeError("the package's cloud is not the "
                               "configuration's")
        self.vm0 = vm_field(n, self.seed, self.device)
        vm = sc.state.vm.clone()
        vm[:n] = self.vm0
        self.sc = sc._replace(state=sc.state.replace(vm=vm))

    def reference_start(self, dtype=torch.float64):
        """(constants, initial state) of the reference, worked out from the
        benchmark's own cloud and seeded vm."""
        P = ref.Physics(self.conf["physics"])
        return P, ref.initial_state(self.pts, self.vm0, P,
                                    self.conf["clusters"], dtype)

    def start_mismatch(self, r0: dict) -> int:
        """Elements of the program's initial state, live rows, that differ
        from the reference's (exactly, in float32)."""
        bad = 0
        for k, f in PROG.items():
            want = r0[k] if k == "fixed" else r0[k].float()
            bad += int((getattr(self.sc.state, f)[:self.n] != want).sum())
        return bad

    def check(self) -> list:
        """[(name, value, limit)] of the readings the cell's check file
        gives a limit."""
        lim = self.checks["limits"]
        return [(k, v, lim[k]) for k, v in self.readings().items()
                if k in lim]

    # --- the traced run -------------------------------------------------
    def stage_ms(self, stage: str):
        return None

    def kernel_roofline(self, kernel: str):
        """The kernel's share of its roofline, in %: the least time over
        the measured time of a launch at the cell's own inputs."""
        got = self.kernel_inputs(kernel)
        if got is None:
            return None
        launch, counts, rows = got
        # launches captured at once: each keeps its (rows, 16) float32
        # output in the graph's pool, so at most ~1 GiB of them
        count = max(20, min(200, (1 << 30) // (rows * 64)))
        secs = trace.kernel_seconds(launch, self.device, count)
        return 100.0 * flops.least_seconds(kernel, counts, rows) / secs

    def kernel_inputs(self, kernel: str):
        """(launch, pair counts, padded rows) of a kernel the cell runs."""
        return None

    def flops_per_step(self, kind: str):
        """Counted operations of one step of the window's work."""
        return None

    def step_mfu(self, kind: str):
        """The window's counted operations over its wall, as a share (%) of
        the float32 peak."""
        f = self.flops_per_step(kind)
        if f is None or self.window is None:
            return None
        _, steps, secs = self.window
        return 100.0 * f * steps / secs / flops.PEAK_FLOPS

    def trace_stretch(self):
        """(run, steps): a stretch of the cell's own work to profile."""
        return None

    def traced(self):
        """The profiled stretch (trace.profile) with `wall_s`, the median of
        WALL_REPS CUDA-event walls of the same stretch unprofiled, and its
        step count."""
        if self._traced is None:
            got = self.trace_stretch()
            if got is None:
                return None
            run, steps = got
            run()
            sync(self.device)
            walls = sorted(trace.event_wall(run, self.device)
                           for _ in range(WALL_REPS))
            self._traced = dict(trace.profile(run, self.device),
                                wall_s=walls[WALL_REPS // 2], walls=walls,
                                steps=steps)
        return self._traced

    def idle_share(self):
        """1 - the profiled union of device intervals over the unprofiled
        wall of the same steps, in %."""
        t = self.traced()
        if t is None:
            return None
        return 100.0 * (1.0 - t["busy_s"] / t["wall_s"])

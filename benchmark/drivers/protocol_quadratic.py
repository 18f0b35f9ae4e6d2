"""The reference application's protocol (drivers/protocol.py) on a scene
whose configuration switches quadratic shape matching on (the app's
`quadraticMatch`): the same units of work, digests, replay and eager checks,
start and turnOffStim checks and traced unit, with these differences:
- the scene's config is the package's PortConfig, its defaults with the
  configuration's SWITCHES, so check_scene still holds every other
  constant to the package's defaults (a package without PortConfig cannot
  run the cell, and the run fails at once);
- the reference the program is followed with is reference/quadratic.py
  (its own step, physics.py's everywhere but the goals), in float64, and
  in float32 with TF32 products for the control.
"""

from __future__ import annotations

import torch

from ..common import cloud, vm_field
from ..reference import physics as ref
from ..reference import quadratic as quad
from . import PROG, check_scene
from .protocol import CARRY, gaps
from .protocol import Job as ProtocolJob

# the physics keys the scene is built with (PortConfig fields)
SWITCHES = ("quadratic_match", "jacobi_iterations", "pinv_rotations")


class Job(ProtocolJob):
    def build(self) -> None:
        """drivers.Job.build with the configuration's SWITCHES."""
        from sph_sm_monodomain_tpu_torch.config import PortConfig
        from sph_sm_monodomain_tpu_torch.utils.io import build_scene
        c = self.conf
        cfg = PortConfig().replace(**{k: c["physics"][k] for k in SWITCHES
                                      if k in c["physics"]})
        sc = build_scene(c["scene"], cfg=cfg, replicate=c["replicate"],
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
        P = quad.Physics(self.conf["physics"])
        return P, ref.initial_state(self.pts, self.vm0, P,
                                    self.conf["clusters"], dtype)

    def follow(self, P, r0: dict, control: bool = False) -> dict:
        """protocol.Job.follow with the quadratic reference's step."""
        keep, worst = self.boundaries(), {}
        for b in self.starts():
            sb = keep[b]
            if not control:
                with self._scan.eager():
                    prog = self._run(self.sc._replace(state=sb), num_steps=1,
                                     stim_off_step=-1, chunk=1)[0]
            for lo, hi in self.blocks():
                base = {k: (v[lo:hi] if torch.is_tensor(v) else v)
                        for k, v in r0.items()}
                s64 = dict(base, **{k: getattr(sb, PROG[k])[lo:hi].double()
                                    for k in CARRY})
                want = quad.step(s64, P)
                if control:
                    s32 = {k: (v.float() if torch.is_tensor(v)
                               and v.is_floating_point() else v)
                           for k, v in s64.items()}
                    got = quad.step(s32, P, rnd=ref.tf32)
                else:
                    got = {f: getattr(prog, PROG[f])[lo:hi]
                           for f in ref.FIELDS}
                for f, v in gaps(got, want).items():
                    worst[f] = max(worst.get(f, 0.0), v)
                del want, s64
        return worst

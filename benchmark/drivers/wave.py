"""The frozen-cloud monodomain wave, runs back to back: each unit is one
`steps`-step call of the package's `simulate_monodomain_only_fused` from
the scene's initial state (the FHN reaction and one Laplacian sweep, K3, a
step), over geometry prepared once in set-up; it ends in a host fetch and
completes particles x steps particle-steps.

The cloud never moves, so nothing amplifies a rounding: the float64
reference runs the same `steps` steps from the same inputs, and the first
and the last unit's states are compared with it, with the frozen
densities the geometry was prepared with.
"""

from __future__ import annotations

import torch

from .. import flops
from ..reference import physics as ref
from . import Job as BaseJob

WAVE_FIELDS = ("vm", "w", "iion", "inter_vm")


class Job(BaseJob):
    def setup(self):
        from sph_sm_monodomain_tpu_torch.models import variants
        self.build()
        sc = self.sc
        self.steps = self.traffic["steps"]
        self._variants = variants
        self.tables = variants.monodomain_prepare_fused(sc.state, sc.cfg,
                                                        sc.sub_block)
        self.first = self.last = None
        self.unit()
        self.first = None

    def simulate(self, steps: int):
        return self._variants.simulate_monodomain_only_fused(
            self.sc.state, self.tables, self.sc.cfg, steps,
            sub_q=self.sc.sub_block)

    def unit(self) -> int:
        out = self.simulate(self.steps)
        out.vm[0].item()
        if self.first is None:
            self.first = out
        self.last = out
        return self.n * self.steps

    def readings(self) -> dict:
        n = self.n
        P, r0 = self.reference_start()
        bad = self.start_mismatch(r0)
        want = ref.run_wave(r0, P, self.steps)
        dens = (self.tables.dens[:n].double() - want["dens"]).abs() \
            / want["dens"]
        out = {"start_mismatch": bad, "dens_gap": float(dens.max())}
        for f in WAVE_FIELDS:
            gap = [(getattr(s, f)[:n].double() - want[f]).abs()
                   for s in (self.first, self.last)]
            out[f"{f}_gap"] = max(float(g.max()) for g in gap)
            out[f"{f}_rms"] = max(float(g.square().mean().sqrt()
                                        / want[f].square().mean().sqrt())
                                  for g in gap)
        return out

    def control(self) -> dict:
        P, r0 = self.reference_start()
        want = ref.run_wave(r0, P, self.steps)
        got = ref.run_wave(self.reference_start(torch.float32)[1], P,
                           self.steps, rnd=ref.tf32)
        out = {"dens_gap": float(((got["dens"].double() - want["dens"]).abs()
                                  / want["dens"]).max())}
        for f in WAVE_FIELDS:
            g = (got[f].double() - want[f]).abs()
            out[f"{f}_gap"] = float(g.max())
            out[f"{f}_rms"] = float(g.square().mean().sqrt()
                                    / want[f].square().mean().sqrt())
        return out

    # --- the traced run -------------------------------------------------
    def kernel_inputs(self, kernel: str):
        if kernel != "sweep_lap3":
            return None
        from sph_sm_monodomain_tpu_torch.ops.fused_step import sweep_lap3
        t, cfg, sub_q = self.tables, self.sc.cfg, self.sc.sub_block
        vm_s = self.sc.state.vm[t.order]
        qm, feats = self._variants._lap_inputs(vm_s, t.vol_s, vm_s, t.pos_s,
                                               t.cx_s, t.cyz_s)

        def launch():
            return sweep_lap3(qm, feats, t.blk_lo, t.blk_hi, cfg,
                              sub_q=sub_q)
        return launch, self._counts(), self.sc.state.capacity

    def _counts(self) -> dict:
        if not hasattr(self, "_pairs"):
            cfg = self.sc.cfg
            self._pairs = flops.pair_counts(self.pts, cfg.cell_size,
                                            cfg.kernel_h, cfg.grid_size)
        return self._pairs

    def flops_per_step(self, kind: str):
        """K3's counted operations (the frozen cloud's pairs)."""
        if kind != "fwd":
            return None
        return flops.kernel_flops("sweep_lap3", self._counts())

    def trace_stretch(self):
        return (lambda: self.simulate(self.steps).vm[0].item()), self.steps

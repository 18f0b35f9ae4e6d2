"""The reference application's experiment protocol, repeated back to back:
each repeat is `steps` coupled steps of the package's `run_protocol` from
the scene's initial state (turnOffStim before step `stim_off`, `chunk`
steps a call, each ending in a host fetch). One unit of work is one repeat;
it completes particles x steps particle-steps.

What the timed path produced is checked after the window, at the timed
sizes. The window keeps of each repeat only an exact digest of the state
at each chunk boundary (on the card, a few bytes); once the peak memory has
been read, one more repeat keeps copies of those states, and its digests
have to equal the window's last repeat's, bit for bit. Then:
- the captured graphs the window replays are held to the package's eager
  steps: from each boundary state, `chunk` steps run eagerly have to give
  the next boundary state bit for bit, so a replay that is skipped or
  altered shows;
- the float64 reference (benchmark/reference) follows the program one step
  from each boundary state (a trajectory of hundreds of steps amplifies
  the order of any float32 sum, shape matching's moments above all, until
  two sound float32 programs part), and the program runs the same step;
  their gaps are compared;
- the start (the program's initial state against the reference's, exactly)
  and the stimulus switched off (after it, every live row's stim is -10000
  and its vm, w and iion are one uniform value, bit for bit).
On a tiled cloud the tiles never meet (at least 0.5 apart, pairs reach
0.14), so the reference follows a seeded sample of `tiles` tiles (the
check file's), one at a time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import flops, trace
from ..reference import physics as ref
from . import PROG
from . import Job as BaseJob

# what a step reads of the state it starts from (the rest the reference
# holds itself: orig, mass, fixed, clusters)
CARRY = ("pos", "vel", "pv", "goal", "dens", "vm", "iion", "w", "stim")
STAGE_STEPS, STAGE_REPS = 50, 3


def digest(state) -> torch.Tensor:
    """An exact digest of a state, left on its device: each field's bit
    patterns summed modulo 2**32 (integer sums, so the order of the
    reduction cannot move it), one int32 a field."""
    out = []
    for f in dataclasses.fields(state):
        t = getattr(state, f.name).reshape(-1)
        if t.numel() * t.element_size() % 4:
            t = t.to(torch.int32)
        out.append(t.view(torch.int32).sum(dtype=torch.int32))
    return torch.stack(out)


def gaps(prog: dict, want: dict) -> dict:
    """Each field's largest gap over the rows (dens relative), and the
    root mean square of its gaps over the reference's (f_rms)."""
    out = {}
    for f in ref.FIELDS:
        w = want[f].double()
        d = (prog[f].double() - w).abs()
        out[f"{f}_rms"] = float(d.square().mean().sqrt()
                                / w.square().mean().sqrt())
        if f == "dens":
            d = d / w.abs()
        out[f"{f}_gap"] = float(d.max())
    return out




class Job(BaseJob):
    def setup(self):
        from sph_sm_monodomain_tpu_torch.models import scan
        from sph_sm_monodomain_tpu_torch.models.monodomain import run_protocol
        t = self.traffic
        self._run, self._scan = run_protocol, scan
        self.build()
        self.steps, self.stim_off = t["steps"], t["stim_off"]
        self.chunk = t["chunk"]
        self.digests = {}   # chunk boundary -> digest, the latest repeat
        self.keep = None    # boundary -> state, of the check's own repeat
        self.unit()

    def _digest(self, done, state):
        self.digests[done] = digest(state)

    def protocol(self, callback):
        return self._run(self.sc, num_steps=self.steps,
                         stim_off_step=self.stim_off, chunk=self.chunk,
                         callback=callback)

    def unit(self) -> int:
        self.protocol(self._digest)
        return self.n * self.steps

    # --- the check ------------------------------------------------------
    def starts(self) -> range:
        """The chunk boundaries a chunk starts from."""
        return range(0, self.steps, self.chunk)

    def boundaries(self) -> dict:
        """{step: state} at every chunk boundary of one repeat run after
        the window (step 0 the scene's initial state), copied as the run
        hands them over, with the number of digest elements in which each
        differs from the window's last repeat's."""
        if self.keep is None:
            keep, self.replay_mismatch = {0: self.sc.state}, 0

            def copy(done, state):
                keep[done] = self._scan.copy_state(state)
                self.replay_mismatch += int(
                    (digest(state) != self.digests[done]).sum())
            self.protocol(copy)
            self.keep = keep
        return self.keep

    def eager_mismatch(self) -> int:
        """Elements in which `chunk` eager steps of the package from each
        boundary state differ from the next boundary state: the window's
        captured graphs held to the steps they were captured from."""
        keep, bad = self.boundaries(), 0
        for b in self.starts():
            end = min(b + self.chunk, self.steps)
            off = self.stim_off - b if b <= self.stim_off < end else -1
            with self._scan.eager():
                got = self._run(self.sc._replace(state=keep[b]),
                                num_steps=end - b, stim_off_step=off,
                                chunk=end - b)[0]
            want = keep[end]
            for f in dataclasses.fields(want):
                bad += int((getattr(got, f.name)
                            != getattr(want, f.name)).sum())
            del got
        return bad

    def blocks(self):
        """Row ranges the reference follows: the whole cloud, or a seeded
        sample of its tiles."""
        k, n = self.conf["replicate"], self.n
        if k == 1:
            return [(0, n)]
        per = n // k
        rng = np.random.default_rng(self.seed % (1 << 63))
        tiles = sorted(rng.choice(k, size=self.checks["tiles"],
                                  replace=False).tolist())
        return [(t * per, (t + 1) * per) for t in tiles]

    def follow(self, P, r0: dict, control: bool = False) -> dict:
        """Largest gaps, over the chunks' starts and the followed rows, of
        the program's step from each start's state (or, with `control`,
        of the float32 TF32 reference's) from the float64 reference's."""
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
                base["cid"] = torch.zeros_like(base["cid"])
                base["clusters"] = 1
                s64 = dict(base, **{k: getattr(sb, PROG[k])[lo:hi].double()
                                    for k in CARRY})
                want = ref.step(s64, P)
                if control:
                    s32 = {k: (v.float() if torch.is_tensor(v)
                               and v.is_floating_point() else v)
                           for k, v in s64.items()}
                    got = ref.step(s32, P, rnd=ref.tf32)
                else:
                    got = {f: getattr(prog, PROG[f])[lo:hi]
                           for f in ref.FIELDS}
                for f, v in gaps(got, want).items():
                    worst[f] = max(worst.get(f, 0.0), v)
                del want, s64
        return worst

    def readings(self) -> dict:
        n = self.n
        P, r0 = self.reference_start()
        out = {"start_mismatch": self.start_mismatch(r0)}
        keep = self.boundaries()
        out["replay_mismatch"] = self.replay_mismatch
        out["eager_mismatch"] = self.eager_mismatch()
        out.update(self.follow(P, r0))

        # after turnOffStim every live row's electrophysiology is one
        # uniform decay: stim -10000 and equal vm, w and iion on every row
        bad = 0
        for b, sb in keep.items():
            if b > self.stim_off:
                bad += int((sb.stim[:n] != -10000.0).sum())
                for f in ("vm", "w", "iion"):
                    x = getattr(sb, f)[:n]
                    bad += int((x != x[0]).sum())
        out["offstim_mismatch"] = bad
        return out

    def control(self) -> dict:
        """The control's gaps: the reference in float32 with TF32 products
        in the program's place."""
        return self.follow(*self.reference_start(), control=True)

    # --- the traced run -------------------------------------------------
    def _mid(self):
        return self.boundaries()[self.chunk]

    def stage_ms(self, stage: str):
        """The v4 step's stages by an incremental ablation of graphed chains
        (a frozen copy of the package's utils/report.profile_phases_fused
        arithmetic): bookkeeping; + shape matching; the full step. Each
        chain of STAGE_STEPS steps from the first boundary state, the
        median of STAGE_REPS CUDA-event walls."""
        if not hasattr(self, "_stages"):
            self._stages = self._ablation()
        return self._stages[stage]

    def _ablation(self) -> dict:
        from sph_sm_monodomain_tpu_torch.models.monodomain import step_fused
        from sph_sm_monodomain_tpu_torch.models.scan import run_steps
        from sph_sm_monodomain_tpu_torch.ops.shape_matching import (
            corrected_velocity, sm_invariants)
        from sph_sm_monodomain_tpu_torch.ops.sweeps import sweep_bookkeeping3
        cfg, sub_q, state = self.sc.cfg, self.sc.sub_block, self._mid()
        with torch.no_grad():
            inv = sm_invariants(state, cfg)

        def bit(order, s):
            return (order[0] % 2).to(s.pos.dtype)

        def book(s):
            order = sweep_bookkeeping3(s.pos, s.active, cfg, sub_q)[0]
            return s.replace(pos=s.pos + 1e-9 * bit(order, s))

        def sm(s):
            order = sweep_bookkeeping3(s.pos, s.active, cfg, sub_q)[0]
            s = corrected_velocity(s, cfg, sm_inv=inv)
            return s.replace(pos=s.pos + 1e-9 * s.corrected_vel
                             + 1e-9 * bit(order, s))

        def full(s):
            return step_fused(s, cfg, sub_q, impl="v4", sm_inv=inv)[0]

        ms = {}
        for name, body in (("book", book), ("sm", sm), ("full", full)):
            def run(body=body, name=name):
                return run_steps(lambda s, _o: (body(s), None), state,
                                 STAGE_STEPS, key=("benchmark_stage", name))
            with torch.no_grad():
                run()
                walls = sorted(trace.event_wall(run, self.device)
                               for _ in range(STAGE_REPS))
            ms[name] = walls[STAGE_REPS // 2] / STAGE_STEPS * 1e3
        return {"bookkeeping": ms["book"],
                "shape_matching": ms["sm"] - ms["book"],
                "sweep_stage": ms["full"] - ms["sm"]}

    def kernel_inputs(self, kernel: str):
        if kernel not in ("sweep_a3", "sweep_b3"):
            return None
        from sph_sm_monodomain_tpu_torch.ops import fused_step as fst
        from sph_sm_monodomain_tpu_torch.ops.shape_matching import (
            corrected_velocity, sm_invariants)
        from sph_sm_monodomain_tpu_torch.ops.sweeps import sweep_bookkeeping3
        cfg, sub_q, state = self.sc.cfg, self.sc.sub_block, self._mid()
        with torch.no_grad():
            order, _, lo, hi, cx, cyz = sweep_bookkeeping3(
                state.pos, state.active, cfg, sub_q)
            s = corrected_velocity(state, cfg, sm_inv=sm_invariants(state,
                                                                    cfg))
            fs, fa = fst.build_qm_feats(s, cx, cyz, order)
            out_a = fst.sweep_a3(fs, fa, lo, hi, cfg, sub_q=sub_q)
            fb = fst.feats_b(out_a)
        if kernel == "sweep_a3":
            def launch():
                return fst.sweep_a3(fs, fa, lo, hi, cfg, sub_q=sub_q)
        else:
            def launch():
                return fst.sweep_b3(out_a, fb, lo, hi, cfg, sub_q=sub_q)
        return launch, self._counts(state), state.capacity

    def _counts(self, state) -> dict:
        cfg = self.sc.cfg
        return flops.pair_counts(state.pos[:self.n], cfg.cell_size,
                                 cfg.kernel_h, cfg.grid_size)

    def flops_per_step(self, kind: str):
        """K1's and K2's counted operations, the mean over the boundary
        states of the latest repeat."""
        if kind != "fwd":
            return None
        keep = self.boundaries()
        states = [keep[b] for b in self.starts()]
        total = 0
        for s in states:
            c = self._counts(s)
            total += flops.kernel_flops("sweep_a3", c) \
                + flops.kernel_flops("sweep_b3", c)
        return total / len(states)

    def trace_stretch(self):
        """One unit: a protocol repeat."""
        return (lambda: self.protocol(None)), self.steps

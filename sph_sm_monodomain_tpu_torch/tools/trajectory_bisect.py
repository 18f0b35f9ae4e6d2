"""Which part of the step carries the port's distance from the committed
JAX trajectory of full biceps_full (tools/trajectory_parity.py).

Reruns the "protocol" start of trajectory_parity (`run_protocol`, every
step eager: `models/scan.eager()`) with one part of the step at a time
switched, and prints each record's ratio against the one-ulp spread alone
(tests/torch_parity.py's yardstick) and against the larger of both
committed spreads, with each variant's distance from the port on the CPU
at the first step of STEPS:
  "as built"            the port as it runs on `device`;
  "plain sweeps"        K1 / K2 replaced by their plain PyTorch versions
                        on the same device;
  "transform on CPU"    the shape-matching 3x3 transform (the polar
                        chain) on the CPU;
  "shape matching on CPU"  all of shape matching, moments included, on the
                        CPU (fp32);
  "shape matching f64"  all of shape matching in float64;
  "CPU"                 the port on the CPU.
On a CPU device the variants but "shape matching f64" are the CPU port's
own run (the wrappers take the plain versions there), which stands for
them.
It also prints, from the committed file, how far JAX's own run from
shuffled rows lies from the snapshot over the one-ulp yardstick.

    python -m sph_sm_monodomain_tpu_torch.tools.trajectory_bisect \\
        [--device cuda|cpu] [--steps 3 40]
"""

from __future__ import annotations

import argparse
import contextlib
from unittest import mock

from ..models import monodomain, scan
from ..ops import fused_step as fst
from ..ops import shape_matching as sm
from ..state import state_to_numpy
from . import trajectory_parity as tp

START = "protocol"


def _plain_a(fs, feats_a, lo, hi, cfg, sub_q=128, dynp=None):
    return fst.sweep_a3_plain(fs, feats_a, cfg, dynp=dynp)


def _plain_b(out_a, feats_b, lo, hi, cfg, sub_q=128, dynp=None):
    return fst.sweep_b3_plain(out_a, feats_b, cfg, dynp=dynp)


def _sm_on_cpu(state, cfg, sm_inv=None, external_forces=None, comm=None):
    st = state.to("cpu")
    out = sm.corrected_velocity(st, cfg, sm_inv=sm.sm_invariants(st, cfg))
    return out.to(state.pos.device)


_transform = sm._linear_transform


def _transform_on_cpu(apq, aqq_inv, cfg):
    return _transform(apq.cpu(), aqq_inv.cpu(), cfg).to(apq.device)


def _sm_f64(state, cfg, sm_inv=None, external_forces=None, comm=None):
    state = sm.apply_external_forces(state, cfg)
    st64 = state.replace(**{f: getattr(state, f).double() for f in (
        "pos", "orig_pos", "mass", "goal_pos", "vel", "predicted_vel")})
    goal = sm.project_positions(st64, cfg).float()
    cv = state.predicted_vel + (goal - state.pos) * (
        (1.0 / cfg.time_delta) * cfg.sm_alpha)
    return state.replace(goal_pos=goal, corrected_vel=cv)


VARIANTS = {
    "as built": (),
    "plain sweeps": ((monodomain, "sweep_a3", _plain_a),
                     (monodomain, "sweep_b3", _plain_b)),
    "transform on CPU": ((sm, "_linear_transform", _transform_on_cpu),),
    "shape matching on CPU": ((monodomain, "corrected_velocity",
                               _sm_on_cpu),),
    "shape matching f64": ((monodomain, "corrected_velocity", _sm_f64),),
}


def runs(patches, device, steps) -> dict:
    """{step: live fields} of the protocol start under `patches`, every
    step eager."""
    with contextlib.ExitStack() as stack:
        for obj, name, value in patches:
            stack.enter_context(mock.patch.object(obj, name, value))
        stack.enter_context(scan.eager())
        scan.clear_cache()
        sc = tp.start_scene(START, device)
        act = sc.state.active.cpu().numpy()
        out = {}
        for step in steps:
            st = monodomain.run_protocol(sc, num_steps=step,
                                         stim_off_step=tp.STIM_OFF_STEP)[0]
            out[step] = tp.live_fields(state_to_numpy(st), act)
    scan.clear_cache()
    return out


def bisect(device="cuda", steps=tp.STEPS, data=None) -> dict:
    """{variant: {"ulp": {step: ratios}, "both": {step: ratios},
    "vs_cpu": ratios}}: each variant's ratios against the committed
    trajectory and its distance from the CPU port at steps[0] over the
    one-ulp tolerance; with "jax_shuffled": {step: the committed order
    spread over the one-ulp tolerance}."""
    data = tp.load() if data is None else data
    cpu = runs((), "cpu", steps)
    tol = tp.tolerances(data, START, steps[0], ("ulp",))
    out = {}
    on_cpu = device == "cpu"
    for name, patches in list(VARIANTS.items()) + [("CPU", None)]:
        same = patches is None or (on_cpu and name != "shape matching f64")
        got = cpu if same else runs(patches, device, steps)
        d = tp.differences(got[steps[0]], cpu[steps[0]])
        out[name] = {
            "ulp": {s: tp.ratios(got[s], data, START, s, ("ulp",))
                    for s in steps},
            "both": {s: tp.ratios(got[s], data, START, s) for s in steps},
            "vs_cpu": {f: d[f] / tol[f] for f in tp.FIELDS}}
    out["jax_shuffled"] = {s: _order_over_ulp(data, s) for s in steps}
    return out


def _order_over_ulp(data, step) -> dict:
    """Each field's committed order spread over its one-ulp tolerance."""
    tol = tp.tolerances(data, START, step, ("ulp",))
    return {f: float(data[tp.key(START, step, "order_" + f)]) / tol[f]
            for f in tp.FIELDS}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, nargs="+", default=list(tp.STEPS))
    a = ap.parse_args(argv)
    res = bisect(a.device, tuple(a.steps))

    def fmt(r):
        return ", ".join(f"{f} {v:.4f}" for f, v in r.items()
                         if f in ("pos", "vel", "dens"))
    print(f"{tp.SCENE} {START} start on {a.device}: largest difference over "
          "the one-ulp tolerance [over both spreads' tolerance]", flush=True)
    for name, r in res.items():
        if name == "jax_shuffled":
            continue
        for s in a.steps:
            print(f"  {name:<22} step {s:>2}: {fmt(r['ulp'][s])} "
                  f"[{fmt(r['both'][s])}]", flush=True)
        print(f"  {name:<22} from the CPU port at step {a.steps[0]}: "
              f"{fmt(r['vs_cpu'])}", flush=True)
    for s, r in res["jax_shuffled"].items():
        print(f"  JAX from shuffled rows  step {s:>2}: {fmt(r)}", flush=True)
    return res


if __name__ == "__main__":
    main()

"""Writes tests/data/biceps_full_jax_trajectory.npz: the JAX package's
trajectory of full biceps_full that tests/test_torch_full_scene.py and
chip_smoke.py (phase 33) hold the PyTorch port's main path to. Not a
test; it imports both packages and runs JAX on the CPU:

    PYTHONPATH=.:tests python tests/full_trajectory.py [--out PATH]

(several minutes on the CPU). For each start of
sph_sm_monodomain_tpu_torch.tools.trajectory_parity.STARTS ("protocol":
`build_scene("biceps_full")` as built; "vm_field": its vm replaced on the
live rows by a seeded normal field) it runs the unfused
`run_protocol(scene, num_steps=n, stim_off_step=20, fused=False)` for n = 1,
3 and 40, and keeps the live rows' inter_vm after step 1 and their pos,
vel, vm, w, iion and dens after steps 3 and 40, each with two of JAX's own
spreads: "ulp", the larger change when every live position starts one
float32 ulp up or one down (tests/torch_parity.py's `bump_pos`), and
"order", the change when the live rows start shuffled (seeded; the result
is put back in row order), per field the largest over the rows (dens
relative, tests/torch_parity.py's `state_spread`), for inter_vm row by
row. The file also records the versions of JAX and numpy, the host's CPU
model, the seeds, the steps and the scene's live row count.
"""

from __future__ import annotations

import argparse
import dataclasses
import platform
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import sph_sm_monodomain_tpu as J  # noqa: E402
from sph_sm_monodomain_tpu_torch.tools import trajectory_parity as tp  # noqa: E402,E501
from torch_parity import bump_pos  # noqa: E402


def cpu_model() -> str:
    """The host's CPU model name, as the OS reports it."""
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def jax_start(start: str):
    """The JAX Scene of `start` (tp.STARTS), built as the port builds it."""
    sc = J.build_scene(tp.SCENE)
    if start == "protocol":
        return sc
    st = sc.state
    vm = tp.vm_field(np.asarray(st.vm), np.asarray(st.active))
    return sc._replace(state=st.replace(vm=vm))


def jax_run(sc, steps: int, state=None):
    """The final JAX state of the unfused protocol run of `steps` steps."""
    if state is not None:
        sc = sc._replace(state=state)
    return J.run_protocol(sc, num_steps=steps,
                          stim_off_step=tp.STIM_OFF_STEP, fused=False)[0]


def live(js, what=tp.FIELDS, perm=None) -> dict:
    """The live rows' fields `what` of a JAX state, in the original row
    order when the run started from rows permuted by `perm`."""
    order = slice(None) if perm is None else np.argsort(perm)
    act = np.asarray(js.active)[order]
    return {f: np.asarray(getattr(js, f))[order][act] for f in what}


def permuted(js, perm):
    """The JAX state with every per-row field's rows taken in `perm`'s
    order."""
    n = js.capacity
    return js.replace(**{
        f.name: np.asarray(getattr(js, f.name))[perm]
        for f in dataclasses.fields(js)
        if np.ndim(getattr(js, f.name)) and np.shape(
            getattr(js, f.name))[0] == n})


def rowwise(a: dict, b: dict) -> dict:
    """Per field, |a - b| row by row (the largest over a row's
    components; dens relative to `a`)."""
    out = {}
    for f, v in a.items():
        d = np.abs(v.astype(np.float64) - b[f].astype(np.float64))
        if f == "dens":
            d = d / np.abs(v.astype(np.float64))
        out[f] = d.reshape(len(d), -1).max(axis=1)
    return out


def record(start: str) -> dict:
    """The npz entries of one start: inter_vm after tp.LAP_STEP, the
    fields after tp.STEPS, and their spreads tp.SPREADS."""
    sc = jax_start(start)
    perm = tp.live_shuffle(np.asarray(sc.state.active))
    out = {}
    for step in (tp.LAP_STEP,) + tp.STEPS:
        t0 = time.perf_counter()
        what = ("inter_vm",) if step == tp.LAP_STEP else tp.FIELDS
        ref = live(jax_run(sc, step), what)
        ulp = [rowwise(ref, live(jax_run(sc, step, bump_pos(sc.state, d)),
                                 what))
               for d in (np.inf, -np.inf)]
        order = rowwise(ref, live(jax_run(sc, step,
                                          permuted(sc.state, perm)),
                                  what, perm))
        for f in what:
            out[tp.key(start, step, f)] = ref[f]
            row_ulp = np.maximum(ulp[0][f], ulp[1][f])
            for kind, d in (("ulp", row_ulp), ("order", order[f])):
                # inter_vm row by row, the fields their largest row
                out[tp.key(start, step, f"{kind}_{f}")] = (
                    d.astype(np.float32) if step == tp.LAP_STEP
                    else np.float64(d.max()))
        print(f"{start} step {step}: spreads (ulp, order) "
              + ", ".join(f"{f} {np.max(out[tp.key(start, step, 'ulp_' + f)]):.3g}"
                          f" / {np.max(out[tp.key(start, step, 'order_' + f)]):.3g}"
                          for f in what)
              + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(tp.DATA))
    a = ap.parse_args(argv)
    data = {}
    for start in tp.STARTS:
        data.update(record(start))
    n_live = int(np.asarray(J.build_scene(tp.SCENE).state.active).sum())
    data.update(
        jax_version=np.str_(jax.__version__),
        numpy_version=np.str_(np.__version__),
        cpu_model=np.str_(cpu_model()),
        seed=np.int64(tp.SEED), vm_scale=np.float64(tp.VM_SCALE),
        shuffle_seed=np.int64(tp.SHUFFLE_SEED),
        steps=np.asarray(tp.STEPS, np.int64),
        stim_off_step=np.int64(tp.STIM_OFF_STEP),
        live_rows=np.int64(n_live), scene=np.str_(tp.SCENE))
    out = Path(a.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, **data)
    print(f"wrote {out}: {out.stat().st_size} bytes", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

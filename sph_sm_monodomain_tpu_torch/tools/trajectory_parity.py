"""The main path against a committed JAX trajectory of full biceps_full.

`tests/data/biceps_full_jax_trajectory.npz` holds the JAX package's
unfused `run_protocol` on `build_scene("biceps_full")` (18,475 particles)
with the stim turned off before step 20, from two starts: "protocol", the
scene as built, and "vm_field", the same state with a seeded normal vm
field (x VM_SCALE) on the live rows, so the Vm Laplacian of the step is
not zero (the scene as built stimulates every live particle alike, and
its vm stays uniform). It keeps the live rows' pos, vel, vm, w, iion and
dens after steps 3 and 40, and inter_vm after step 1 (the diffusion term
(1 + vm_scale) x the Laplacian, less the reaction): turnOffStim resets vm,
w and iion on every live row before step 20, so at step 40 vm is uniform
again in both starts. `tests/full_trajectory.py` writes the file (with
JAX, on the CPU).

Beside each record the file keeps two of JAX's own spreads (SPREADS),
the largest change of the field (dens relative) when the same JAX run
  "ulp":   starts from every live position moved one float32 ulp up, or
           down (the larger of the two; tests/torch_parity.py's yardstick);
  "order": starts from the state with its live rows shuffled (seeded),
           which changes the order of every sum and nothing else;
per field the largest over the rows, and for inter_vm row by row. The
one-ulp move is nearly rigid, and shape matching absorbs it; a new order
of the shape-matching moments is not absorbed: on full biceps_full it
moves JAX's own positions 3.7x, and its densities 7.8x, as far as the
one-ulp move's tolerance after 3 steps, and 17x after 40. Any fp32
implementation sums in an order of its own (the kernels; cuBLAS on the
card; on the CPU a BLAS whose blocking depends on the host), so each
record is held to max(the JAX suite's one-step tolerance, SPREAD_FACTOR x
the larger spread), dens relative (tests/torch_parity.py's rule), and
inter_vm row by row to max(LAP_RTOL x max(1, its largest magnitude),
SPREAD_FACTOR x the row's larger spread) (chip_smoke.py's kernel
tolerance). A record's ratio is its largest difference over that
tolerance: at most 1 passes. The ratio against the one-ulp spread alone is
printed beside it.

This module runs the port's `run_protocol` (the scene's v4 step: K1 / K2
on the card, their plain versions on the CPU) from the same two starts,
built with numpy alone:

    python -m sph_sm_monodomain_tpu_torch.tools.trajectory_parity \\
        [--device cuda|cpu] [--data PATH]

prints each start's ratios at each step and exits 1 if one is above 1.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from ..models.monodomain import run_protocol
from ..state import state_to_numpy
from ..utils.io import build_scene

DATA = (Path(__file__).resolve().parents[2] / "tests" / "data"
        / "biceps_full_jax_trajectory.npz")
SCENE = "biceps_full"
STARTS = ("protocol", "vm_field")
NUM_STEPS, STIM_OFF_STEP = 40, 20
STEPS = (3, NUM_STEPS)
# the step after which inter_vm is held, row by row, and its tolerance
# relative to max(1, its largest magnitude)
LAP_STEP, LAP_RTOL = 1, 1e-5
# the vm field of the "vm_field" start: normal(seed) x VM_SCALE on the
# live rows, as tests/test_params.py's spatially varying vm; the seed of
# the "order" spread's shuffle
SEED, VM_SCALE, SHUFFLE_SEED = 20261018, 5.0, 1
FIELDS = ("pos", "vel", "vm", "w", "iion", "dens")
SPREADS = ("ulp", "order")
# the JAX suite's fused-step tolerances (tests/test_pallas_sweeps.py):
# absolute, dens relative; each widened to SPREAD_FACTOR x JAX's spread
STEP_TOLS = {"pos": 5e-5, "vel": 5e-3, "vm": 5e-3, "iion": 1e-5, "w": 1e-6,
             "dens": 1e-5}
SPREAD_FACTOR = 2.0


def vm_field(vm: np.ndarray, active: np.ndarray,
             seed: int = SEED) -> np.ndarray:
    """vm with its live rows replaced by normal(seed) x VM_SCALE (f32)."""
    out = np.array(vm, dtype=np.float32)
    act = np.asarray(active, dtype=bool)
    rng = np.random.default_rng(seed)
    out[act] = (rng.normal(size=int(act.sum())).astype(np.float32)
                * np.float32(VM_SCALE))
    return out


def live_shuffle(active: np.ndarray, seed: int = SHUFFLE_SEED) -> np.ndarray:
    """A row permutation that shuffles the live rows (the leading ones) and
    keeps every dead row in place."""
    n = int(np.asarray(active, dtype=bool).sum())
    perm = np.arange(len(active))
    perm[:n] = np.random.default_rng(seed).permutation(n)
    return perm


def start_scene(start: str, device="cuda"):
    """The port's biceps_full scene of start `start` (STARTS)."""
    sc = build_scene(SCENE, device=device)
    if start == "protocol":
        return sc
    if start != "vm_field":
        raise ValueError(f"unknown start {start!r} (expected {STARTS})")
    st = sc.state
    vm = vm_field(st.vm.cpu().numpy(), st.active.cpu().numpy())
    return sc._replace(state=st.replace(vm=torch.from_numpy(vm).to(
        st.vm.device)))


def live_fields(arrays: dict, active) -> dict:
    """The FIELDS of a state's numpy arrays on its live rows."""
    act = np.asarray(active, dtype=bool)
    return {f: np.asarray(arrays[f])[act] for f in FIELDS}


def key(start: str, step: int, what: str) -> str:
    """The npz key of a record ("pos", ..., "inter_vm") or of a spread of
    one ("ulp_pos", "order_inter_vm", ...)."""
    return f"{start}_s{step}_{what}"


def load(path=DATA) -> dict:
    """The committed trajectory as a dict of numpy arrays."""
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def spread(data: dict, start: str, step: int, what: str, kinds=SPREADS):
    """The larger of the committed spreads `kinds` of a record."""
    return np.max([data[key(start, step, f"{k}_{what}")] for k in kinds],
                  axis=0)


def tolerances(data: dict, start: str, step: int, kinds=SPREADS) -> dict:
    """Each field's tolerance at (start, step): max(STEP_TOLS,
    SPREAD_FACTOR x the larger committed spread of `kinds`); dens
    relative."""
    return {f: max(STEP_TOLS[f], SPREAD_FACTOR
                   * float(spread(data, start, step, f, kinds)))
            for f in FIELDS}


def differences(got: dict, want: dict) -> dict:
    """Largest difference of each field, dens relative to `want`."""
    out = {f: float(np.abs(got[f].astype(np.float64)
                           - want[f].astype(np.float64)).max())
           for f in FIELDS if f != "dens"}
    d = want["dens"].astype(np.float64)
    out["dens"] = float((np.abs(got["dens"] - d) / np.abs(d)).max())
    return out


def ratios(got: dict, data: dict, start: str, step: int,
           kinds=SPREADS) -> dict:
    """Each record's largest difference from the snapshot at (start, step)
    over its tolerance (the spreads `kinds`); at LAP_STEP, inter_vm's, row
    by row."""
    if step == LAP_STEP:
        want = data[key(start, step, "inter_vm")].astype(np.float64)
        tol = np.maximum(LAP_RTOL * max(1.0, float(np.abs(want).max())),
                         SPREAD_FACTOR
                         * spread(data, start, step, "inter_vm", kinds))
        return {"inter_vm": float((np.abs(got["inter_vm"] - want)
                                   / tol).max())}
    want = {f: data[key(start, step, f)] for f in FIELDS}
    tol = tolerances(data, start, step, kinds)
    return {f: d / tol[f] for f, d in differences(got, want).items()}


def run_start(start: str, device="cuda") -> dict:
    """{step: live fields} of the port's run_protocol from `start` after
    LAP_STEP ({"inter_vm": ...}) and each of STEPS, every run with the
    stim off before STIM_OFF_STEP."""
    sc = start_scene(start, device)
    act = sc.state.active.cpu().numpy()
    out = {}
    for step in (LAP_STEP,) + STEPS:
        st = state_to_numpy(run_protocol(sc, num_steps=step,
                                         stim_off_step=STIM_OFF_STEP)[0])
        out[step] = ({"inter_vm": st["inter_vm"][act]} if step == LAP_STEP
                     else live_fields(st, act))
    return out


def check(device="cuda", data=None) -> dict:
    """The port's runs from every start against the committed trajectory:
    {"ratios": {(start, step): {record: ratio}}, "ulp_ratios": the same
    against the one-ulp spread alone, "vm_range": {start: max - min of vm
    over the live rows after step 3}, "lap_range": {start: the same of
    inter_vm after LAP_STEP}}."""
    data = load() if data is None else data
    out = {"ratios": {}, "ulp_ratios": {}, "vm_range": {}, "lap_range": {}}
    for start in STARTS:
        runs = run_start(start, device)
        for step, got in runs.items():
            out["ratios"][(start, step)] = ratios(got, data, start, step)
            out["ulp_ratios"][(start, step)] = ratios(got, data, start, step,
                                                      ("ulp",))
        vm, lap = runs[STEPS[0]]["vm"], runs[LAP_STEP]["inter_vm"]
        out["vm_range"][start] = float(vm.max() - vm.min())
        out["lap_range"][start] = float(lap.max() - lap.min())
    return out


def report(res: dict) -> float:
    """Print the ratios of `check` and return the largest."""
    worst = 0.0
    for (start, step), r in res["ratios"].items():
        worst = max(worst, max(r.values()))
        ulp = res["ulp_ratios"][(start, step)]
        print(f"trajectory {start} step {step}: difference over tolerance "
              + ", ".join(f"{f} {v:.4f}" for f, v in r.items())
              + "; over the one-ulp spread's alone "
              + ", ".join(f"{f} {v:.4f}" for f, v in ulp.items()),
              flush=True)
    print(f"trajectory: vm range after step {STEPS[0]} {res['vm_range']}, "
          f"inter_vm range after step {LAP_STEP} {res['lap_range']}; "
          f"largest ratio {worst:.4f} (bound 1)", flush=True)
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--data", default=str(DATA))
    a = ap.parse_args(argv)
    return 0 if report(check(a.device, load(a.data))) <= 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())

"""Flagship-scale differentiable simulation on the GPU: recover the material
constants (EOS stiffness K and viscosity mu) of the full biceps cloud
(18,475 particles) by gradient descent through a long stimulated coupled
rollout (the port of examples/fit_material_flagship.py, both its paths).

The reference searches constants by hand, one compile and run per value
(its 242-run results_171114.csv); here the constants are tensor inputs
(config.PARAM_FIELDS, resolve_params) and autograd differentiates the whole
rollout w.r.t. them. With `--fused` the step is the differentiable fused
step (models/monodomain.step_fused_diff: the production sweep kernels
forward, one hand-written backward sweep per kernel; `grad_path`
fused-hand-adjoint); without it, as in the JAX example, the unfused
reference step (models/monodomain.step) under autograd (`grad_path`
torch-autodiff).

The rollout runs through models/scan.run_steps, the counterpart of the
JAX example's jax.jit(jax.value_and_grad(...)) over a jax.checkpoint'ed
scan: under autograd a checkpointed adjoint scan that keeps one state per
step and recomputes the step's internals (windows, pair sums) when the
backward pass reaches it, each forward step and each backward step one
replay of a captured CUDA graph on the card. One value-and-grad of an
S-step `--fused` rollout runs each forward sweep 2S times and each
backward sweep S times. The peak of torch.cuda.max_memory_allocated over
the grad call is reported.

Parameters are fitted in log space; the loss compares the active-particle
displacement field at several times along the rollout with that of a
hidden material (K = 0.9, mu = 40), from the poor guess (0.3, 150), by Adam
with cosine decay. Stim stays on throughout.

Run:
    python -m sph_sm_monodomain_tpu_torch.examples.fit_material_flagship \\
        [scene] [steps] [iters] [--fused] [--device cuda|cpu] [--csv=PATH]
        [--lr=0.15] [--roughness] [--scan]
Defaults: biceps_full 250 30 on the card. `--roughness` fits no material:
it prints the loss's roughness in log K and log mu (`roughness`) at the
initial guess and at (0.494, 40.8), where a 250-step, 120-iteration fit
once stopped. `--scan` fits none either: it prints the loss at 7 points of
log K (the truth +-0.5, mu at the truth) and, along each rollout, how many
particles sit on the EOS clamp +-max_pressure (`loss_scan`). `--csv=PATH`
appends one row in the JAX example's schema (its `adjoint_temps_gib`
column holds the peak allocated GiB of the grad call here).
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch

from ..models.monodomain import ensure_fp32, step, step_fused_diff
from ..models.scan import run_steps
from ..ops.shape_matching import sm_invariants
from ..utils.io import build_scene

FIT_ROW_HEADER = ("scene;particles;rollout_steps;adam_iters;"
                  "fwd_ms_per_step;grad_ms_per_step;grad_over_fwd;"
                  "adjoint_temps_gib;K_true;K_recovered;mu_true;"
                  "mu_recovered;err_K;err_mu;backend;grad_path")
TRUE_K, TRUE_MU = 0.9, 40.0      # hidden material
THETA0 = (0.3, 150.0)            # poor initial guess
# where the 250-step, 120-iteration fit stopped on the card (K 45% off)
ROUGHNESS_POINTS = (THETA0, (0.494, 40.8))
SCAN_LOG_K = np.linspace(-0.5, 0.5, 7)    # loss_scan's offsets of log K


def append_fit_row(path, vals) -> None:
    """Append one fit row to `path` (header once)."""
    new = not os.path.exists(path) or os.path.getsize(path) == 0
    with open(path, "a") as f:
        if new:
            f.write("# Flagship material fits through the full coupled "
                    "rollout, PyTorch port\n# (sph_sm_monodomain_tpu_torch/"
                    "examples/fit_material_flagship.py).\n")
            f.write(FIT_ROW_HEADER + "\n")
        f.write(";".join(f"{v:g}" if isinstance(v, float) else str(v)
                         for v in vals) + "\n")


def displacement(s) -> torch.Tensor:
    """The active particles' displacement from their rest positions."""
    return torch.where(s.active[:, None], s.pos - s.orig_pos,
                       torch.zeros_like(s.pos))


def rollout_frames(scene, sm_inv, log_theta, steps: int, every: int,
                   extract, fused: bool = True) -> list:
    """`extract(state)` after each block of `every` steps of a `steps`-step
    rollout under (K, mu) = exp(log_theta): the fused step
    (step_fused_diff) or the unfused one, through models/scan.run_steps
    (under autograd its checkpointed adjoint scan)."""
    params = {"k_stiffness": torch.exp(log_theta[0]),
              "mu_viscosity": torch.exp(log_theta[1])}
    cfg, sub_q, cap = scene.cfg, scene.sub_block, scene.neighbor_capacity

    def one(s, ops):
        if fused:
            return step_fused_diff(s, cfg, sub_q, sm_inv=ops[0],
                                   params=ops[1]), None
        return step(s, cfg, cap, sm_inv=ops[0], params=ops[1])

    return run_steps(one, scene.state, steps, operands=(sm_inv, params),
                     key=("fit_material_flagship", cfg, fused, sub_q, cap),
                     record_every=every, extract=extract)[2]


def rollout_disp(scene, sm_inv, log_theta, steps: int, snaps: int,
                 fused: bool = True):
    """Active-particle displacement snapshots (snaps, N, 3) after each of
    `snaps` blocks of steps // snaps steps, under (K, mu) =
    exp(log_theta)."""
    blk = steps // snaps
    frames = rollout_frames(scene, sm_inv, log_theta, blk * snaps, blk,
                            lambda s: (displacement(s),), fused)
    return torch.stack([f[0] for f in frames])


def theta_of(k: float, mu: float, device) -> torch.Tensor:
    return torch.log(torch.tensor([k, mu], dtype=torch.float32,
                                  device=device))


def misfit(disp, target) -> torch.Tensor:
    """Displacement misfit against `target`, in mm^2 for readable logs."""
    d = disp - target
    return (d * d).sum() * 1e6


def make_loss(scene, sm_inv, target, steps: int, snaps: int,
              fused: bool = True):
    """log_theta -> the misfit of its displacement snapshots."""
    def loss(log_theta):
        return misfit(rollout_disp(scene, sm_inv, log_theta, steps, snaps,
                                   fused), target)
    return loss


def value_and_grad(loss, log_theta):
    """(loss, d loss / d log_theta) at `log_theta`, both detached."""
    th = log_theta.detach().requires_grad_()
    val = loss(th)
    (g,) = torch.autograd.grad(val, th)
    return val.detach(), g


def adam_fit(loss, theta0, iters: int, lr0: float = 0.15, log=print):
    """Hand-written Adam with cosine decay to lr0/20: the (K, mu) valley is
    coupled (K passes its optimum while mu is still correcting), so a flat
    rate orbits the minimum. Returns (log_theta, losses, grads): the loss
    and gradient at the start of every iteration."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    log_theta = theta0
    m = v = torch.zeros_like(theta0)
    losses, grads = [], []
    for i in range(iters):
        lr = lr0 * (0.05 + 0.95 * 0.5
                    * (1 + math.cos(math.pi * i / max(iters - 1, 1))))
        val, g = value_and_grad(loss, log_theta)
        losses.append(val)
        grads.append(g)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh, vh = m / (1 - b1 ** (i + 1)), v / (1 - b2 ** (i + 1))
        # Adam's step-size denominator, not physics: torch.sqrt's rounding
        # on the CPU only scales the step (ops/numerics.sqrt_rn)
        log_theta = log_theta - lr * mh / (torch.sqrt(vh) + eps)
        if i % 5 == 0 or i == iters - 1:
            k, mu = torch.exp(log_theta).tolist()
            log(f"iter {i:3d}: loss {float(val):10.4e}  K {k:7.4f}  "
                f"mu {mu:8.3f}")
    return log_theta, losses, grads


def roughness(value, theta, axis: int, half_width: float = 5e-3,
              points: int = 9) -> float:
    """Roughness of a loss along one log-parameter: the rms residual of a
    quadratic fit to value(theta + d e_axis) at `points` offsets d in
    [-half_width, half_width], over |value(theta)|. `value` takes a float32
    numpy vector; the offsets are those float32 can represent. A loss whose
    rounding noise is small beside its curvature over the interval reads
    near 0."""
    base = np.asarray(theta, np.float32)
    ds, vals = [], []
    for d in np.linspace(-half_width, half_width, points):
        th = base.copy()
        th[axis] = np.float32(base[axis] + d)
        ds.append(float(th[axis]) - float(base[axis]))
        vals.append(float(value(th)))
    ds, vals = np.asarray(ds), np.asarray(vals)
    res = vals - np.polyval(np.polyfit(ds, vals, 2), ds)
    return float(np.sqrt(np.mean(res * res)) / abs(vals[points // 2]))


def roughness_report(sc, steps: int, log=print, fused: bool = True) -> dict:
    """The fit loss of `sc` over `steps` steps (snapshots and hidden
    material as the fit's, the fused or the unfused step) at
    ROUGHNESS_POINTS: its value and its roughness in log K and log mu,
    forward only."""
    dev = sc.state.device
    snaps = max(1, min(5, steps))
    sm_inv = sm_invariants(sc.state, sc.cfg)
    with torch.no_grad():
        target = rollout_disp(sc, sm_inv, theta_of(TRUE_K, TRUE_MU, dev),
                              steps, snaps, fused)
    loss = make_loss(sc, sm_inv, target, steps, snaps, fused)

    def value(th):
        with torch.no_grad():
            return float(loss(torch.from_numpy(th).to(dev)))

    out = {}
    for k, mu in ROUGHNESS_POINTS:
        th = np.log(np.asarray([k, mu], np.float32))
        out[(k, mu)] = {"loss": value(th), "rough_log_k": roughness(value, th, 0),
                        "rough_log_mu": roughness(value, th, 1)}
        log(f"{sc.name} {steps} steps ({dev}) at K={k:g} mu={mu:g}: "
            f"loss {out[(k, mu)]['loss']:.7g}, roughness in log K "
            f"{out[(k, mu)]['rough_log_k']:.4g}, in log mu "
            f"{out[(k, mu)]['rough_log_mu']:.4g}")
    return out


def loss_scan(sc, steps: int, offsets=SCAN_LOG_K, log=print,
              fused: bool = True) -> list:
    """The fit loss of `sc` over `steps` steps (snapshots and hidden
    material as the fit's, the fused or the unfused step) at log K = log TRUE_K + each offset, mu at
    TRUE_MU, forward only; along each rollout, the count of active
    particles whose pressure sits on the EOS clamp +-max_pressure. One
    dict per point: log_theta (float32), k, loss, and the clamped count's
    largest and mean value over the steps."""
    dev = sc.state.device
    snaps = max(1, min(5, steps))
    sm_inv = sm_invariants(sc.state, sc.cfg)
    pmax = sc.cfg.max_pressure
    blk = steps // snaps

    def extract(s):
        return displacement(s), (s.active & (s.pres.abs() == pmax)).sum()

    with torch.no_grad():
        target = rollout_disp(sc, sm_inv, theta_of(TRUE_K, TRUE_MU, dev),
                              steps, snaps, fused)
        rows = []
        for off in offsets:
            th = np.log(np.asarray([TRUE_K, TRUE_MU], np.float32))
            th[0] = np.float32(th[0] + off)
            # a frame after every step: the clamp count along the rollout,
            # and every blk-th one's displacement for the loss
            frames = rollout_frames(sc, sm_inv, torch.from_numpy(th).to(dev),
                                    blk * snaps, 1, extract, fused)
            val = float(misfit(torch.stack([f[0] for f in
                                            frames[blk - 1::blk]]), target))
            c = torch.stack([f[1] for f in frames]).cpu().double()
            rows.append({"log_theta": th, "k": float(np.exp(th[0])),
                         "loss": val, "clamped_max": int(c.max()),
                         "clamped_mean": float(c.mean())})
            log(f"{sc.name} {steps} steps ({dev}) K={rows[-1]['k']:.5g} "
                f"mu={TRUE_MU:g}: loss {val:.7g}; on the +-{pmax:g} "
                f"pressure clamp: at most {rows[-1]['clamped_max']} of "
                f"{sc.num_particles}, mean {rows[-1]['clamped_mean']:.2f}"
                " a step")
    return rows


def _timed_ms(fn, device):
    """(fn(), wall ms) ending in a synchronize of the card."""
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scene", nargs="?", default="biceps_full")
    ap.add_argument("steps", nargs="?", type=int, default=250)
    ap.add_argument("iters", nargs="?", type=int, default=30)
    ap.add_argument("--fused", action="store_true",
                    help="the fused step with its hand-written adjoint "
                    "(default: the unfused step under autograd)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--csv", default=None, help="append a fit row here")
    ap.add_argument("--lr", type=float, default=0.15)
    ap.add_argument("--roughness", action="store_true",
                    help="print the loss's roughness instead of fitting")
    ap.add_argument("--scan", action="store_true",
                    help="print the loss along log K instead of fitting")
    args = ap.parse_args(argv)

    sc = build_scene(args.scene, device=args.device)
    dev = sc.state.device
    ensure_fp32()
    fused = args.fused
    log = lambda s: print(s, flush=True)  # noqa: E731
    if args.roughness:
        return roughness_report(sc, args.steps, log=log, fused=fused)
    if args.scan:
        return loss_scan(sc, args.steps, log=log, fused=fused)
    n, steps, iters = sc.num_particles, args.steps, args.iters
    grad_path = "fused-hand-adjoint" if fused else "torch-autodiff"
    # displacement snapshots along the rollout: a contraction's endpoint is
    # weakly sensitive to (K, mu), its path is not
    snaps = max(1, min(5, steps))
    print(f"{args.scene}: {n} particles, {steps}-step stim-on rollout, "
          f"{iters} Adam iters ({dev}); path {grad_path}", flush=True)
    # rest-shape SM moments are rollout constants with no theta dependence
    sm_inv = sm_invariants(sc.state, sc.cfg)

    theta_true = theta_of(TRUE_K, TRUE_MU, dev)
    with torch.no_grad():
        target, first_ms = _timed_ms(
            lambda: rollout_disp(sc, sm_inv, theta_true, steps, snaps,
                                 fused), dev)
        _, fwd_ms = _timed_ms(
            lambda: rollout_disp(sc, sm_inv, theta_true, steps, snaps,
                                 fused), dev)
    fwd_ms /= steps
    print(f"target: displacement field from hidden K={TRUE_K} mu={TRUE_MU} "
          f"(|disp| mean {float(target.abs().mean()):.2e}); forward "
          f"{fwd_ms:.3f} ms/step (first call {first_ms / 1e3:.1f} s)",
          flush=True)

    loss = make_loss(sc, sm_inv, target, steps, snaps, fused)
    theta0 = theta_of(*THETA0, dev)
    # the first call captures the backward step's graph
    _, first_grad_ms = _timed_ms(lambda: value_and_grad(loss, theta0), dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _, grad_ms = _timed_ms(lambda: value_and_grad(loss, theta0), dev)
    grad_ms /= steps
    peak_gib = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                if dev.type == "cuda" else float("nan"))
    print(f"value_and_grad: {grad_ms:.3f} ms/step "
          f"({grad_ms / fwd_ms:.2f}x forward; first call "
          f"{first_grad_ms / 1e3:.1f} s); peak allocated "
          + (f"{peak_gib:.3f} GiB" if dev.type == "cuda"
             else "not measured (CPU)"), flush=True)

    log_theta, losses, grads = adam_fit(
        loss, theta0, iters, args.lr, log=log)
    k, mu = torch.exp(log_theta).tolist()
    err_k, err_mu = abs(k - TRUE_K) / TRUE_K, abs(mu - TRUE_MU) / TRUE_MU
    print(f"recovered K={k:.4f} (true {TRUE_K}, {err_k * 100:.1f}% off), "
          f"mu={mu:.3f} (true {TRUE_MU}, {err_mu * 100:.1f}% off)",
          flush=True)
    if args.csv:
        append_fit_row(args.csv, [
            args.scene, n, steps, iters, round(fwd_ms, 4), round(grad_ms, 4),
            round(grad_ms / fwd_ms, 3), round(peak_gib, 3), TRUE_K,
            round(k, 5), TRUE_MU, round(mu, 4), round(err_k, 5),
            round(err_mu, 5), dev.type, grad_path])
        print(f"fit row appended to {args.csv}", flush=True)
    if iters >= 20 and max(err_k, err_mu) > 0.2:
        raise SystemExit("material recovery did not converge")
    return {"k": k, "mu": mu, "losses": [float(v) for v in losses],
            "grads": grads, "fwd_ms": fwd_ms, "grad_ms": grad_ms,
            "peak_gib": peak_gib, "grad_path": grad_path}


if __name__ == "__main__":
    main()

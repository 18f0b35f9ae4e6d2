"""Differentiable-simulation demo: fit the stimulus amplitude to a target
voltage footprint by Newton's method on the gradient THROUGH the coupled
physics (the port of examples/fit_stimulus_demo.py).

The reference's step is an imperative C++ loop (SPH_SM_monodomain.cpp:
794-824). Here the unfused coupled step (`models.monodomain.step`, plain
PyTorch) runs under autograd through `models.monodomain.simulate(...,
fused=False)` (the checkpointed adjoint scan of models/scan.py, replays
of captured graphs on the card), which differentiates a whole S-step
rollout end to end w.r.t. the initial state's `stim`: SPH density and forces, shape matching (fixed-iteration Jacobi
polar decomposition), FHN reaction, the voltage -> pressure coupling and
the integrator. The mean-voltage observable is close to linear in the
amplitude, so Newton recovers the hidden amplitude in about one step.

Run:
    python -m sph_sm_monodomain_tpu_torch.examples.fit_stimulus_demo \\
        [steps] [iters] [--scene NAME] [--device cuda|cpu]
Defaults: 20 12 on susane, on the card.
"""

from __future__ import annotations

import argparse

import torch

from ..models.monodomain import simulate
from ..ops.numerics import ensure_fp32
from ..utils.io import build_scene

TRUE_AMP = 420.0     # hidden stimulus amplitude
AMP0 = 150.0         # deliberately poor initial guess


def make_rollout(scene, steps: int):
    """amp -> the mean active Vm after `steps` unfused coupled steps with
    the stimulated particles' stim set to `amp`."""
    st0, cfg = scene.state, scene.cfg
    stim_mask = st0.stim > 0.0

    def rollout_vm(amp):
        s = st0.replace(stim=torch.where(stim_mask, amp, st0.stim))
        s = simulate(s, cfg, steps, fused=False,
                     neighbor_capacity=scene.neighbor_capacity)[0]
        vm = torch.where(s.active, s.vm, torch.zeros_like(s.vm))
        return vm.sum() / scene.num_particles
    return rollout_vm


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("steps", nargs="?", type=int, default=20)
    ap.add_argument("iters", nargs="?", type=int, default=12)
    ap.add_argument("--scene", default="susane")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    sc = build_scene(args.scene, device=args.device)
    dev = sc.state.device
    ensure_fp32()
    rollout_vm = make_rollout(sc, args.steps)
    with torch.no_grad():
        target = rollout_vm(torch.tensor(TRUE_AMP, device=dev))
    print(f"{args.scene}: {sc.num_particles} particles, {args.steps} steps "
          f"({dev}); target mean Vm {float(target):.4f} mV (hidden "
          f"amplitude {TRUE_AMP:.0f})", flush=True)

    amp = torch.tensor(AMP0, device=dev)
    for i in range(args.iters):
        a = amp.detach().requires_grad_()
        v = rollout_vm(a)
        (g,) = torch.autograd.grad(v, a)
        v = v.detach()
        # Newton step on the scalar inverse problem f(amp) = target
        amp = a.detach() - (v - target) / g
        print(f"iter {i:2d}: amplitude {float(amp):9.2f}  Vm "
              f"{float(v):9.4f}  dVm/damp {float(g):.3e}", flush=True)

    err = abs(float(amp) - TRUE_AMP) / TRUE_AMP
    print(f"recovered amplitude {float(amp):.2f} vs true {TRUE_AMP:.0f} "
          f"({err * 100:.2f}% off)", flush=True)
    return {"amp": float(amp), "err": err}


if __name__ == "__main__":
    main()

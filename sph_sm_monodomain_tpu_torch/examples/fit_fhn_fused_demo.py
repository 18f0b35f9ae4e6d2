"""Differentiable fused-kernel demo on the GPU: recover a hidden stimulus
amplitude by gradient descent through the Laplacian kernel (the port of
examples/fit_fhn_fused_demo.py).

The frozen-cloud monodomain mode (models/variants.py) runs one hand-written
Laplacian sweep per step. The kernel is opaque to autograd; the gradient
flows through `variants.LapVmFn`, whose backward pass is one more sweep of
the same kernel (the Laplacian is linear in vm). One value-and-grad of an
S-step rollout launches the kernel 2S - 1 times: the first step's input
voltage does not depend on the amplitude, so its sweep needs no backward.

The observable (mean voltage after S reaction-diffusion steps) is close to
linear in the stimulus amplitude, so Newton's method on the scalar inverse
problem recovers the hidden amplitude in about one step.

Run:
    python -m sph_sm_monodomain_tpu_torch.examples.fit_fhn_fused_demo \\
        [scene] [steps] [iters] [--device cuda|cpu]
Defaults: susane 30 8 on the card. Exits with an error unless the
amplitude comes back within 1%.
"""

from __future__ import annotations

import argparse

import torch

from ..models import variants
from ..models.monodomain import ensure_fp32
from ..utils.io import build_scene

TRUE_AMP = 420.0     # hidden stimulus amplitude
AMP0 = 150.0         # deliberately poor initial guess


def make_rollout(scene, tables, steps: int):
    """amp -> the mean active Vm after `steps` fused monodomain steps with
    the stimulated particles' stim set to `amp`."""
    st0, cfg = scene.state, scene.cfg
    stim_mask = st0.stim > 0.0

    def rollout_vm(amp):
        s = st0.replace(stim=torch.where(stim_mask, amp, st0.stim))
        out = variants.simulate_monodomain_only_fused(
            s, tables, cfg, num_steps=steps, sub_q=scene.sub_block)
        vm = torch.where(out.active, out.vm, torch.zeros_like(out.vm))
        return vm.sum() / scene.num_particles
    return rollout_vm


def value_and_grad(fn, amp):
    """(fn(amp), d fn / d amp), both detached."""
    a = amp.detach().requires_grad_()
    v = fn(a)
    (g,) = torch.autograd.grad(v, a)
    return v.detach(), g


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scene", nargs="?", default="susane")
    ap.add_argument("steps", nargs="?", type=int, default=30)
    ap.add_argument("iters", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    sc = build_scene(args.scene, device=args.device)
    dev = sc.state.device
    ensure_fp32()
    tables = variants.monodomain_prepare_fused(sc.state, sc.cfg,
                                               sub_q=sc.sub_block)
    rollout_vm = make_rollout(sc, tables, args.steps)
    with torch.no_grad():
        target = rollout_vm(torch.tensor(TRUE_AMP, device=dev))
    print(f"{args.scene}: {sc.num_particles} particles, {args.steps} steps "
          f"({dev}); target mean Vm {float(target):.4f} mV (hidden "
          f"amplitude {TRUE_AMP:.0f})", flush=True)

    amp = torch.tensor(AMP0, device=dev)
    for i in range(args.iters):
        v, g = value_and_grad(rollout_vm, amp)
        if abs(float(g)) < 1e-12:
            raise SystemExit(
                "dVm/damp vanished (observable saturated, e.g. vm clipped "
                "at max_voltage everywhere); shorten the rollout")
        amp = amp - (v - target) / g                  # Newton on f = target
        print(f"iter {i:2d}: amplitude {float(amp):9.2f}  Vm "
              f"{float(v):9.4f}  dVm/damp {float(g):.3e}", flush=True)

    err = abs(float(amp) - TRUE_AMP) / TRUE_AMP
    print(f"recovered amplitude {float(amp):.2f} vs true {TRUE_AMP:.0f} "
          f"({err * 100:.2f}% off)", flush=True)
    if err > 0.01:
        raise SystemExit("fit did not converge to 1%")
    return {"amp": float(amp), "err": err}


if __name__ == "__main__":
    main()

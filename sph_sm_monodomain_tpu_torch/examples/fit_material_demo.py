"""Differentiable-simulation demo: recover MATERIAL constants (EOS
stiffness K and viscosity mu) from an observed deformation by gradient
descent through the coupled physics (the port of
examples/fit_material_demo.py).

The reference hard-codes every constant in its constructor
(SPH_SM_monodomain.cpp:13-79). Here (K, mu) are tensor overrides
(config.PARAM_FIELDS / resolve_params) of the unfused coupled step
(`models.monodomain.step`, plain PyTorch), autograd differentiates the
whole rollout with respect to them, and the inverse problem "what material
produced this motion?" becomes a few Adam iterations in log space. The
rollout is `models.monodomain.simulate(..., fused=False)`, the counterpart
of the JAX demo's jitted scan: under autograd the checkpointed adjoint
scan of models/scan.py, replays of captured graphs on the card. The
observable is the active displacement field after a short stimulated
rollout.

Run:
    python -m sph_sm_monodomain_tpu_torch.examples.fit_material_demo \\
        [steps] [iters] [--scene NAME] [--device cuda|cpu]
Defaults: 15 60 on susane, on the card. It exits with an error unless K
and mu come back within 20%, as examples/fit_material_demo.py does.
"""

from __future__ import annotations

import argparse

import torch

from ..models.monodomain import simulate
from ..ops.numerics import ensure_fp32
from ..utils.io import build_scene

TRUE_K, TRUE_MU = 0.9, 40.0     # hidden material
THETA0 = (0.3, 150.0)           # deliberately poor initial guess


def make_rollout(scene, steps: int):
    """log (K, mu) -> the active displacement field after `steps` unfused
    coupled steps with those constants."""
    st0, cfg = scene.state, scene.cfg

    def rollout_disp(log_theta):
        theta = torch.exp(log_theta)
        params = {"k_stiffness": theta[0], "mu_viscosity": theta[1]}
        s = simulate(st0, cfg, steps, params=params, fused=False,
                     neighbor_capacity=scene.neighbor_capacity)[0]
        return torch.where(s.active[:, None], s.pos - s.orig_pos,
                           torch.zeros_like(s.pos))
    return rollout_disp


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("steps", nargs="?", type=int, default=15)
    ap.add_argument("iters", nargs="?", type=int, default=60)
    ap.add_argument("--scene", default="susane")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    sc = build_scene(args.scene, device=args.device)
    dev = sc.state.device
    ensure_fp32()
    rollout_disp = make_rollout(sc, args.steps)
    with torch.no_grad():
        target = rollout_disp(torch.log(torch.tensor([TRUE_K, TRUE_MU],
                                                     device=dev)))
    print(f"target: displacement field from hidden K={TRUE_K} mu={TRUE_MU} "
          f"(|disp| mean {float(target.abs().mean()):.2e}; {args.scene}, "
          f"{sc.num_particles} particles, {args.steps} steps, {dev})",
          flush=True)

    log_theta = torch.log(torch.tensor(THETA0, device=dev))
    m = torch.zeros(2, device=dev)                 # Adam state
    v = torch.zeros(2, device=dev)
    lr, b1, b2, eps = 0.1, 0.9, 0.999, 1e-8
    for i in range(args.iters):
        lt = log_theta.detach().requires_grad_()
        d = rollout_disp(lt) - target
        val = (d * d).sum() * 1e6                  # mm^2-scale for the logs
        (g,) = torch.autograd.grad(val, lt)
        val = val.detach()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh, vh = m / (1 - b1 ** (i + 1)), v / (1 - b2 ** (i + 1))
        log_theta = (lt - lr * mh / (torch.sqrt(vh) + eps)).detach()
        if i % 10 == 0 or i == args.iters - 1:
            k, mu = torch.exp(log_theta).tolist()
            print(f"iter {i:3d}: loss {float(val):10.4e}  K {k:7.4f}  "
                  f"mu {mu:8.3f}", flush=True)

    k, mu = torch.exp(log_theta).tolist()
    err_k, err_mu = abs(k - TRUE_K) / TRUE_K, abs(mu - TRUE_MU) / TRUE_MU
    print(f"recovered K={k:.4f} (true {TRUE_K}, {err_k * 100:.1f}% off), "
          f"mu={mu:.3f} (true {TRUE_MU}, {err_mu * 100:.1f}% off)",
          flush=True)
    if max(err_k, err_mu) > 0.2:
        raise SystemExit("material recovery did not converge")
    return {"k": k, "mu": mu, "err_k": err_k, "err_mu": err_mu}


if __name__ == "__main__":
    main()

"""Numerical-health and determinism checks (mirror of
`sph_sm_monodomain_tpu.utils.debug`).

The failure modes here are NaN/Inf blowups, neighbor-table overflow and
nondeterministic reductions, not data races: the card's sweep kernels add
their partial sums in a fixed order with no atomics, so two launches on
the same inputs give the same bits, and `check_step_determinism` compares
bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..state import ParticleState

_FIELDS = ("pos", "vel", "predicted_vel", "corrected_vel", "inter_vel",
           "acc", "dens", "pres", "vm", "inter_vm", "iion", "w")


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def validate_state(state: ParticleState, cfg=None,
                   where: str = "") -> list[str]:
    """Host-side health report: returns a list of problem strings (empty ==
    healthy). Checks NaN/Inf on active lanes, world-bounds containment, and
    physical sanity (positive density)."""
    problems = []
    act = _np(state.active)
    for name in _FIELDS:
        arr = _np(getattr(state, name))
        bad = ~np.isfinite(arr[act])
        if bad.any():
            problems.append(f"{where}{name}: {int(bad.sum())} non-finite "
                            f"values on active lanes")
    if cfg is not None:
        pos = _np(state.pos)[act]
        world = np.asarray(cfg.world_size)
        if pos.size and ((pos < 0).any() or (pos > world).any()):
            problems.append(f"{where}pos: particles outside [0, world]")
        dens = _np(state.dens)[act]
        if dens.size and (dens <= 0).any():
            problems.append(f"{where}dens: non-positive densities")
    return problems


def assert_state_healthy(state: ParticleState, cfg=None,
                         where: str = "") -> None:
    problems = validate_state(state, cfg, where)
    if problems:
        raise AssertionError("unhealthy state: " + "; ".join(problems))


def check_step_determinism(step_fn, state: ParticleState, reps: int = 3,
                           fields=("pos", "vel", "vm")) -> bool:
    """Run the same step `reps` times from the same state and verify
    bit-identical outputs."""
    outs = [step_fn(state) for _ in range(reps)]
    outs = [o[0] if isinstance(o, tuple) else o for o in outs]
    ref = outs[0]
    for o in outs[1:]:
        for f in fields:
            if not torch.equal(getattr(ref, f), getattr(o, f)):
                return False
    return True


def nan_guard(fn):
    """Wrap a step function to raise FloatingPointError on non-finite
    positions/voltages of active rows. The verdict is read on the host, so
    the raise happens at the call site; the per-call device->host sync is
    the point of this debug tool."""
    def wrapped(state, *args, **kw):
        out = fn(state, *args, **kw)
        st = out[0] if isinstance(out, tuple) else out
        zero = torch.zeros((), dtype=st.pos.dtype, device=st.device)
        ok = torch.isfinite(torch.where(st.active[:, None], st.pos,
                                        zero)).all()
        ok &= torch.isfinite(torch.where(st.active, st.vm, zero)).all()
        if not bool(ok):
            raise FloatingPointError("non-finite state after step")
        return out
    return wrapped

"""A correctly rounded square root for the port's CPU paths.

This build's CPU float32 `torch.sqrt` is not correctly rounded: about 0.7%
of inputs come out 1 ulp off, and in a few fresh processes it returned
values up to 3.1e-4 relative off on about 12% of a (256, 256) input
(`python tests/test_torch_cpu_sqrt.py` prints the table). Every float32
square root of the port goes through `sqrt_rn`, which on a CPU tensor
rounds the float64 square root, refined by two Newton steps, once to
float32: the value CUDA's IEEE `sqrtf` gives. On a CUDA tensor it is
`torch.sqrt`.

`torch.rsqrt` (the plain sweeps' 1/r) stays as it is: the same probe finds
it within 1 ulp of the correctly rounded 1/sqrt in every process, inside
the 2 ulp that CUDA's `rsqrtf` is allowed.
"""

from __future__ import annotations

import torch


def _sqrt_rn_cpu(x: torch.Tensor) -> torch.Tensor:
    """float64 sqrt of x, two Newton steps, rounded once to x's dtype; the
    Newton steps are skipped where the sqrt is 0, inf or NaN."""
    xd = x.double()
    r = torch.sqrt(xd)
    ok = torch.isfinite(r) & (r > 0.0)
    safe = torch.where(ok, r, torch.ones_like(r))
    for _ in range(2):
        safe = 0.5 * (safe + xd / safe)
    return torch.where(ok, safe, r).to(x.dtype)


class _SqrtRN(torch.autograd.Function):
    """sqrt with torch.sqrt's derivative, grad / (2 sqrt(x)), taken on the
    correctly rounded result."""

    @staticmethod
    def forward(ctx, x):
        y = _sqrt_rn_cpu(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        (y,) = ctx.saved_tensors
        return grad / (2.0 * y)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root of a float32 tensor on the CPU (see the
    module docstring), differentiable; `torch.sqrt` on a CUDA tensor and
    for other dtypes."""
    if x.device.type != "cpu" or x.dtype != torch.float32:
        return torch.sqrt(x)
    return _SqrtRN.apply(x)

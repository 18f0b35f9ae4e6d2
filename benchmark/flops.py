"""The yardstick's arithmetic, frozen: the pairs a sweep needs, counted from
the positions alone, the operations and bytes of each kernel, and the
card's published peaks.

A pair's operations are charged from its geometry, never from the slots a
kernel walks, so the count is the same whatever implements the work:
every pair whose cells (edge cell_size, float32 division, truncated)
differ by at most one along each axis pays its distance and support test
(10), and inside the support of the kernel's weights what the kernel
body computes there (a fused multiply-add counts 2; rsqrt, sqrt, max and
a compare-select 1):
  sweep_a3     K1: 15 for r < h (Poly6 density + XSPH)
  sweep_b3     K2: 40 for 1e-12 < r^2 < 4h^2 (Spiky pressure, viscosity,
               the B-spline Vm Laplacian)
  sweep_lap3   K3: 16 for 1e-12 < r^2 < 4h^2
  sweep_bwd_a  K4: 43 for r < h
  sweep_bwd_b  K5: 129 for 1e-12 < r^2 < 4h^2
(frozen from the package's tools/roofline.PAIR_FLOPS). Bytes: each of a
kernel's three row matrices (queries, candidate features, output: 16
float32 columns of every padded row) once, its windows (two int32 a
sub-block and slow-plane offset, four slots) and its 32 float32 constants.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores and the HBM3
# rate, both at the 700 W power limit
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
PAIR_FLOPS = {
    "sweep_a3": (("full", 10), ("h", 15)),
    "sweep_b3": (("full", 10), ("2h", 40)),
    "sweep_lap3": (("full", 10), ("2h", 16)),
    "sweep_bwd_a": (("full", 10), ("h", 43)),
    "sweep_bwd_b": (("full", 10), ("2h", 129)),
}
SUB_Q = 128
_PAIR_EPS = 1e-12


@torch.no_grad()
def pair_counts(pos: torch.Tensor, cell_size: float, kernel_h: float,
                dims, block: int = 1 << 20) -> dict:
    """{"full": ordered pairs of the 27-cell stencil (self pairs
    included), "h": of those, r^2 < h^2, "2h": 1e-12 < r^2 < 4h^2} of the
    live float32 positions `pos`, from a cell list; `dims` the grid's
    cells along each axis. Queries go `block` at a time."""
    n = pos.shape[0]
    cell = torch.tensor(cell_size, dtype=torch.float32, device=pos.device)
    c = (pos / cell).to(torch.int64) + 1
    g0, g1 = dims[0] + 3, dims[1] + 3
    key = c[:, 0] + g0 * (c[:, 1] + g1 * c[:, 2])
    sk, order = torch.sort(key, stable=True)
    h2 = kernel_h * kernel_h
    acc = torch.zeros(3, dtype=torch.int64, device=pos.device)
    for q0 in range(0, n, block):
        rows = torch.arange(q0, min(n, q0 + block), device=pos.device)
        for dz in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    nk = key[rows] + (dx + g0 * (dy + g1 * dz))
                    lo = torch.searchsorted(sk, nk)
                    cnt = torch.searchsorted(sk, nk, right=True) - lo
                    total = int(cnt.sum())
                    i = torch.repeat_interleave(rows, cnt, output_size=total)
                    first = torch.cumsum(cnt, 0) - cnt
                    k = torch.arange(total, device=pos.device) \
                        - torch.repeat_interleave(first, cnt,
                                                  output_size=total)
                    j = order[torch.repeat_interleave(lo, cnt,
                                                      output_size=total) + k]
                    d = pos[i] - pos[j]
                    r2 = (d * d).sum(-1)
                    acc += torch.stack([
                        torch.tensor(total, device=pos.device),
                        (r2 < h2).sum(),
                        ((r2 > _PAIR_EPS) & (r2 < 4.0 * h2)).sum()])
    return dict(zip(("full", "h", "2h"), acc.tolist()))


def kernel_flops(kernel: str, counts: dict) -> int:
    """Operations the kernel needs for these pair counts."""
    return sum(counts[k] * f for k, f in PAIR_FLOPS[kernel])


def kernel_bytes(rows: int, sub_q: int = SUB_Q) -> int:
    """Bytes a sweep kernel reads and writes once over `rows` padded rows."""
    return 3 * 16 * 4 * rows + 2 * 4 * 4 * (rows // sub_q) + 32 * 4


def least_seconds(kernel: str, counts: dict, rows: int) -> float:
    """The least time the card could take: the larger of the operations
    over the float32 peak and the bytes over the memory rate."""
    return max(kernel_flops(kernel, counts) / PEAK_FLOPS,
               kernel_bytes(rows) / PEAK_BYTES)

"""Small dense linear algebra for shape matching (mirror of
`sph_sm_monodomain_tpu.ops.linalg`, `:42-199`; reference m3Matrix.cpp:3-113,
m9Matrix.cpp:10-102).

Fixed-iteration semantics are kept, and `torch.linalg.eigh` is not used:
  - `jacobi_eigh` runs a FIXED number of max-off-diagonal-pivot rotations,
    skipping (identity) once the largest off-diagonal is exactly zero;
  - `jacobi_eigh3_cyclic` runs the static pivot cycle (0,1), (0,2), (1,2);
  - `polar_decomposition` builds S^-1 from the eigensystem of A^T A with
    lambda <= 0 directions zeroed, and R = A S^-1, not re-orthonormalized;
  - `pseudo_inverse` zeroes the reciprocal of exactly-zero eigenvalues;
  - `invert3` leaves a singular matrix unchanged.

`det3`, `invert3`, `jacobi_eigh3_cyclic` and `polar_decomposition` take a
(..., 3, 3) batch (one matrix per shape-matching cluster) with the same op
sequence per matrix, so a batch costs the launches of one matrix. Their
3x3 products go through `small_matmul`, one fixed chain of fused
multiply-adds: a batched `@` may round in another way than a single one
(MKL's batched GEMM does on AVX-512 hosts), and then a batch would not
give the bits of its matrices one at a time.
All matrix products run in full fp32 (the port never enables TF32).
"""

from __future__ import annotations

import torch

from .numerics import sqrt_rn


def small_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for a short inner dimension k ((..., m, k) @ (..., k, n)) in
    float32, as a chain of fused multiply-adds in the order 0..k-1:
    round(a0 b0), then fma(a_i, b_i, acc). That is how XLA's CPU dot and
    MKL's single-matrix product round a 3x3 product; a batched `@` may sum
    otherwise (MKL's batched GEMM on AVX-512 rounds each product and sum
    apart), so a batch would not give the bits of its matrices one at a
    time. Each fma is taken in float64, where a float32 product is exact,
    then rounded once to float32 (a double rounding can differ from a true
    fma only when the float64 sum lands exactly on a float32 midpoint)."""
    if a.dtype != torch.float32:
        return a @ b
    prods = a[..., :, :, None] * b.double()[..., None, :, :]
    acc = prods[..., 0, :].float()
    for i in range(1, a.shape[-1]):
        acc = (prods[..., i, :] + acc).float()
    return acc


def det3(A: torch.Tensor) -> torch.Tensor:
    """3x3 determinant (m3Matrix.h:288-291) of each matrix of a (..., 3, 3)
    batch."""
    def a(i, j):
        return A[..., i, j]
    return (a(0, 0) * (a(1, 1) * a(2, 2) - a(2, 1) * a(1, 2))
            - a(0, 1) * (a(1, 0) * a(2, 2) - a(2, 0) * a(1, 2))
            + a(0, 2) * (a(1, 0) * a(2, 1) - a(1, 1) * a(2, 0)))


def invert3(A: torch.Tensor) -> torch.Tensor:
    """Analytic 3x3 inverse of each matrix of a (..., 3, 3) batch; a
    singular matrix comes back unchanged (m3Matrix.h:293-318; the caller at
    cpp:308 ignores the failure)."""
    def a(i, j):
        return A[..., i, j]
    d = det3(A)
    ok = d != 0.0
    inv_d = torch.where(ok, 1.0 / torch.where(ok, d, torch.ones_like(d)),
                        torch.zeros_like(d))
    adj = torch.stack([
        torch.stack([a(1, 1) * a(2, 2) - a(1, 2) * a(2, 1),
                     -(a(0, 1) * a(2, 2) - a(0, 2) * a(2, 1)),
                     a(0, 1) * a(1, 2) - a(0, 2) * a(1, 1)], dim=-1),
        torch.stack([-(a(1, 0) * a(2, 2) - a(1, 2) * a(2, 0)),
                     a(0, 0) * a(2, 2) - a(0, 2) * a(2, 0),
                     -(a(0, 0) * a(1, 2) - a(0, 2) * a(1, 0))], dim=-1),
        torch.stack([a(1, 0) * a(2, 1) - a(1, 1) * a(2, 0),
                     -(a(0, 0) * a(2, 1) - a(0, 1) * a(2, 0)),
                     a(0, 0) * a(1, 1) - a(0, 1) * a(1, 0)], dim=-1),
    ], dim=-2)
    return torch.where(ok[..., None, None], adj * inv_d[..., None, None], A)


def _rotation(apq, diff):
    """Jacobi rotation (t, c, s) for pivot value `apq` and diagonal
    difference `diff`. The divisor magnitude is floored so |d| stays finite
    (beyond |d| ~ 1e6 the angle is below fp32 resolution anyway)."""
    live = apq.abs() > 0.0
    mag = torch.maximum(apq.abs(),
                        torch.clamp(diff.abs() * 5e-7, min=1e-30))
    d = diff / (2.0 * torch.where(apq < 0.0, -mag, mag))
    t = 1.0 / (d.abs() + sqrt_rn(d * d + 1.0))
    t = torch.where(d < 0.0, -t, t)
    return live, t


def jacobi_eigh(A: torch.Tensor, iterations: int = 20, pivots=None):
    """Max-pivot Jacobi eigendecomposition of a symmetric n x n matrix
    (m3Matrix / m9Matrix::eigenDecomposition): `iterations` rotations, each
    on the largest |off-diagonal| (first in row-major order on ties).
    Returns (eigenvalues (n,), R (n, n)) with A ~= R diag(vals) R^T.
    `pivots`, a list, receives each rotation's (p, q) as 0-dim tensors."""
    n = A.shape[0]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    upper = torch.triu(torch.ones((n, n), dtype=torch.bool,
                                  device=A.device), diagonal=1)
    R = eye
    neg = torch.full_like(A, -1.0)
    for _ in range(iterations):
        idx = torch.argmax(torch.where(upper, A.abs(), neg).reshape(-1))
        p, q = idx // n, idx % n
        if pivots is not None:
            pivots.append((p, q))
        apq = A[p, q]
        live, t = _rotation(apq, A[p, p] - A[q, q])
        c = 1.0 / sqrt_rn(t * t + 1.0)
        s = t * c
        c = torch.where(live, c, torch.ones_like(c))
        s = torch.where(live, s, torch.zeros_like(s))
        G = eye.clone()
        G[p, p] = c
        G[q, q] = c
        G[q, p] = s
        G[p, q] = -s
        A = G.T @ A @ G
        # the reference zeroes the pivot pair exactly (m3Matrix.cpp:14)
        A[p, q] = 0.0
        A[q, p] = 0.0
        R = R @ G
    return torch.diagonal(A), R


def jacobi_eigh3_cyclic(A: torch.Tensor, sweeps: int = 7):
    """Cyclic-pivot Jacobi eigendecomposition of each symmetric 3x3 of a
    (..., 3, 3) batch: the static pivot cycle (0,1), (0,2), (1,2) repeated
    `sweeps` times, on (...)-shaped entries, so the op count does not
    depend on the batch. Returns (eigenvalues (..., 3), R (..., 3, 3))."""
    a = {(i, j): A[..., i, j] for i, j in ((0, 0), (1, 1), (2, 2), (0, 1),
                                            (0, 2), (1, 2))}
    one, zero = torch.ones_like(a[(0, 0)]), torch.zeros_like(a[(0, 0)])
    r = {(i, j): one if i == j else zero for i in range(3) for j in range(3)}

    def key(i, j):
        return (i, j) if i <= j else (j, i)

    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            k = 3 - p - q
            apq = a[(p, q)]
            live, t = _rotation(apq, a[(p, p)] - a[(q, q)])
            t = torch.where(live, t, zero)
            c = 1.0 / sqrt_rn(t * t + 1.0)
            s = t * c
            a[(p, p)] = a[(p, p)] + t * apq
            a[(q, q)] = a[(q, q)] - t * apq
            a[(p, q)] = zero
            akp, akq = a[key(k, p)], a[key(k, q)]
            a[key(k, p)] = c * akp + s * akq
            a[key(k, q)] = -s * akp + c * akq
            for kk in range(3):
                rkp, rkq = r[(kk, p)], r[(kk, q)]
                r[(kk, p)] = c * rkp + s * rkq
                r[(kk, q)] = -s * rkp + c * rkq

    lam = torch.stack([a[(0, 0)], a[(1, 1)], a[(2, 2)]], dim=-1)
    R = torch.stack([torch.stack([r[(i, j)] for j in range(3)], dim=-1)
                     for i in range(3)], dim=-2)
    return lam, R


def polar_decomposition(A: torch.Tensor, iterations: int = 20):
    """A = R S with R 'orthonormal' and S symmetric (m3Matrix.cpp:73-113),
    for each matrix of a (..., 3, 3) batch. Returns (R, S); lambda <= 0
    directions contribute zero (cpp:90-92)."""
    At = A.transpose(-1, -2)
    lam, U = jacobi_eigh3_cyclic(small_matmul(At, A),
                                 sweeps=max(iterations // 3, 5))
    nonpos = lam <= 0.0
    inv_sqrt = torch.where(
        nonpos, torch.zeros_like(lam),
        1.0 / sqrt_rn(torch.where(nonpos, torch.ones_like(lam), lam)))
    S1 = small_matmul(U * inv_sqrt[..., None, :], U.transpose(-1, -2))
    R = small_matmul(A, S1)
    S = small_matmul(R.transpose(-1, -2), A)
    return R, S


def pseudo_inverse(A: torch.Tensor, iterations: int = 20,
                   pivots=None) -> torch.Tensor:
    """Symmetric pseudo-inverse via Jacobi eigendecomposition
    (m9Matrix::invert, m9Matrix.cpp:80-102) of an (n, n) matrix, or of each
    matrix of a (K, n, n) batch in turn: the max-pivot Jacobi picks a
    different pivot per matrix, and this runs once per run (the rest-shape
    invariants), so the batch is a loop. `pivots` as in jacobi_eigh (a
    batch's matrices one after another)."""
    if A.dim() == 3:
        return torch.stack([pseudo_inverse(a, iterations, pivots)
                            for a in A])
    lam, R = jacobi_eigh(A, iterations, pivots)
    nz = lam != 0.0
    d = torch.where(nz, 1.0 / torch.where(nz, lam, torch.ones_like(lam)),
                    torch.zeros_like(lam))
    return (R * d[None, :]) @ R.T

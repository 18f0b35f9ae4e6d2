"""The superseded v1 / v2 neighbor sweeps (mirror of
`sph_sm_monodomain_tpu.ablation.legacy_sweeps`), kept as ablation
baselines.

v1: per-query exact run bounds (`sweep_bookkeeping`: nine (N, 16) run
    starts / ends, one per (dy, dz) row of the query's 27-cell stencil),
    raw pair sums with no epilogue (`sweep_a` / `sweep_b`).
v2: v3's nine hash run windows per sub-block (ops/sweeps.
    sweep_bookkeeping2) with the linear-hash mask, raw pair sums with no
    epilogue (`sweep_a2` / `sweep_b2`).

Sweep A returns (dens (N,), xsph (N, 3)): the Poly6 density (the query's
own row included, no separate self term) and the XSPH velocity sum. Sweep
B returns (acc_raw (N, 3), lap (N,)): the pressure + viscosity
acceleration before the division by the query's density, and the B-spline
Vm Laplacian. All in sorted order; ablation/legacy_steps.py runs the
pointwise glue between and after them in PyTorch.

On a CUDA tensor each sweep is one hand-written kernel
(csrc/legacy_sweeps.cu); on a CPU tensor the wrapper runs the plain
PyTorch version in this module (`sweep_a_plain` ... `sweep_b2_plain`),
which the tests hold to the JAX package and chip_smoke.py holds the
kernels to. Left out, as TPU-only: the Pallas calls' VMEM/HBM split of the
candidate features and its per-chunk `make_async_copy`, the feature
padding by one `w_chunk`, the 900 kB scalar-memory budget checks, the
`q_block` / `w_chunk` / `interpret` arguments, and `q_slice` (the
multi-device row slab, which waits for the multi-device port).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig
from ..ops import cuda_lib
from ..ops.constants import const_tensor
from ..ops.fused_step import (_Phys, _check_cuda_operands,
                              _check_sweep_inputs, _crow, _dense_sums,
                              _launch, _qcol, _rows_per_chunk, _terms_a,
                              _terms_b, _window_mask, kernel_params)
from ..ops.numerics import sqrt_rn
from ..ops.sweeps import _PAIR_EPS, RUN_OFFSETS, _sort_cells


def _run_hashes(gx: int, gy: int) -> tuple:
    """Hash offset Gx*(dy + Gy*dz) of each of the nine (dy, dz) runs."""
    return tuple(gx * (dy + gy * dz) for dy, dz in RUN_OFFSETS)


def sweep_bookkeeping(pos: torch.Tensor, active: torch.Tensor,
                      cfg: SimConfig, sub_q: int):
    """Sort + per-query run bookkeeping for the v1 sweeps (the JAX
    package's `sweep_bookkeeping`, equal to it exactly).

    Returns (order, inv, qstart, qend, blk_start, blk_len):
      order / inv (N,) int64   as in ops.sweeps.sweep_bookkeeping3
      qstart/qend (N, 16)      int32 per sorted query: sorted rows
                               [qstart, qend) of its nine (dy, dz) runs
                               (9 used columns); empty for a dead query
      blk_start (B, 16)        int32 per sub-block of `sub_q` rows: the
                               first row of each run window of its hash
                               interval, rounded down to a multiple of 128
      blk_len (B, 16)          int32 rows from blk_start to the window end
    The hash is x-major, x + Gx*(y + Gy*z) (no hash_axis_perm); cell
    coordinates truncate toward zero, after a true fp32 division by the
    cell size. A cell's first sorted row is the left `searchsorted` of its
    hash, which is what the JAX package's scatter + reverse cummin table
    holds. The block windows are supersets of their queries' runs; the CUDA
    kernels walk the runs and do not read them."""
    n = pos.shape[0]
    gx, gy, gz = cfg.grid_size
    num_cells = cfg.num_cells
    dev = pos.device
    coords = (pos / const_tensor(cfg.cell_size, dev)).to(torch.int32)
    x, y, z = coords.unbind(-1)
    inside = (x >= 0) & (x < gx) & (y >= 0) & (y < gy) & (z >= 0) & (z < gz)
    ids = torch.where(inside & active, x + gx * (y + gy * z),
                      torch.full_like(x, num_cells))
    sorted_ids, order, inv = _sort_cells(ids)

    def first_row(h):
        return torch.searchsorted(sorted_ids, h.contiguous(), out_int32=True)

    # per-query exact run bounds, queries in sorted order
    cs = coords[order]
    off = const_tensor(RUN_OFFSETS, dev, torch.int32)             # (9, 2)
    yy = cs[:, 1:2] + off[None, :, 0]
    zz = cs[:, 2:3] + off[None, :, 1]
    q_ok = (sorted_ids < num_cells)[:, None] & (yy >= 0) & (yy < gy) \
        & (zz >= 0) & (zz < gz)
    xlo = torch.clamp(cs[:, 0] - 1, min=0)[:, None]
    xhi = torch.clamp(cs[:, 0] + 1, max=gx - 1)[:, None]
    row = gx * (yy + gy * zz)
    zero = torch.zeros_like(row)
    qstart = first_row(torch.where(q_ok, xlo + row, zero))
    qend = torch.where(q_ok, first_row(torch.where(q_ok, xhi + row + 1,
                                                   zero)), qstart)

    # per-block superset windows: the block's hash interval +- one x cell,
    # shifted by the run offset
    b = n // sub_q
    h_lo = sorted_ids[::sub_q][:b]
    h_hi = sorted_ids[sub_q - 1::sub_q][:b]
    d = const_tensor(_run_hashes(gx, gy), dev, torch.int32)[None, :]
    blk_start = first_row(torch.clamp(h_lo[:, None] + d - 1, 0, num_cells))
    blk_end = first_row(torch.clamp(h_hi[:, None] + d + 2, 0, num_cells))
    blk_start = (blk_start // 128) * 128   # the JAX package's lane alignment
    pad16 = lambda a: torch.nn.functional.pad(a, (0, 7))  # noqa: E731
    return (order, inv, pad16(qstart), pad16(qend), pad16(blk_start),
            pad16(blk_end - blk_start))


def auto_sweep2_params(positions: np.ndarray, cfg: SimConfig,
                       sub_q: int = 32) -> tuple[int, int]:
    """(sub_q, w_chunk) for the v2 sweeps, host-side, once per scene: the
    JAX package's tuner (enumerated candidate lanes plus a per-chunk
    overhead over w_chunk in {128, 256, 384}), in working form: the JAX
    module calls numpy without importing it. Its cost constants were fit on
    the TPU; the port's v2 kernels walk each window exactly and do not read
    `w_chunk`."""
    gx, gy, gz = cfg.grid_size
    num_cells = cfg.num_cells
    coords = (np.asarray(positions) / cfg.cell_size).astype(np.int64)
    inside = ((coords >= 0).all(1) & (coords[:, 0] < gx)
              & (coords[:, 1] < gy) & (coords[:, 2] < gz))
    ids = np.where(inside, coords[:, 0] + gx * (coords[:, 1]
                                                + gy * coords[:, 2]),
                   num_cells)
    s = np.sort(ids)
    b = max(len(s) // sub_q, 1)
    h_lo = s[::sub_q][:b]
    h_hi = s[sub_q - 1::sub_q][:b]
    d = np.asarray(_run_hashes(gx, gy), np.int64)[None, :]
    lo = np.searchsorted(s, np.clip(h_lo[:, None] + d - 1, 0, num_cells))
    hi = np.searchsorted(s, np.clip(h_hi[:, None] + d + 2, 0, num_cells))
    start = (lo // 128) * 128
    best = None
    for wc in (128, 256, 384):
        trips = np.maximum(0, -(-(hi - start) // wc))
        cost = (trips * wc).sum() + trips.sum() * 40
        if best is None or cost < best[0]:
            best = (cost, wc)
    return sub_q, best[1]


# --- layouts -------------------------------------------------------------------

def _feat_rows(cols, n: int, like: torch.Tensor) -> torch.Tensor:
    """(16, N) candidate features: the given (N,) rows, then zero rows."""
    z = like.new_zeros((n,))
    return torch.stack(list(cols) + [z] * (16 - len(cols)), dim=0)


def _query_cols(cols, n: int, like: torch.Tensor, hash_s=None):
    """(N, 16) query matrix: the given (N, k) blocks, zeros, and the v2
    linear hash in column 12."""
    q = torch.cat(list(cols), dim=1)
    q = torch.cat([q, like.new_zeros((n, 16 - q.shape[1]))], dim=1)
    if hash_s is not None:
        q[:, 12] = hash_s
    return q


def _inputs_a(pos_s, cvel_s, vol_s, mass_s, hash_s=None):
    """QM (N, 16) [pos3 | cvel3 | - ... | hash@12 (v2)] and sweep-A
    features (16, N) [pos3 | cvel3 | vol | mass | - - - - | hash@12 (v2)
    | - - -]."""
    n = pos_s.shape[0]
    cols = [pos_s[:, 0], pos_s[:, 1], pos_s[:, 2], cvel_s[:, 0],
            cvel_s[:, 1], cvel_s[:, 2], vol_s, mass_s]
    if hash_s is not None:
        z = torch.zeros_like(vol_s)
        cols += [z, z, z, z, hash_s]
    return (_query_cols([pos_s, cvel_s], n, pos_s, hash_s),
            _feat_rows(cols, n, pos_s))


def _inputs_b(pos_s, ivel_s, vol_s, pres_s, vm_s, hash_s=None):
    """QM (N, 16) [pos3 | ivel3 | pres | vm | - ... | hash@12 (v2)] and
    sweep-B features (16, N) [pos3 | ivel3 | vol | pres | vm | - - - |
    hash@12 (v2) | - - -]."""
    n = pos_s.shape[0]
    cols = [pos_s[:, 0], pos_s[:, 1], pos_s[:, 2], ivel_s[:, 0],
            ivel_s[:, 1], ivel_s[:, 2], vol_s, pres_s, vm_s]
    if hash_s is not None:
        z = torch.zeros_like(vol_s)
        cols += [z, z, z, hash_s]
    return (_query_cols([pos_s, ivel_s, pres_s[:, None], vm_s[:, None]], n,
                        pos_s, hash_s),
            _feat_rows(cols, n, pos_s))


# --- plain versions --------------------------------------------------------------

def _terms_b1(q, c, m, P: _Phys) -> torch.Tensor:
    """(..., R, 4) [a_ax, a_ay, a_az, a_lap] of v1's sweep B
    (legacy_sweeps.py:239-272): r from an IEEE sqrt and 1/r from a
    division, Spiky support r <= h, the B-spline in its piecewise form with
    support q < 2, and 1/h an fp32 division; summed per pair in difference
    form (as _terms_b), not in the Pallas kernel's sum-then-subtract form."""
    dx = _qcol(q, 0) - _crow(c, 0)
    dy = _qcol(q, 1) - _crow(c, 1)
    dz = _qcol(q, 2) - _crow(c, 2)
    r2 = dx * dx + dy * dy + dz * dz
    p = m & (r2 > _PAIR_EPS)                                    # cpp:546
    rr = sqrt_rn(torch.where(p, r2, torch.ones_like(r2)))
    inv_rr = 1.0 / rr
    vol = _crow(c, 6)
    zero = torch.zeros_like(r2)
    hr = P.kernel_h - rr
    common = torch.where(p & (rr <= P.kernel_h), vol * (P.spiky * hr), zero)
    f_p = common * (hr * (-0.5) * inv_rr) * (_qcol(q, 6) + _crow(c, 7))
    f_v = P.mu_viscosity * common
    cols = [(f_v * (_crow(c, 3 + k) - _qcol(q, 3 + k)) - f_p * d).sum(-1)
            for k, d in enumerate((dx, dy, dz))]
    qr = rr * (1.0 / P.kernel_h)
    w2 = torch.where(qr < 1.0, P.bspline * (-3.0 + 4.5 * qr),
                     torch.where(qr < 2.0, P.bspline * 1.5 * (2.0 - qr),
                                 zero))
    vw = torch.where(p, vol * w2, zero)
    cols.append((vw * (_crow(c, 8) - _qcol(q, 7))).sum(-1))
    return torch.stack(cols, dim=-1)


def _run_sums(qm, feats, qstart, qend, terms) -> torch.Tensor:
    """(N, 4) pair sums of each query row of qm (N, 16) over the candidates
    of its nine runs [qstart, qend), dense over every candidate in row
    chunks. A candidate lies in at most one run of a query (the runs cover
    distinct (y, z) cell rows)."""
    n = qm.shape[0]
    rows = _rows_per_chunk(9 * n, qm.device)
    j = torch.arange(n, dtype=torch.int32, device=qm.device)
    out = []
    for s in range(0, n, rows):
        qs = qstart[s:s + rows, :9, None]
        qe = qend[s:s + rows, :9, None]
        m = ((j >= qs) & (j < qe)).any(dim=1)                   # (rows, N)
        out.append(terms(qm[s:s + rows], feats, m))
    return torch.cat(out)


def plain_on_run_rows(plain, qm, feats, qstart, qend, rows) -> torch.Tensor:
    """plain(qm, feats, qstart, qend) (`_plain_a1` / `_plain_b1`) of the
    query rows `rows` only, for a cloud whose dense plain sums over every
    row would take minutes. `_run_sums` pairs query rows with the
    candidates of the same index range, so this takes the candidates of
    the rows' runs, renumbered in order (each run stays one range), pads
    the queries with empty runs and the candidates with zero columns to
    as many rows, and keeps the first len(rows) sums."""
    s, e = qstart[rows, :9], qend[rows, :9]
    runs = [torch.arange(a, b, device=qm.device)
            for a, b in zip(s.flatten().tolist(), e.flatten().tolist())
            if b > a]
    cand = (torch.unique(torch.cat(runs)) if runs
            else torch.zeros(0, dtype=torch.int64, device=qm.device))
    m, c = rows.numel(), max(cand.numel(), rows.numel())
    ne = e > s
    bounds = [torch.zeros((c, 16), dtype=torch.int32, device=qm.device)
              for _ in range(2)]
    for b, t in zip(bounds, (s, e)):
        b[:m, :9] = torch.where(ne, torch.searchsorted(cand, t.long()),
                                0).to(torch.int32)
    q = qm.new_zeros((c, 16))
    q[:m] = qm[rows]
    f = feats.new_zeros((16, c))
    f[:, :cand.numel()] = feats[:, cand]
    return plain(q, f, *bounds)[:m]


def _hash9_sums(qm, feats, cfg: SimConfig, terms) -> torch.Tensor:
    """(N, 4) pair sums of every query row over every candidate under v3's
    hash9 stencil."""
    return _dense_sums(qm, feats, _window_mask(cfg, "hash9", True), terms)


def _phys(cfg: SimConfig, device) -> _Phys:
    return _Phys(kernel_params(cfg, None, device))


def _plain_a1(qm, feats, qstart, qend, cfg: SimConfig) -> torch.Tensor:
    P = _phys(cfg, qm.device)
    return _run_sums(qm, feats, qstart, qend,
                     lambda q, c, m: _terms_a(q, c, m, P))


def _plain_b1(qm, feats, qstart, qend, cfg: SimConfig) -> torch.Tensor:
    P = _phys(cfg, qm.device)
    return _run_sums(qm, feats, qstart, qend,
                     lambda q, c, m: _terms_b1(q, c, m, P))


def _plain_a2(qm, feats, cfg: SimConfig) -> torch.Tensor:
    P = _phys(cfg, qm.device)
    return _hash9_sums(qm, feats, cfg, lambda q, c, m: _terms_a(q, c, m, P))


def _plain_b2(qm, feats, cfg: SimConfig) -> torch.Tensor:
    P = _phys(cfg, qm.device)
    return _hash9_sums(qm, feats, cfg,
                       lambda q, c, m: _terms_b(q, c, m, P, True))


def sweep_a_plain(pos_s, cvel_s, vol_s, mass_s, qstart, qend,
                  cfg: SimConfig):
    """Plain PyTorch v1 sweep A: (dens (N,), xsph (N, 3)) of each query
    over the candidates of its runs (sweep_bookkeeping's qstart / qend),
    K1's pair math (the same function as the Pallas body)."""
    s = _plain_a1(*_inputs_a(pos_s, cvel_s, vol_s, mass_s), qstart, qend,
                  cfg)
    return s[:, 0], s[:, 1:4]


def sweep_b_plain(pos_s, ivel_s, vol_s, pres_s, vm_s, qstart, qend,
                  cfg: SimConfig):
    """Plain PyTorch v1 sweep B: (acc_raw (N, 3), lap (N,)), v1's own pair
    math (_terms_b1)."""
    s = _plain_b1(*_inputs_b(pos_s, ivel_s, vol_s, pres_s, vm_s), qstart,
                  qend, cfg)
    return s[:, 0:3], s[:, 3]


def sweep_a2_plain(pos_s, cvel_s, vol_s, mass_s, hash_s, cfg: SimConfig):
    """Plain PyTorch v2 sweep A: (dens (N,), xsph (N, 3)) over every
    candidate under the hash9 stencil (both rows live), K6's pair math."""
    s = _plain_a2(*_inputs_a(pos_s, cvel_s, vol_s, mass_s, hash_s), cfg)
    return s[:, 0], s[:, 1:4]


def sweep_b2_plain(pos_s, ivel_s, vol_s, pres_s, vm_s, hash_s,
                   cfg: SimConfig):
    """Plain PyTorch v2 sweep B: (acc_raw (N, 3), lap (N,)), K6's pair
    math."""
    s = _plain_b2(*_inputs_b(pos_s, ivel_s, vol_s, pres_s, vm_s, hash_s),
                  cfg)
    return s[:, 0:3], s[:, 3]


# --- wrappers --------------------------------------------------------------------

def _check_run_inputs(qm, feats, qstart, qend, blk_start, blk_len) -> None:
    """Shapes of a v1 sweep: (N, 16) run bounds, (16, N) features, (B, 16)
    block windows with B dividing N."""
    n = qm.shape[0]
    if n == 0 or tuple(feats.shape) != (16, n):
        raise ValueError(f"features must be (16, {n}), got "
                         f"{tuple(feats.shape)}")
    for name, t in (("qstart", qstart), ("qend", qend)):
        if tuple(t.shape) != (n, 16):
            raise ValueError(f"{name} must be ({n}, 16), got "
                             f"{tuple(t.shape)}")
    b = blk_start.shape[0] if blk_start.dim() == 2 else 0
    for name, t in (("blk_start", blk_start), ("blk_len", blk_len)):
        if tuple(t.shape) != (b, 16) or b == 0 or n % b:
            raise ValueError(f"{name} must be (B, 16) with B dividing {n}, "
                             f"got {tuple(t.shape)}")
    _check_cuda_operands(qm, ("feats", feats, torch.float32),
                         ("qstart", qstart, torch.int32),
                         ("qend", qend, torch.int32))


def _run_sweep(name: str, qm, feats, qstart, qend, cfg: SimConfig):
    """Launch the v1 sweep kernel `name`: (N, 4) raw pair sums."""
    return _launch(getattr(cuda_lib.load(), name), qm, feats, qstart, qend,
                   kernel_params(cfg, None, qm.device), out_cols=4)


def _window_sweep(name: str, qm, feats, blk_lo, blk_hi, cfg: SimConfig,
                  sub_q: int):
    """Launch the v2 sweep kernel `name`: (N, 4) raw pair sums."""
    gx, gy, _ = cfg.grid_size
    return _launch(getattr(cuda_lib.load(), name), qm, feats, blk_lo,
                   blk_hi, kernel_params(cfg, None, qm.device), sub_q, gx, gy,
                   out_cols=4)


def sweep_a(pos_s, cvel_s, vol_s, mass_s, qstart, qend, blk_start, blk_len,
            cfg: SimConfig, sub_q: int | None = None):
    """v1 XSPH + density over sorted arrays: (dens (N,), xsph (N, 3)).
    `vol_s` uses the previous step's densities (reference phase order,
    cpp:794-824). The bounds are sweep_bookkeeping's; `sub_q`, the JAX
    signature's bookkeeping granularity, is implied by blk_start's rows. On
    a CUDA tensor this launches the v1 sweep-A kernel, which walks each
    query's runs; on a CPU tensor it runs the plain version."""
    qm, feats = _inputs_a(pos_s, cvel_s, vol_s, mass_s)
    _check_run_inputs(qm, feats, qstart, qend, blk_start, blk_len)
    if qm.device.type == "cpu":
        s = _plain_a1(qm, feats, qstart, qend, cfg)
    else:
        s = _run_sweep("sph_sweep_a1", qm, feats, qstart, qend, cfg)
        sweep_a.launches += 1
    return s[:, 0], s[:, 1:4]


sweep_a.launches = 0


def sweep_b(pos_s, ivel_s, vol_s, pres_s, vm_s, qstart, qend, blk_start,
            blk_len, cfg: SimConfig, sub_q: int | None = None):
    """v1 pressure + viscosity forces and Vm Laplacian over sorted arrays:
    (acc_raw (N, 3), lap (N,)), acc_raw before the division by the query's
    density (cpp:568); `vol_s` uses the current densities. On a CUDA tensor
    this launches the v1 sweep-B kernel; on a CPU tensor it runs the plain
    version."""
    qm, feats = _inputs_b(pos_s, ivel_s, vol_s, pres_s, vm_s)
    _check_run_inputs(qm, feats, qstart, qend, blk_start, blk_len)
    if qm.device.type == "cpu":
        s = _plain_b1(qm, feats, qstart, qend, cfg)
    else:
        s = _run_sweep("sph_sweep_b1", qm, feats, qstart, qend, cfg)
        sweep_b.launches += 1
    return s[:, 0:3], s[:, 3]


sweep_b.launches = 0


def sweep_a2(pos_s, cvel_s, vol_s, mass_s, hash_s, blk_lo, blk_hi,
             cfg: SimConfig, sub_q: int = 32):
    """v2 XSPH + density over sorted arrays: (dens (N,), xsph (N, 3)), over
    the nine run windows per sub-block of `sub_q` rows (blk_lo / blk_hi
    from ops.sweeps.sweep_bookkeeping2) with the linear-hash mask on
    `hash_s` (sorted, sentinel on dead rows). `vol_s` must be finite on
    every row. On a CUDA tensor this launches the v2 sweep-A kernel; on a
    CPU tensor it runs the plain version."""
    qm, feats = _inputs_a(pos_s, cvel_s, vol_s, mass_s, hash_s)
    _check_sweep_inputs(qm, feats, blk_lo, blk_hi, sub_q, stride=16)
    if qm.device.type == "cpu":
        s = _plain_a2(qm, feats, cfg)
    else:
        s = _window_sweep("sph_sweep_a2", qm, feats, blk_lo, blk_hi, cfg,
                          sub_q)
        sweep_a2.launches += 1
    return s[:, 0], s[:, 1:4]


sweep_a2.launches = 0


def sweep_b2(pos_s, ivel_s, vol_s, pres_s, vm_s, hash_s, blk_lo, blk_hi,
             cfg: SimConfig, sub_q: int = 32):
    """v2 pressure + viscosity forces and Vm Laplacian over sorted arrays:
    (acc_raw (N, 3), lap (N,)). On a CUDA tensor this launches the v2
    sweep-B kernel; on a CPU tensor it runs the plain version."""
    qm, feats = _inputs_b(pos_s, ivel_s, vol_s, pres_s, vm_s, hash_s)
    _check_sweep_inputs(qm, feats, blk_lo, blk_hi, sub_q, stride=16)
    if qm.device.type == "cpu":
        s = _plain_b2(qm, feats, cfg)
    else:
        s = _window_sweep("sph_sweep_b2", qm, feats, blk_lo, blk_hi, cfg,
                          sub_q)
        sweep_b2.launches += 1
    return s[:, 0:3], s[:, 3]


sweep_b2.launches = 0

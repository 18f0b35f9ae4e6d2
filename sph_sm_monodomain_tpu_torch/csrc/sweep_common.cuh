// Shared pieces of the port's neighbor-sweep kernels (fused_sweeps.cu:
// sweep A / sweep B in their v4, v3 and v5 forms; fused_adjoint.cu: their
// backward sweeps; legacy_sweeps.cu: the v1 / v2 raw-sum sweeps): the slots
// of the physics-constant vector, the staging of candidate features into
// shared memory, the pair sums of sweep A and sweep B, the three candidate
// loops with their exact masks, and the warp-slice picker and launcher of
// the warp-trimmed sweeps.
//
// The first-form sweeps (v3, v1 / v2) run one thread block per bookkeeping
// sub-block of `sub_q` sorted query rows, one thread per query row. The
// block stages tiles of sub_q candidate rows into shared memory (one
// coalesced load per staged feature row); then every query thread walks
// the tile and calls the kernel's pair function for each candidate that
// passes the mask.
//   v3 (for_each_neighbor_hash9): the nine (dy, dz) run windows, mask
//     |qh + d_r - ch| <= 1 on the linear cell hash, d_r = Gx*(dy + Gy*dz).
//   v4, warp-trimmed (for_each_warp_candidate: sweeps A and B, the
//     Laplacian sweep and the backward sweeps of A and B): blocks of
//     several warps per 32 query rows, each warp walking its slice of the
//     three slow-plane windows [lo, hi) of the (16, N) feature matrix and
//     only the candidates inside the warp's cell ranges, with the full
//     per-axis mask |qcyz + (r-1)*G_mid - ccyz| <= 1 for window r and
//     |qcx - ccx| <= 1 (see the loop).
//   v5, warp-trimmed (for_each_warp_slab_candidate, sweeps A and B): the
//     same split over the first `count` slots of the rows' own packed
//     (16, kb) slabs, mask |dcf|, |dcm|, |dcs| <= 1 on the per-axis cell
//     coordinates.
// Under v4 and v3 a pair passes under one window only, even where sparse
// blocks' windows overlap, and the windows are iterated exactly.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace sph {

// Physics-constant vector (ops/fused_step.py kernel_params): the 16 dynamic
// slots (_DYN_SLOTS, 14 used) then the static constants (_STATIC_SLOTS).
enum Slot {
  VELOCITY_MIXING = 0, K_STIFFNESS, STAND_DENSITY, VOLTAGE_CONSTANT, FH_VR,
  FH_DENOM, FH_ASD, FH_C1, FH_C2, FH_C3, FH_C4, CM_CAPACITANCE, MU_VISCOSITY,
  VM_SCALE,
  KERNEL_H = 16, H2, INV_H, POLY6, SPIKY, BSPLINE, DT, MAX_PRESSURE,
  MAX_VOLTAGE, WALL_HIT, WORLD_X, WORLD_Y, WORLD_Z,
};

constexpr float kPairEps = 1e-12f;  // INF guard, SPH_SM_monodomain.h:24

// The feature rows a sweep stages, in slot order. For the v3 loop the last
// two must be the hash (row 12) then row 13; for the warp walks these are
// the staged words before the cell features the walk appends itself, and a
// row of -1 stages a zero pad.
template <int... R>
struct Rows {
  static constexpr int count = sizeof...(R);
};

// Copy candidate rows [base, base + T) (clipped at hi) of the feature rows
// R... of the (16, N) matrix into shared memory: slot f of candidate k at
// tile[f*T + k].
template <int... R>
__device__ __forceinline__ void stage_rows(Rows<R...>, float* tile,
                                           const float* feats, int n,
                                           int base, int hi) {
  const int T = blockDim.x;
  const int j = base + threadIdx.x;
  if (j < hi) {
    int f = 0;
    ((tile[(f++) * T + threadIdx.x] = feats[(size_t)R * n + j]), ...);
  }
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Sweep A's pair sums (_pair_step_a): XSPH velocity sum + Poly6 density in
// the reference's per-pair difference form (cpp:483, 688-695), reading rows
// 0-7 of candidate k of a row-major feature block of width T: a staged tile,
// or the whole (16, N) matrix with T = N.
struct PairSumsA {
  float qx, qy, qz, qvx, qvy, qvz, h2, p6c;
  float a_d = 0.0f, a_x = 0.0f, a_y = 0.0f, a_z = 0.0f;

  __device__ PairSumsA(const float* q, const float* prm)
      : qx(q[0]), qy(q[1]), qz(q[2]), qvx(q[3]), qvy(q[4]), qvz(q[5]),
        h2(prm[H2]), p6c(prm[POLY6]) {}

  __device__ __forceinline__ void add(const float* tile, int T, int k) {
    const float dx = qx - tile[k], dy = qy - tile[T + k],
                dz = qz - tile[2 * T + k];
    const float r2 = dx * dx + dy * dy + dz * dz;
    // Poly6 support folded into the weight: t == 0 adds exactly 0
    const float t = fmaxf(h2 - r2, 0.0f);
    if (t == 0.0f) return;
    const float w6 = p6c * t * t * t;
    const float wv = w6 * tile[6 * T + k];
    a_d += w6 * tile[7 * T + k];
    a_x += wv * (tile[3 * T + k] - qvx);
    a_y += wv * (tile[4 * T + k] - qvy);
    a_z += wv * (tile[5 * T + k] - qvz);
  }
};

// Sweep B's pair sums (_pair_step_b): Spiky pressure + viscosity and the
// B-spline-2 Vm Laplacian (cpp:546-563), reading rows 0-8 as PairSumsA does.
struct PairSumsB {
  float qx, qy, qz, qivx, qivy, qivz, qp, qvm, h, inv_h, spiky_c, bs_c, mu;
  int with_ep;
  float a_ax = 0.0f, a_ay = 0.0f, a_az = 0.0f, a_lap = 0.0f;

  __device__ PairSumsB(const float* q, const float* prm, int with_ep_)
      : qx(q[0]), qy(q[1]), qz(q[2]), qivx(q[3]), qivy(q[4]), qivz(q[5]),
        qp(q[6]), qvm(q[7]), h(prm[KERNEL_H]), inv_h(prm[INV_H]),
        spiky_c(prm[SPIKY]), bs_c(prm[BSPLINE]), mu(prm[MU_VISCOSITY]),
        with_ep(with_ep_) {}

  __device__ __forceinline__ void add(const float* tile, int T, int k) {
    const float dx = qx - tile[k], dy = qy - tile[T + k],
                dz = qz - tile[2 * T + k];
    const float r2 = dx * dx + dy * dy + dz * dz;
    if (!(r2 > kPairEps)) return;  // cpp:546
    const float inv_rr = rsqrtf(r2);
    const float rr = r2 * inv_rr;
    const float vol = tile[6 * T + k];
    // spiky support [0, h] via relu(h - r)
    const float hr = fmaxf(h - rr, 0.0f);
    const float common = vol * (spiky_c * hr);
    const float f_p =
        common * (hr * (-0.5f) * inv_rr) * (qp + tile[7 * T + k]);
    const float f_v = mu * common;
    a_ax += f_v * (tile[3 * T + k] - qivx) - f_p * dx;
    a_ay += f_v * (tile[4 * T + k] - qivy) - f_p * dy;
    a_az += f_v * (tile[5 * T + k] - qivz) - f_p * dz;
    if (with_ep) {
      // B_spline_2 (cpp:186-196) in relu form
      const float qr = rr * inv_h;
      const float w2 = bs_c * (1.5f * fmaxf(2.0f - qr, 0.0f) -
                               6.0f * fmaxf(1.0f - qr, 0.0f));
      a_lap += (vol * w2) * (tile[8 * T + k] - qvm);
    }
  }
};

// The v3 window loop: nine run windows per sub-block at stride 16 of the
// bounds, in the JAX package's _RUN_OFFSETS order (dy fast, dz slow), each
// masked by |qh + d_r - ch| <= 1 on the staged hash row. The hash admits
// wrap pairs across a world edge that the per-axis stencil excludes; they
// lie far outside every kernel support and add exactly 0. pair(k) runs for
// each staged candidate k of the tile that passes, in window order. All
// threads of the block must call it (it synchronizes); dead query rows
// (qlive false) stage tiles but call no pair.
template <class RowList, class Pair>
__device__ __forceinline__ void for_each_neighbor_hash9(
    RowList rows, float* tile, const float* feats, const int* blk_lo,
    const int* blk_hi, int n, int gx, int gy, float qh, bool qlive,
    Pair&& pair) {
  const int T = blockDim.x;
  const int b = blockIdx.x;
  const float* s_h = tile + (RowList::count - 2) * T;
  for (int r = 0; r < 9; ++r) {
    const int lo = blk_lo[b * 16 + r], hi = blk_hi[b * 16 + r];
    const float qd = qh + (float)(gx * (r % 3 - 1 + gy * (r / 3 - 1)));
    for (int base = lo; base < hi; base += T) {
      stage_rows(rows, tile, feats, n, base, hi);
      __syncthreads();
      const int cnt = min(T, hi - base);
      if (qlive) {
        for (int k = 0; k < cnt; ++k) {
          if (!(fabsf(qd - s_h[k]) <= 1.0f)) continue;
          pair(k);
        }
      }
      __syncthreads();
    }
  }
}

// The warp-trimmed v4 window walk of the redesigned sweeps A (K1) and B
// (K2), the Laplacian sweep (K3) and the backward sweeps (K4, K5). The
// calling block holds `slices` warps that serve the same 32 consecutive
// sorted query rows (lane = row) of sub-block b; warp `slice` walks the
// slice-th of `slices` equal parts of the block's three windows laid end
// to end, so a sub-block gives sub_q / 32 * slices independent warps. The
// sort key is cx + Gf * cyz, so within a window the candidates that some
// live row of the warp can accept have ccyz in [min qcyz + d - 1, max qcyz
// + d + 1] (d = (r - 1) * G_mid) and ccx in [min qcx - 1, max qcx + 1].
// Each pass the warp reads the cell features of 32 candidates (coalesced:
// rows 12 and 13 of the feature matrix), keeps those inside both ranges (a
// ballot), stages their words into its own `stage` (32 slots of
// Words::count + 2 floats, the cell pair last) with no barrier but
// __syncwarp, and every live row then applies the exact mask |qcyz + d -
// ccyz| <= 1, |qcx - ccx| <= 1 to each staged slot and calls pair(slot) in
// window order. Dead rows (qlive false) take part in the warp's steps but
// call no pair; a warp with no live row returns at once. The cell features
// are integers, so the ranges hold every candidate the exact mask accepts.
constexpr unsigned kFullMask = 0xffffffffu;

template <int... R>
__device__ __forceinline__ void load_slot(Rows<R...>, float* v,
                                          const float* feats, int n, int j) {
  int f = 0;
  ((v[f++] = R < 0 ? 0.0f : feats[(size_t)(R < 0 ? 0 : R) * n + j]),
   ...);
}

template <class Words, class Pair>
__device__ __forceinline__ void for_each_warp_candidate(
    Words words, float4* stage, const float* feats, const int* blk_lo,
    const int* blk_hi, int n, int g_mid, int b, int slice, int slices,
    float qcx, float qcyz, bool qlive, Pair&& pair) {
  constexpr int W = Words::count + 2;
  static_assert(W % 4 == 0, "a slot is a whole number of float4");
  constexpr int V = W / 4;
  const int lane = threadIdx.x & 31;
  const float inf = __int_as_float(0x7f800000);
  float xlo = qlive ? qcx : inf, xhi = qlive ? qcx : -inf;
  float clo = qlive ? qcyz : inf, chi = qlive ? qcyz : -inf;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    xlo = fminf(xlo, __shfl_xor_sync(kFullMask, xlo, o));
    xhi = fmaxf(xhi, __shfl_xor_sync(kFullMask, xhi, o));
    clo = fminf(clo, __shfl_xor_sync(kFullMask, clo, o));
    chi = fmaxf(chi, __shfl_xor_sync(kFullMask, chi, o));
  }
  if (!(xlo <= xhi)) return;  // no live row in this warp
  xlo -= 1.0f;
  xhi += 1.0f;
  int lo[3], len[3], total = 0;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    lo[r] = blk_lo[b * 4 + r];
    len[r] = max(blk_hi[b * 4 + r] - lo[r], 0);
    total += len[r];
  }
  const int s0 = (int)((long long)total * slice / slices);
  const int s1 = (int)((long long)total * (slice + 1) / slices);
  const float* f_cx = feats + (size_t)12 * n;
  const float* f_cyz = feats + (size_t)13 * n;
  int off = 0;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int a = lo[r] + max(s0 - off, 0);
    const int e = lo[r] + min(s1 - off, len[r]);
    off += len[r];
    const float d = (float)((r - 1) * g_mid);
    const float qd = qcyz + d, wlo = clo + d - 1.0f, whi = chi + d + 1.0f;
    for (int base = a; base < e; base += 32) {
      const int j = base + lane;
      float ccx = 0.0f, ccyz = 0.0f;
      bool take = false;
      if (j < e) {
        ccx = f_cx[j];
        ccyz = f_cyz[j];
        take = ccyz >= wlo && ccyz <= whi && ccx >= xlo && ccx <= xhi;
      }
      const unsigned m = __ballot_sync(kFullMask, take);
      if (take) {
        float v[W];
        load_slot(words, v, feats, n, j);
        v[W - 2] = ccx;
        v[W - 1] = ccyz;
        float4* s = stage + __popc(m & ((1u << lane) - 1u)) * V;
#pragma unroll
        for (int i = 0; i < V; ++i)
          s[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                             v[4 * i + 3]);
      }
      __syncwarp();
      const int cnt = __popc(m);
      for (int k = 0; k < cnt; ++k) {
        float c[W];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float4 t = stage[k * V + i];
          c[4 * i] = t.x;
          c[4 * i + 1] = t.y;
          c[4 * i + 2] = t.z;
          c[4 * i + 3] = t.w;
        }
        if (!qlive) continue;
        if (!(fabsf(qd - c[W - 1]) <= 1.0f)) continue;
        if (!(fabsf(qcx - c[W - 2]) <= 1.0f)) continue;
        pair(c);
      }
      __syncwarp();
    }
  }
}

// The warp-trimmed v5 slab walk of the redesigned slab sweeps (K7). The
// calling block holds `slices` warps that serve the same 32 consecutive
// query rows r0 .. r0 + 31 (lane = row; rows at or past n take no part):
// they may span several sub-blocks of `sub_q` rows (two at sub_q 16), and
// each sub-block b has its own packed slab (16, kb) at slabs + b * 16 * kb,
// of which the first count(b) slots are walked. For each such sub-block the
// warp takes the rows of the warp that belong to it and are live (qcf >= 0)
// as members, the cf / cm / cs ranges of its members widened by one cell,
// and walks the sub-block's slots in passes of 32, taking every slices-th
// pass from pass `slice` on, so that a slot's slice follows from its index
// alone: walking further empty slots (the whole slab, as v5s does) changes
// no bit. Each pass reads the cell features of 32 slots (coalesced: rows
// 12-14 of the slab), keeps those inside all three ranges (a ballot),
// stages their words and cell features into the warp's own `stage` (32
// slots of Words::count + 3 floats) with no barrier but __syncwarp, and
// every member applies the exact per-axis mask to each staged slot and
// calls pair(slot) in slot order. Empty slots hold a zero row with a
// sentinel cf below every live row's range, so they are never staged; dead
// rows call no pair (the mask would pair a dead row only with empty slots,
// which add exactly 0). The cell features are integers, so the ranges hold
// every slot the exact mask accepts.
template <class Words, class Count, class Pair>
__device__ __forceinline__ void for_each_warp_slab_candidate(
    Words words, float4* stage, const float* qm, const float* slabs, int n,
    int sub_q, int kb, Count&& count, int r0, int slice, int slices,
    Pair&& pair) {
  constexpr int W = Words::count + 3;
  static_assert(W % 4 == 0, "a slot is a whole number of float4");
  constexpr int V = W / 4;
  const int lane = threadIdx.x & 31;
  const int row = r0 + lane;
  const float inf = __int_as_float(0x7f800000);
  float qc[3] = {-1.0f, 0.0f, 0.0f};
  if (row < n) {
    qc[0] = qm[(size_t)row * 16 + 12];
    qc[1] = qm[(size_t)row * 16 + 13];
    qc[2] = qm[(size_t)row * 16 + 14];
  }
  const bool qlive = qc[0] >= 0.0f;
  const int b_last = (min(r0 + 32, n) - 1) / sub_q;
  for (int b = r0 / sub_q; b <= b_last; ++b) {
    const bool member = qlive && row / sub_q == b;
    float lo[3], hi[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = member ? qc[a] : inf;
      hi[a] = member ? qc[a] : -inf;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        lo[a] = fminf(lo[a], __shfl_xor_sync(kFullMask, lo[a], o));
        hi[a] = fmaxf(hi[a], __shfl_xor_sync(kFullMask, hi[a], o));
      }
      lo[a] -= 1.0f;
      hi[a] += 1.0f;
    }
    if (!(lo[0] <= hi[0])) continue;  // no live row of this sub-block
    const float* slab = slabs + (size_t)b * 16 * kb;
    const int cnt_b = count(b);
    for (int base = slice * 32; base < cnt_b; base += slices * 32) {
      const int j = base + lane;
      float cc[3] = {0.0f, 0.0f, 0.0f};
      bool take = false;
      if (j < cnt_b) {
        take = true;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          cc[a] = slab[(size_t)(12 + a) * kb + j];
          take = take && cc[a] >= lo[a] && cc[a] <= hi[a];
        }
      }
      const unsigned m = __ballot_sync(kFullMask, take);
      if (take) {
        float v[W];
        load_slot(words, v, slab, kb, j);
        v[W - 3] = cc[0];
        v[W - 2] = cc[1];
        v[W - 1] = cc[2];
        float4* s = stage + __popc(m & ((1u << lane) - 1u)) * V;
#pragma unroll
        for (int i = 0; i < V; ++i)
          s[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                             v[4 * i + 3]);
      }
      __syncwarp();
      const int cnt = __popc(m);
      for (int k = 0; k < cnt; ++k) {
        float c[W];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float4 t = stage[k * V + i];
          c[4 * i] = t.x;
          c[4 * i + 1] = t.y;
          c[4 * i + 2] = t.z;
          c[4 * i + 3] = t.w;
        }
        if (!member) continue;
        if (!(fabsf(qc[0] - c[W - 3]) <= 1.0f)) continue;
        if (!(fabsf(qc[1] - c[W - 2]) <= 1.0f)) continue;
        if (!(fabsf(qc[2] - c[W - 1]) <= 1.0f)) continue;
        pair(c);
      }
      __syncwarp();
    }
  }
}

// warp_slices picks the warp-trimmed kernels' `Slices` from what the launch
// can see: the fewest (a power of two from 2 to 16) that give the card 64
// warps an SM, so biceps_full (580 row warps) takes 16 and a cloud that
// fills the card by its rows alone (biceps_full x56: 32,330) takes 2. More
// slices than that only add partial tiles and partial sums; one slice
// would make one-warp blocks, and an SM holds at most 32 blocks, so 32
// warps. The slice count, and so the sum order, depends on N and the
// card's SM count only: launches on the same inputs and card give the same
// bits. One picker serves every sliced kernel (fused_sweeps.cu,
// fused_adjoint.cu).
inline int warp_slices(int n) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int slices = 2;
  while (slices < 16 && (long long)(n / 32) * slices < 64LL * sms)
    slices *= 2;
  return slices;
}

// Launch kernel<Slices> over ceil(n / 32) blocks of Slices warps, Slices
// from warp_slices: Launch<S>::run(grid, stream, args...) launches it.
template <template <int> class Launch, class... Args>
int launch_sliced(int n, void* stream, Args... args) {
  const int slices = warp_slices(n);
  const dim3 grid((n + 31) / 32);
  cudaStream_t st = (cudaStream_t)stream;
  switch (slices) {
    case 2: Launch<2>::run(grid, st, args...); break;
    case 4: Launch<4>::run(grid, st, args...); break;
    case 8: Launch<8>::run(grid, st, args...); break;
    default: Launch<16>::run(grid, st, args...); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace sph

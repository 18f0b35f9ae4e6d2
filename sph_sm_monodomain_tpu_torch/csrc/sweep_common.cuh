// Shared pieces of the port's neighbor-sweep kernels (fused_sweeps.cu:
// sweep A / sweep B in their v4, v3 and v5 forms and the Laplacian sweep;
// fused_adjoint.cu: the backward sweeps of v4's A and B; legacy_sweeps.cu:
// the v1 / v2 raw-sum sweeps): the slots of the physics-constant vector, the
// pair sums of sweep A and sweep B, the three warp walks with their exact
// masks, the slices' ordered sum, and the warp-slice picker and launcher.
//
// Every sweep runs blocks of `Slices` warps per 32 consecutive sorted
// query rows (lane = row). Each warp walks its slice of the rows'
// candidates, stages those that some row of the warp may accept into its
// own shared-memory slots (no barrier but __syncwarp), and every live row
// applies the exact mask to each staged slot and calls the kernel's pair
// function; then the slices' partial sums are added in slice order through
// shared memory. Three walks:
//   for_each_warp_candidate, over a sub-block's windows of the (16, N)
//     feature matrix laid end to end, in one of two geometries, staging
//     the candidates inside the warp's key ranges (a ballot per
//     32-candidate pass):
//     CellWindows (v4: sweeps A and B, the Laplacian sweep, the backward
//       sweeps): three slow-plane windows, mask |qcyz + (r-1)*G_mid -
//       ccyz| <= 1 and |qcx - ccx| <= 1;
//     HashWindows (v3 and v2: sweeps A and B): nine (dy, dz) run windows,
//       mask |qh + d_r - ch| <= 1 on the linear cell hash, d_r = Gx*(dy +
//       Gy*dz), each window first trimmed to the run inside the warp's hash
//       range.
//   for_each_warp_run_candidate (v1, sweeps A and B): the union of the
//     rows' own nine exact runs, cut at its widest gap, every candidate
//     staged with its row index, mask qstart[i, r] <= j < qend[i, r].
//   for_each_warp_slab_candidate (v5, sweeps A and B): the first `count`
//     slots of the rows' own packed (16, kb) slabs, mask |dcf|, |dcm|,
//     |dcs| <= 1 on the per-axis cell coordinates.
// Under the window walks a pair passes under one window only, even where
// sparse blocks' windows overlap, and the windows are iterated exactly.

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

// The feature rows a warp walk stages for each candidate, in slot order,
// before the cell key(s) or row index the walk appends itself; a row of -1
// stages a zero pad.
template <int... R>
struct Rows {
  static constexpr int count = sizeof...(R);
};

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

// The window geometries of for_each_warp_candidate: how many windows a
// sub-block has, the stride of its bounds in blk_lo / blk_hi, the feature
// row (and query column) of the cell key the windows are sorted by, the
// key's offset in window r, whether a second cell axis is masked on its own
// (read from row / column 12), and whether a window is first trimmed to the
// warp's key range.
//   CellWindows (v4): the sort key is cx + Gf * cyz, so the key cyz (row
//     13) is nondecreasing inside a window, offset (r - 1) * G_mid, and cx
//     has a range of its own.
//   HashWindows (v3, v2): the sort key is the linear hash itself (row 12,
//     an integer below 2^24 held exactly in fp32; row 13 is 0), windows in
//     the JAX package's _RUN_OFFSETS order (dy fast, dz slow). Each window
//     is a searchsorted range of the sorted hashes and dead rows sort past
//     every window, so the candidates a warp can accept in window r are
//     one contiguous run: the walk finds it by binary search (kTrim).
struct CellWindows {
  static constexpr int kWindows = 3, kStride = 4, kKeyRow = 13;
  static constexpr bool kAxis = true, kTrim = false;
  int g_mid;
  __device__ float offset(int r) const { return (float)((r - 1) * g_mid); }
};

struct HashWindows {
  static constexpr int kWindows = 9, kStride = 16, kKeyRow = 12;
  static constexpr bool kAxis = false, kTrim = true;
  int gx, gy;
  __device__ float offset(int r) const {
    return (float)(gx * (r % 3 - 1 + gy * (r / 3 - 1)));
  }
};

// Staged words of the hash and run walks' sweeps (v3 K6, v2 K9, v1 K8;
// before the hash or the row index): sweep A pos3 | cvel3 | vol_prev | mass
// | 0 0 0, sweep B pos3 | ivel3 | vol | pres | vm | 0 0
using WordsHashA = Rows<0, 1, 2, 3, 4, 5, 6, 7, -1, -1, -1>;
using WordsHashB = Rows<0, 1, 2, 3, 4, 5, 6, 7, 8, -1, -1>;

// The warp walk over a sub-block's windows, of the v4 sweeps A (K1), B
// (K2), the Laplacian sweep (K3) and the backward sweeps (K4, K5) under
// CellWindows, and of the v3 / v2 sweeps (K6, K9) under HashWindows. The
// calling block holds `slices` warps that serve the same 32 consecutive
// sorted query rows (lane = row) of sub-block b (sub_q is a multiple of 32,
// so a warp never spans two); warp `slice` walks the slice-th of `slices`
// equal parts of the block's windows laid end to end, so a sub-block gives
// sub_q / 32 * slices independent warps. Within window r the candidates
// that some live row of the warp can accept have their key in [min qkey +
// d_r - 1, max qkey + d_r + 1] (and, with an axis, cx in [min qcx - 1, max
// qcx + 1]). Each pass the warp reads the cell key(s) of 32 candidates
// (coalesced), keeps those inside the ranges (a ballot), stages their words
// into its own `stage` (32 slots of Words::count + 1 + kAxis floats, the
// axis then the key last) with no barrier but __syncwarp, and every live
// row then applies the exact mask |qkey + d_r - ckey| <= 1 (and |qcx - ccx|
// <= 1) to each staged slot and calls pair(slot) in window order. Dead rows
// (qlive false) take part in the warp's steps but call no pair; a warp with
// no live row returns at once. The keys are integers, so the ranges hold
// every candidate the exact mask accepts.
constexpr unsigned kFullMask = 0xffffffffu;

template <int... R>
__device__ __forceinline__ void load_slot(Rows<R...>, float* v,
                                          const float* feats, int n, int j) {
  int f = 0;
  ((v[f++] = R < 0 ? 0.0f : feats[(size_t)(R < 0 ? 0 : R) * n + j]),
   ...);
}

template <class Geom, class Words, class Pair>
__device__ __forceinline__ void for_each_warp_candidate(
    Geom geom, Words words, float4* stage, const float* feats,
    const int* blk_lo, const int* blk_hi, int n, int b, int slice,
    int slices, float qkey, float qcx, bool qlive, Pair&& pair) {
  constexpr int W = Words::count + 1 + Geom::kAxis;
  static_assert(W % 4 == 0, "a slot is a whole number of float4");
  static_assert(Geom::kWindows <= 16, "one lane per window bound");
  constexpr int V = W / 4;
  const int lane = threadIdx.x & 31;
  const float inf = __int_as_float(0x7f800000);
  float klo = qlive ? qkey : inf, khi = qlive ? qkey : -inf;
  float xlo = qlive ? qcx : inf, xhi = qlive ? qcx : -inf;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    klo = fminf(klo, __shfl_xor_sync(kFullMask, klo, o));
    khi = fmaxf(khi, __shfl_xor_sync(kFullMask, khi, o));
    if (Geom::kAxis) {
      xlo = fminf(xlo, __shfl_xor_sync(kFullMask, xlo, o));
      xhi = fmaxf(xhi, __shfl_xor_sync(kFullMask, xhi, o));
    }
  }
  if (!(klo <= khi)) return;  // no live row in this warp
  xlo -= 1.0f;
  xhi += 1.0f;
  const float* f_key = feats + (size_t)Geom::kKeyRow * n;
  const float* f_cx = feats + (size_t)12 * n;
  // The window bounds: lane r (< kWindows) holds where window r starts,
  // lane 16 + r where it ends; with kTrim, where the run of keys in [min
  // qkey + d_r - 1, max qkey + d_r + 1] starts and ends (binary search).
  const int wr = lane & 15;
  int bnd = 0;
  if (wr < Geom::kWindows) {
    const int lo = blk_lo[b * Geom::kStride + wr];
    const int hi = max(blk_hi[b * Geom::kStride + wr], lo);
    bnd = lane < 16 ? lo : hi;
    if (Geom::kTrim) {
      const float d = geom.offset(wr);
      const bool upper = lane >= 16;
      const float t = upper ? khi + d + 1.0f : klo + d - 1.0f;
      int a = lo, e = hi;
      while (a < e) {
        const int m = (a + e) >> 1;
        const float v = f_key[m];
        if (upper ? v <= t : v < t)
          a = m + 1;
        else
          e = m;
      }
      bnd = a;
    }
  }
  const int end = __shfl_down_sync(kFullMask, bnd, 16);
  int total = lane < Geom::kWindows ? end - bnd : 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    total += __shfl_xor_sync(kFullMask, total, o);
  const int s0 = (int)((long long)total * slice / slices);
  const int s1 = (int)((long long)total * (slice + 1) / slices);
  int off = 0;
  for (int r = 0; r < Geom::kWindows && off < s1; ++r) {
    const int lo = __shfl_sync(kFullMask, bnd, r);
    const int len = __shfl_sync(kFullMask, bnd, 16 + r) - lo;
    const int a = lo + max(s0 - off, 0);
    const int e = lo + min(s1 - off, len);
    off += len;
    const float d = geom.offset(r);
    const float qd = qkey + d, wlo = klo + d - 1.0f, whi = khi + d + 1.0f;
    for (int base = a; base < e; base += 32) {
      const int j = base + lane;
      float ccx = 0.0f, ckey = 0.0f;
      bool take = false;
      if (j < e) {
        ckey = f_key[j];
        take = ckey >= wlo && ckey <= whi;
        if (Geom::kAxis) {
          ccx = f_cx[j];
          take = take && ccx >= xlo && ccx <= xhi;
        }
      }
      const unsigned m = __ballot_sync(kFullMask, take);
      if (take) {
        float v[W];
        load_slot(words, v, feats, n, j);
        if (Geom::kAxis) v[W - 2] = ccx;
        v[W - 1] = ckey;
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
        if (Geom::kAxis && !(fabsf(qcx - c[W - 2]) <= 1.0f)) continue;
        pair(c);
      }
      __syncwarp();
    }
  }
}

// The run walk of the v1 sweeps (K8). The calling block holds `slices`
// warps that serve the same 32 consecutive sorted query rows (lane = row;
// a row at or past n takes no part); row i brings its nine exact runs
// [qstart[i, r], qend[i, r]) of sorted candidate rows (sweep_bookkeeping,
// bound stride 16). Window r of the warp is the union [min qstart, max
// qend) of its rows' nonempty runs r (an empty run, of a dead row or of a
// (dy, dz) row outside the grid, sits at row 0, not at the row's place),
// cut in two at the widest gap between a nonempty run's end and the next
// nonempty run's start (in lane order) where no run crosses the cut: the
// warp whose rows span two x-rows then walks neither the x-row between.
// Lane k (< 18) holds piece k = 2r + {0, 1}; the pieces are laid end to
// end and warp `slice` walks the slice-th of `slices` equal parts. Each
// pass stages the words of up to 32 consecutive candidates and their row
// index (an int in a float's bits, last) into the warp's own `stage` with
// no barrier but __syncwarp, and every row applies its own exact mask
// qstart[i, r] <= j < qend[i, r] to each staged slot and calls pair(slot)
// in window order. A warp with no nonempty run returns at once.
template <class Words, class Pair>
__device__ __forceinline__ void for_each_warp_run_candidate(
    Words words, float4* stage, const float* feats, const int* qstart,
    const int* qend, int n, size_t row, int slice, int slices,
    Pair&& pair) {
  constexpr int W = Words::count + 1;
  static_assert(W % 4 == 0, "a slot is a whole number of float4");
  constexpr int V = W / 4;
  const int lane = threadIdx.x & 31;
  const bool in = row < (size_t)n;
  const int* qs = qstart + (in ? row : 0) * 16;
  const int* qe = qend + (in ? row : 0) * 16;
  const unsigned above = lane == 31 ? 0u : kFullMask << (lane + 1);
  int plo = 0, phi = 0;
  for (int r = 0; r < 9; ++r) {
    const int s = in ? qs[r] : 0, e = in ? qe[r] : 0;
    const bool ne = e > s;
    const unsigned live = __ballot_sync(kFullMask, ne);
    if (!live) continue;
    const int lo = __reduce_min_sync(kFullMask, ne ? s : 0x7fffffff);
    const int hi = __reduce_max_sync(kFullMask, ne ? e : 0);
    const int next = __ffs(live & above) - 1;
    const int s_next = __shfl_sync(kFullMask, s, next < 0 ? lane : next);
    const int gap = ne && next >= 0 ? s_next - e : 0;
    const int g = __reduce_max_sync(kFullMask, gap);
    int a = hi, b = hi;
    if (g > 0) {
      const int at = __ffs(__ballot_sync(kFullMask, gap == g)) - 1;
      a = __shfl_sync(kFullMask, e, at);
      b = a + g;
      if (__any_sync(kFullMask, ne && s < b && e > a)) a = b = hi;
    }
    if (lane == 2 * r) {
      plo = lo;
      phi = a;
    } else if (lane == 2 * r + 1) {
      plo = b;
      phi = hi;
    }
  }
  const int total = __reduce_add_sync(kFullMask, phi - plo);
  if (total == 0) return;  // no nonempty run in this warp
  const int s0 = (int)((long long)total * slice / slices);
  const int s1 = (int)((long long)total * (slice + 1) / slices);
  int off = 0;
  for (int k = 0; k < 18 && off < s1; ++k) {
    const int lo = __shfl_sync(kFullMask, plo, k);
    const int len = __shfl_sync(kFullMask, phi, k) - lo;
    const int a = lo + max(s0 - off, 0);
    const int e = lo + min(s1 - off, len);
    off += len;
    if (a >= e) continue;
    const int ms = in ? qs[k >> 1] : 0, me = in ? qe[k >> 1] : 0;
    for (int base = a; base < e; base += 32) {
      const int j = base + lane;
      if (j < e) {
        float v[W];
        load_slot(words, v, feats, n, j);
        v[W - 1] = __int_as_float(j);
        float4* st = stage + lane * V;
#pragma unroll
        for (int i = 0; i < V; ++i)
          st[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                              v[4 * i + 3]);
      }
      __syncwarp();
      const int cnt = min(e - base, 32);
      for (int t = 0; t < cnt; ++t) {
        const int jj = __float_as_int(stage[t * V + V - 1].w);
        if (jj < ms || jj >= me) continue;
        float c[W];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float4 x = stage[t * V + i];
          c[4 * i] = x.x;
          c[4 * i + 1] = x.y;
          c[4 * i + 2] = x.z;
          c[4 * i + 3] = x.w;
        }
        pair(c);
      }
      __syncwarp();
    }
  }
}

// The slices' partial sums `acc` of a block of for_each_warp_candidate or
// for_each_warp_slab_candidate, added in slice order for warp 0's rows (no
// atomics: two launches on the same inputs give the same bits). Each warp
// leaves its partials in shared memory, in the block's stages once every
// warp has left its walk; returns true on warp 0, whose `acc` then holds
// the row's sums, and false on the others.
template <int Slices, int N, int kSums>
__device__ __forceinline__ bool add_slices(float4 (&stage)[Slices][N],
                                           float (&acc)[kSums]) {
  static_assert(kSums * 32 <= 4 * N, "the partial sums fit in a stage");
  float* part = reinterpret_cast<float*>(stage);  // [kSums][Slices][32]
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();  // every warp is done with the stages
#pragma unroll
  for (int k = 0; k < kSums; ++k) part[(k * Slices + w) * 32 + lane] = acc[k];
  __syncthreads();
  if (w != 0) return false;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    acc[k] = part[k * Slices * 32 + lane];
#pragma unroll
    for (int s = 1; s < Slices; ++s)
      acc[k] += part[(k * Slices + s) * 32 + lane];
  }
  return true;
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
// fused_adjoint.cu, legacy_sweeps.cu).
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

// Shared pieces of the port's neighbor-sweep kernels (fused_sweeps.cu:
// sweep A / sweep B; fused_adjoint.cu: their backward sweeps): the slots of
// the physics-constant vector, the staging of candidate features into shared
// memory, and the window loop with its exact cell mask.
//
// Every sweep runs one thread block per bookkeeping sub-block of `sub_q`
// sorted query rows, one thread per query row. For each of the block's three
// slow-plane windows [lo, hi) the threads stage tiles of sub_q candidate rows
// from the (16, N) feature matrix into shared memory (one coalesced load per
// staged feature row); then every live query thread walks the tile and calls
// the kernel's pair function for each candidate that passes the cell mask
// |qcyz + (r-1)*G_mid - ccyz| <= 1 for window r (plus |qcx - ccx| <= 1 for
// the full mask). A pair passes under one window only, even where sparse
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

// The feature rows a sweep stages, in slot order; the last two must be the
// cell features cx (row 12) and cyz (row 13).
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

// The window loop of every sweep: pair(k) runs for each staged candidate k
// of the tile that passes the cell mask, in window order. All threads of the
// block must call it (it synchronizes); dead query rows (qlive false) stage
// tiles but call no pair.
template <class RowList, class Pair>
__device__ __forceinline__ void for_each_neighbor(
    RowList rows, float* tile, const float* feats, const int* blk_lo,
    const int* blk_hi, int n, int g_mid, float qcx, float qcyz, bool qlive,
    bool mask_full, Pair&& pair) {
  const int T = blockDim.x;
  const int b = blockIdx.x;
  const float* s_cx = tile + (RowList::count - 2) * T;
  const float* s_cyz = tile + (RowList::count - 1) * T;
  for (int r = 0; r < 3; ++r) {
    const int lo = blk_lo[b * 4 + r], hi = blk_hi[b * 4 + r];
    const float qd = qcyz + (float)((r - 1) * g_mid);
    for (int base = lo; base < hi; base += T) {
      stage_rows(rows, tile, feats, n, base, hi);
      __syncthreads();
      const int cnt = min(T, hi - base);
      if (qlive) {
        for (int k = 0; k < cnt; ++k) {
          if (!(fabsf(qd - s_cyz[k]) <= 1.0f)) continue;
          if (mask_full && !(fabsf(qcx - s_cx[k]) <= 1.0f)) continue;
          pair(k);
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace sph

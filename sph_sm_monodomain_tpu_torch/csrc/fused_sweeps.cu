// Neighbor sweeps of the v4 fused coupled step, hand-written for Hopper
// (sm_90a). Plain C interface, loaded through ctypes
// (sph_sm_monodomain_tpu_torch/ops/cuda_lib.py); the Python wrappers are
// sweep_a3 / sweep_b3 in ops/fused_step.py, beside their plain PyTorch
// versions sweep_a3_plain / sweep_b3_plain.
//
// Replaces the Pallas TPU kernels _kernel_a3 (sweep A) and _kernel_b3
// (sweep B) of sph_sm_monodomain_tpu/ops/fused_step.py with
// stencil="xyz3" (enumeration _gather_loop4).
//
// Design. One thread block per bookkeeping sub-block of `sub_q` sorted query
// rows (sub_q = 128 on every scene the port builds), one thread per query
// row. For each of the block's three slow-plane windows [lo, hi) the threads
// stage tiles of sub_q candidate rows from the (16, N) feature matrix into
// shared memory (one coalesced load per feature row), then every thread
// walks the tile and accumulates its pair sums in fp32 registers. The
// per-window cell mask is the exact stencil: |qcyz + (r-1)*G_mid - ccyz| <= 1
// for window r (plus |qcx - ccx| <= 1 for the full mask), so a pair counts
// under one window only, even where sparse blocks' windows overlap. The
// windows are iterated exactly; the TPU's 128-row start alignment, VMEM/HBM
// split, chunked DMA and feature padding are not needed here.
//
// What bounds it on the H100: not memory. The candidate features of a step
// (16 x 18,560 f32 = 1.2 MB on biceps_full) stay in the 50 MB L2, and each
// block reads about 2,300 candidate rows per sweep. The limit is instruction
// issue at low occupancy: 145 blocks of 4 warps on 132 SMs, each thread a
// serial loop over its block's candidates. The shared-memory tiles broadcast
// each candidate to all threads (no bank conflicts), and the cell mask
// rejects most enumerated candidates (~80% on biceps_full) before any pair
// math. Raising occupancy (several threads per query row, or smaller
// sub-blocks) is the first lead for a later optimisation.
//
// Numerics: fp32 throughout, IEEE division and sqrt (no --use_fast_math).
// The pair distance uses rsqrtf (maximum error 2 ulp, CUDA math API) where
// the Pallas kernel uses lax.rsqrt. Sums run in window order rather than the
// TPU's lane-wise partial sums, so results agree with the plain version to
// fp32 rounding, not bit for bit.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

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

// Copy candidate rows [base, base + T) (clipped at hi) of the staged
// feature rows into shared memory: slot f of candidate k at tile[f*T + k].
// The NF staged rows are rows 0 .. NF-3 of the (16, N) matrix, then the
// cell features cx (row 12) and cyz (row 13):
//   sweep A (NF = 10): pos3 | cvel3 | vol_prev | mass | cx | cyz
//   sweep B (NF = 11): pos3 | ivel3 | vol | pres | vm | cx | cyz
template <int NF>
__device__ __forceinline__ void stage_tile(float* tile, const float* feats,
                                           int n, int base, int hi) {
  const int T = blockDim.x;
  const int j = base + threadIdx.x;
  if (j < hi) {
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int src = f < NF - 2 ? f : 12 + (f - (NF - 2));
      tile[f * T + threadIdx.x] = feats[(size_t)src * n + j];
    }
  }
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Sweep A (replaces _kernel_a3): XSPH velocity sum + Poly6 density
// (_pair_step_a), then the EOS / stim gate / FHN epilogue (_a_epilogue).
__global__ void sweep_a3_kernel(const float* __restrict__ qm,
                                const float* __restrict__ feats,
                                const int* __restrict__ blk_lo,
                                const int* __restrict__ blk_hi,
                                const float* __restrict__ prm,
                                float* __restrict__ out, int n, int with_ep,
                                int mask_full, int g_mid, int q_double,
                                int q_gate, int q_acc) {
  extern __shared__ float tile[];
  const int T = blockDim.x;
  const int b = blockIdx.x;
  const size_t row = (size_t)b * T + threadIdx.x;
  const float* q = qm + row * 16;
  const float qx = q[0], qy = q[1], qz = q[2];
  const float qvx = q[3], qvy = q[4], qvz = q[5];
  const float qcx = q[12], qcyz = q[13];
  // dead rows (cx sentinel) keep zero sums, like the plain version
  const bool qlive = qcx >= 0.0f;
  const float h2 = prm[H2], p6c = prm[POLY6];
  const float* s_x = tile;
  const float* s_y = tile + T;
  const float* s_z = tile + 2 * T;
  const float* s_vx = tile + 3 * T;
  const float* s_vy = tile + 4 * T;
  const float* s_vz = tile + 5 * T;
  const float* s_vol = tile + 6 * T;
  const float* s_mass = tile + 7 * T;
  const float* s_cx = tile + 8 * T;
  const float* s_cyz = tile + 9 * T;

  float a_d = 0.0f, a_x = 0.0f, a_y = 0.0f, a_z = 0.0f;
  for (int r = 0; r < 3; ++r) {
    const int lo = blk_lo[b * 4 + r], hi = blk_hi[b * 4 + r];
    const float qd = qcyz + (float)((r - 1) * g_mid);
    for (int base = lo; base < hi; base += T) {
      stage_tile<10>(tile, feats, n, base, hi);
      __syncthreads();
      const int cnt = min(T, hi - base);
      if (qlive) {
        for (int k = 0; k < cnt; ++k) {
          if (!(fabsf(qd - s_cyz[k]) <= 1.0f)) continue;
          if (mask_full && !(fabsf(qcx - s_cx[k]) <= 1.0f)) continue;
          const float dx = qx - s_x[k], dy = qy - s_y[k], dz = qz - s_z[k];
          const float r2 = dx * dx + dy * dy + dz * dz;
          // Poly6 support folded into the weight: t == 0 adds exactly 0
          const float t = fmaxf(h2 - r2, 0.0f);
          if (t == 0.0f) continue;
          const float w6 = p6c * t * t * t;
          const float wv = w6 * s_vol[k];
          a_d += w6 * s_mass[k];
          a_x += wv * (s_vx[k] - qvx);
          a_y += wv * (s_vy[k] - qvy);
          a_z += wv * (s_vz[k] - qvz);
        }
      }
      __syncthreads();
    }
  }

  // epilogue (_a_epilogue, cpp:483-503, 575-593, 699)
  const float mass = q[6], vm = q[8], stim = q[9], iion = q[10], w = q[11];
  const float vmix = prm[VELOCITY_MIXING];
  float dens = a_d;
  if (q_double) dens = dens + mass * (p6c * h2 * h2 * h2);
  float pres = prm[K_STIFFNESS] * (dens - prm[STAND_DENSITY]);
  if (with_ep) pres = pres - vm * prm[VOLTAGE_CONSTANT];
  const float pres_c = clampf(pres, -prm[MAX_PRESSURE], prm[MAX_PRESSURE]);
  if (q_gate)
    pres = stim > 0.0f ? pres_c : -0.0f;
  else
    pres = pres_c;
  float react = 0.0f, iion_n = 0.0f, w_n = 0.0f;
  if (with_ep) {
    const float dt = prm[DT];
    const float u = (vm - prm[FH_VR]) / prm[FH_DENOM];
    const float d_iion =
        dt * (prm[FH_C1] * u * (u - prm[FH_ASD]) * (u - 1.0f) +
              prm[FH_C2] * w) / mass;
    iion_n = q_acc ? iion + d_iion : d_iion;
    w_n = w + dt * prm[FH_C3] * (u - prm[FH_C4] * w) / mass;
    react = (iion_n - stim * (dt / mass)) / prm[CM_CAPACITANCE];
  }
  float* o = out + row * 16;
  o[0] = qx;
  o[1] = qy;
  o[2] = qz;
  o[3] = qvx + a_x * vmix;
  o[4] = qvy + a_y * vmix;
  o[5] = qvz + a_z * vmix;
  o[6] = pres;
  o[7] = vm;
  o[8] = dens;
  o[9] = react;
  o[10] = mass;
  o[11] = iion_n;
  o[12] = qcx;
  o[13] = qcyz;
  o[14] = q[14];
  o[15] = w_n;
}

// Sweep B (replaces _kernel_b3): Spiky pressure + viscosity and the
// B-spline-2 Vm Laplacian (_pair_step_b) under the full 27-cell mask, then
// the integration epilogue (_b_epilogue).
__global__ void sweep_b3_kernel(const float* __restrict__ qm,
                                const float* __restrict__ feats,
                                const int* __restrict__ blk_lo,
                                const int* __restrict__ blk_hi,
                                const float* __restrict__ prm,
                                float* __restrict__ out, int n, int with_ep,
                                int g_mid) {
  extern __shared__ float tile[];
  const int T = blockDim.x;
  const int b = blockIdx.x;
  const size_t row = (size_t)b * T + threadIdx.x;
  const float* q = qm + row * 16;
  const float qx = q[0], qy = q[1], qz = q[2];
  const float qivx = q[3], qivy = q[4], qivz = q[5];
  const float qp = q[6], qvm = q[7];
  const float qcx = q[12], qcyz = q[13];
  const bool qlive = qcx >= 0.0f;
  const float h = prm[KERNEL_H], inv_h = prm[INV_H];
  const float spiky_c = prm[SPIKY], bs_c = prm[BSPLINE];
  const float mu = prm[MU_VISCOSITY];
  const float* s_x = tile;
  const float* s_y = tile + T;
  const float* s_z = tile + 2 * T;
  const float* s_vx = tile + 3 * T;
  const float* s_vy = tile + 4 * T;
  const float* s_vz = tile + 5 * T;
  const float* s_vol = tile + 6 * T;
  const float* s_pres = tile + 7 * T;
  const float* s_vm = tile + 8 * T;
  const float* s_cx = tile + 9 * T;
  const float* s_cyz = tile + 10 * T;

  float a_ax = 0.0f, a_ay = 0.0f, a_az = 0.0f, a_lap = 0.0f;
  for (int r = 0; r < 3; ++r) {
    const int lo = blk_lo[b * 4 + r], hi = blk_hi[b * 4 + r];
    const float qd = qcyz + (float)((r - 1) * g_mid);
    for (int base = lo; base < hi; base += T) {
      stage_tile<11>(tile, feats, n, base, hi);
      __syncthreads();
      const int cnt = min(T, hi - base);
      if (qlive) {
        for (int k = 0; k < cnt; ++k) {
          if (!(fabsf(qd - s_cyz[k]) <= 1.0f)) continue;
          if (!(fabsf(qcx - s_cx[k]) <= 1.0f)) continue;
          const float dx = qx - s_x[k], dy = qy - s_y[k], dz = qz - s_z[k];
          const float r2 = dx * dx + dy * dy + dz * dz;
          if (!(r2 > kPairEps)) continue;  // cpp:546
          const float inv_rr = rsqrtf(r2);
          const float rr = r2 * inv_rr;
          const float vol = s_vol[k];
          // spiky support [0, h] via relu(h - r)
          const float hr = fmaxf(h - rr, 0.0f);
          const float common = vol * (spiky_c * hr);
          const float f_p =
              common * (hr * (-0.5f) * inv_rr) * (qp + s_pres[k]);
          const float f_v = mu * common;
          a_ax += f_v * (s_vx[k] - qivx) - f_p * dx;
          a_ay += f_v * (s_vy[k] - qivy) - f_p * dy;
          a_az += f_v * (s_vz[k] - qivz) - f_p * dz;
          if (with_ep) {
            // B_spline_2 (cpp:186-196) in relu form
            const float qr = rr * inv_h;
            const float w2 = bs_c * (1.5f * fmaxf(2.0f - qr, 0.0f) -
                                     6.0f * fmaxf(1.0f - qr, 0.0f));
            a_lap += (vol * w2) * (s_vm[k] - qvm);
          }
        }
      }
      __syncthreads();
    }
  }

  // epilogue (_b_epilogue, cpp:568-571, 596-651)
  const float dens = q[8], react = q[9], mass = q[10];
  const float dt = prm[DT];
  const float dens_g = dens > 0.0f ? dens : 1.0f;
  const float acc[3] = {a_ax / dens_g, a_ay / dens_g, a_az / dens_g};
  const float dtm = dt / mass;
  float inter_vm = 0.0f, vm_new = qvm;
  if (with_ep) {
    inter_vm = a_lap + prm[VM_SCALE] * a_lap - react;
    vm_new = clampf(qvm + inter_vm * dtm, -prm[MAX_VOLTAGE], prm[MAX_VOLTAGE]);
  }
  const float wall_hit = prm[WALL_HIT];
  const float qpos[3] = {qx, qy, qz};
  const float qiv[3] = {qivx, qivy, qivz};
  float* o = out + row * 16;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float wlim = prm[WORLD_X + ax];
    float v = qiv[ax] + acc[ax] * dtm;  // cpp:608
    float p = qpos[ax] + v * dt;        // cpp:609
    const bool low = p < 0.0f;
    const bool high = p >= wlim;
    if (low || high) v = v * wall_hit;
    if (low) p = 0.0f;
    if (high) p = wlim - 1e-4f;
    o[ax] = clampf(p, 0.0f, wlim);      // cpp:649
    o[3 + ax] = v;
    o[12 + ax] = acc[ax];
  }
  o[6] = vm_new;
  o[7] = dens;
  o[8] = qp;
  o[9] = q[11];   // iion'
  o[10] = q[15];  // w'
  o[11] = inter_vm;
  o[15] = 0.0f;
}

}  // namespace

extern "C" {

int sph_sweep_a3(const float* qm, const float* feats, const int* blk_lo,
                 const int* blk_hi, const float* prm, float* out, int n,
                 int sub_q, int with_ep, int mask_full, int g_mid,
                 int quirk_double_self_density, int quirk_pressure_stim_gate,
                 int quirk_iion_accumulate, void* stream) {
  const size_t smem = 10 * (size_t)sub_q * sizeof(float);
  sweep_a3_kernel<<<n / sub_q, sub_q, smem, (cudaStream_t)stream>>>(
      qm, feats, blk_lo, blk_hi, prm, out, n, with_ep, mask_full, g_mid,
      quirk_double_self_density, quirk_pressure_stim_gate,
      quirk_iion_accumulate);
  return (int)cudaGetLastError();
}

int sph_sweep_b3(const float* qm, const float* feats, const int* blk_lo,
                 const int* blk_hi, const float* prm, float* out, int n,
                 int sub_q, int with_ep, int g_mid, void* stream) {
  const size_t smem = 11 * (size_t)sub_q * sizeof(float);
  sweep_b3_kernel<<<n / sub_q, sub_q, smem, (cudaStream_t)stream>>>(
      qm, feats, blk_lo, blk_hi, prm, out, n, with_ep, g_mid);
  return (int)cudaGetLastError();
}

const char* sph_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

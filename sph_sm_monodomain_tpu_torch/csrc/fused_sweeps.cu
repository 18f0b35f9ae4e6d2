// Neighbor sweeps of the v4 fused coupled step and of the frozen-cloud
// monodomain mode, hand-written for Hopper (sm_90a). Plain C interface,
// loaded through ctypes (sph_sm_monodomain_tpu_torch/ops/cuda_lib.py); the
// Python wrappers are sweep_a3 / sweep_b3 / sweep_lap3 in
// ops/fused_step.py, beside their plain PyTorch versions sweep_a3_plain /
// sweep_b3_plain / sweep_lap3_plain.
//
// Replaces the Pallas TPU kernels _kernel_a3 (sweep A), _kernel_b3 (sweep
// B) and _kernel_lap3 (the Laplacian-only sweep) of
// sph_sm_monodomain_tpu/ops/fused_step.py with stencil="xyz3" (enumeration
// _gather_loop4).
//
// Design. One thread block per bookkeeping sub-block of `sub_q` sorted query
// rows (sub_q = 128 on every scene the port builds), one thread per query
// row, the three slow-plane windows staged through shared memory and masked
// per window by the exact cell stencil (sweep_common.cuh,
// for_each_neighbor); every thread accumulates its pair sums in fp32
// registers. The windows are iterated exactly; the TPU's 128-row start
// alignment, VMEM/HBM split, chunked DMA and feature padding are not needed
// here.
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

#include "sweep_common.cuh"

namespace {

using namespace sph;

// Staged candidate feature rows:
//   sweep A: pos3 | cvel3 | vol_prev | mass | cx | cyz
//   sweep B: pos3 | ivel3 | vol | pres | vm | cx | cyz
using RowsA = Rows<0, 1, 2, 3, 4, 5, 6, 7, 12, 13>;
using RowsB = Rows<0, 1, 2, 3, 4, 5, 6, 7, 8, 12, 13>;
//   Laplacian sweep: pos3 | vol | vm | cx | cyz
using RowsL = Rows<0, 1, 2, 3, 4, 12, 13>;

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
  const size_t row = (size_t)blockIdx.x * T + threadIdx.x;
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

  float a_d = 0.0f, a_x = 0.0f, a_y = 0.0f, a_z = 0.0f;
  for_each_neighbor(RowsA{}, tile, feats, blk_lo, blk_hi, n, g_mid, qcx,
                    qcyz, qlive, mask_full, [&](int k) {
    const float dx = qx - s_x[k], dy = qy - s_y[k], dz = qz - s_z[k];
    const float r2 = dx * dx + dy * dy + dz * dz;
    // Poly6 support folded into the weight: t == 0 adds exactly 0
    const float t = fmaxf(h2 - r2, 0.0f);
    if (t == 0.0f) return;
    const float w6 = p6c * t * t * t;
    const float wv = w6 * s_vol[k];
    a_d += w6 * s_mass[k];
    a_x += wv * (s_vx[k] - qvx);
    a_y += wv * (s_vy[k] - qvy);
    a_z += wv * (s_vz[k] - qvz);
  });

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
  const size_t row = (size_t)blockIdx.x * T + threadIdx.x;
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

  float a_ax = 0.0f, a_ay = 0.0f, a_az = 0.0f, a_lap = 0.0f;
  for_each_neighbor(RowsB{}, tile, feats, blk_lo, blk_hi, n, g_mid, qcx,
                    qcyz, qlive, true, [&](int k) {
    const float dx = qx - s_x[k], dy = qy - s_y[k], dz = qz - s_z[k];
    const float r2 = dx * dx + dy * dy + dz * dz;
    if (!(r2 > kPairEps)) return;  // cpp:546
    const float inv_rr = rsqrtf(r2);
    const float rr = r2 * inv_rr;
    const float vol = s_vol[k];
    // spiky support [0, h] via relu(h - r)
    const float hr = fmaxf(h - rr, 0.0f);
    const float common = vol * (spiky_c * hr);
    const float f_p = common * (hr * (-0.5f) * inv_rr) * (qp + s_pres[k]);
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
  });

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

// Laplacian-only sweep (replaces _kernel_lap3): the Vm diffusion half of
// Compute_Force (cpp:562-563) for the frozen-cloud monodomain mode, with two
// accumulators a_vw = sum_j vol_j W2(r_ij) and a_vwvm = sum_j vol_j W2(r_ij)
// vm_j under the full 27-cell mask (W2's support is 2h, so the truncation
// to the stencil is part of the function) and the r^2 > 1e-12 guard. The
// same kernel runs the mode's backward sweep (unit volumes, the cotangent
// as candidate vm, zero query vm), where padding rows are excluded by the
// cell mask alone: their cx sentinel fails |qcx - ccx| <= 1.
// Bound on the H100 as sweeps A / B: issue rate at low occupancy, with the
// smallest pair body of the three (16 FLOPs per pair within 2h).
__global__ void sweep_lap3_kernel(const float* __restrict__ qm,
                                  const float* __restrict__ feats,
                                  const int* __restrict__ blk_lo,
                                  const int* __restrict__ blk_hi,
                                  const float* __restrict__ prm,
                                  float* __restrict__ out, int n, int g_mid) {
  extern __shared__ float tile[];
  const int T = blockDim.x;
  const size_t row = (size_t)blockIdx.x * T + threadIdx.x;
  const float* q = qm + row * 16;
  const float qx = q[0], qy = q[1], qz = q[2], qvm = q[3];
  const float qcx = q[12], qcyz = q[13];
  const bool qlive = qcx >= 0.0f;
  const float inv_h = prm[INV_H], bs_c = prm[BSPLINE];
  const float* s_x = tile;
  const float* s_y = tile + T;
  const float* s_z = tile + 2 * T;
  const float* s_vol = tile + 3 * T;
  const float* s_vm = tile + 4 * T;

  float a_vw = 0.0f, a_vwvm = 0.0f;
  for_each_neighbor(RowsL{}, tile, feats, blk_lo, blk_hi, n, g_mid, qcx,
                    qcyz, qlive, true, [&](int k) {
    const float dx = qx - s_x[k], dy = qy - s_y[k], dz = qz - s_z[k];
    const float r2 = dx * dx + dy * dy + dz * dz;
    if (!(r2 > kPairEps)) return;  // cpp:546
    const float qr = (r2 * rsqrtf(r2)) * inv_h;
    // B_spline_2 (cpp:186-196) in relu form: exactly 0 from q = 2 on
    if (qr >= 2.0f) return;
    const float w2 = bs_c * (1.5f * fmaxf(2.0f - qr, 0.0f) -
                             6.0f * fmaxf(1.0f - qr, 0.0f));
    const float vw = s_vol[k] * w2;
    a_vw += vw;
    a_vwvm += vw * s_vm[k];
  });

  float* o = out + row * 16;
  o[0] = a_vwvm - a_vw * qvm;
#pragma unroll
  for (int c = 1; c < 16; ++c) o[c] = 0.0f;
}

}  // namespace

extern "C" {

int sph_sweep_a3(const float* qm, const float* feats, const int* blk_lo,
                 const int* blk_hi, const float* prm, float* out, int n,
                 int sub_q, int with_ep, int mask_full, int g_mid,
                 int quirk_double_self_density, int quirk_pressure_stim_gate,
                 int quirk_iion_accumulate, void* stream) {
  const size_t smem = RowsA::count * (size_t)sub_q * sizeof(float);
  sweep_a3_kernel<<<n / sub_q, sub_q, smem, (cudaStream_t)stream>>>(
      qm, feats, blk_lo, blk_hi, prm, out, n, with_ep, mask_full, g_mid,
      quirk_double_self_density, quirk_pressure_stim_gate,
      quirk_iion_accumulate);
  return (int)cudaGetLastError();
}

int sph_sweep_b3(const float* qm, const float* feats, const int* blk_lo,
                 const int* blk_hi, const float* prm, float* out, int n,
                 int sub_q, int with_ep, int g_mid, void* stream) {
  const size_t smem = RowsB::count * (size_t)sub_q * sizeof(float);
  sweep_b3_kernel<<<n / sub_q, sub_q, smem, (cudaStream_t)stream>>>(
      qm, feats, blk_lo, blk_hi, prm, out, n, with_ep, g_mid);
  return (int)cudaGetLastError();
}

int sph_sweep_lap3(const float* qm, const float* feats, const int* blk_lo,
                   const int* blk_hi, const float* prm, float* out, int n,
                   int sub_q, int g_mid, void* stream) {
  const size_t smem = RowsL::count * (size_t)sub_q * sizeof(float);
  sweep_lap3_kernel<<<n / sub_q, sub_q, smem, (cudaStream_t)stream>>>(
      qm, feats, blk_lo, blk_hi, prm, out, n, g_mid);
  return (int)cudaGetLastError();
}

const char* sph_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// Backward neighbor sweeps of the differentiable v4 coupled step,
// hand-written for Hopper (sm_90a). Plain C interface, loaded through ctypes
// (sph_sm_monodomain_tpu_torch/ops/cuda_lib.py); the Python wrappers are
// sweep_bwd_a / sweep_bwd_b in ops/fused_adjoint.py, beside their plain
// PyTorch versions sweep_bwd_a_plain / sweep_bwd_b_plain.
//
// Replaces the Pallas TPU kernels _kernel_bwd_a (the VJP of sweep A's pair
// sums) and _kernel_bwd_b (the VJP of sweep B's pair sums) of
// sph_sm_monodomain_tpu/ops/fused_adjoint.py, which enumerate with
// _gather_loop4 and its default full per-axis mask.
//
// Both pair roles in one pass. The stencil and the r^2 > eps self-exclusion
// are symmetric, so particle p's cotangent is a sum over its own neighbor
// set of two terms: p as query (weighted by p's own output cotangent) and p
// as candidate (weighted by the neighbor's cotangent). The query matrix
// carries [state | cotangents] per particle and the (16, N) feature matrix
// is its transpose, so each thread gathers both roles for its row: no
// scatter, no atomics, no second window table, and a result that does not
// depend on the order blocks run in.
//
// Design: the forward sweeps' pattern (sweep_common.cuh): one thread block
// per 128-row sub-block, one thread per query row, the three windows staged
// through shared memory, the exact per-window cell mask (always the full
// per-axis mask here), fp32 register accumulators (9 for sweep A, 10 for
// sweep B), then an epilogue that writes the (N, 16) output contract with
// zeros in the unused columns.
//
// What bounds it on the H100: as for the forward sweeps, not memory. The
// feature matrix (16 x 18,560 f32 = 1.2 MB on biceps_full) stays in the
// 50 MB L2 and each block reads about 2,300 candidate rows per sweep; the
// arithmetic of the pairs that pass the cell mask is a few hundred MFLOP.
// The limit is instruction issue at low occupancy (145 blocks of 4 warps on
// 132 SMs, each thread a serial loop over its block's candidates). The
// kernels skip a pair as soon as every one of its terms is known to be 0
// (outside Poly6's support for sweep A, beyond 2h for sweep B), which keeps
// the serial loop short; more threads per query row is the lead for a later
// optimisation.
//
// Numerics: fp32 throughout, IEEE division and sqrt (no --use_fast_math).
// Sweep B's backward uses rsqrtf (maximum error 2 ulp) for 1/r, as the
// forward sweep B does.

#include "sweep_common.cuh"

namespace {

using namespace sph;

// Staged candidate feature rows (the transposed query matrix):
//   sweep A: pos3 | v3 | vol | mass | gd | gx3 | cx | cyz
//   sweep B: pos3 | u3 | vol | P | vm | ga3 | gl | cx | cyz
using RowsBwdA = Rows<0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13>;
using RowsBwdB = Rows<0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 14, 12, 13>;

// VJP of sweep A's pair sums (replaces _kernel_bwd_a). Query columns:
// [pos3 | v3 | vol | mass | gd | gx3 | cx | cyz | - -], gd / gx3 the
// cotangents of the density and XSPH sums. Output:
// [d_pos3 | d_v3 | d_vol | d_mass | 0 x 8].
__global__ void sweep_bwd_a_kernel(const float* __restrict__ qm,
                                   const float* __restrict__ feats,
                                   const int* __restrict__ blk_lo,
                                   const int* __restrict__ blk_hi,
                                   const float* __restrict__ prm,
                                   float* __restrict__ out, int n,
                                   int g_mid) {
  extern __shared__ float tile[];
  const int T = blockDim.x;
  const size_t row = (size_t)blockIdx.x * T + threadIdx.x;
  const float* q = qm + row * 16;
  const float qx = q[0], qy = q[1], qz = q[2];
  const float qvx = q[3], qvy = q[4], qvz = q[5];
  const float qvol = q[6], qmass = q[7], qgd = q[8];
  const float qgx = q[9], qgy = q[10], qgz = q[11];
  const float qcx = q[12], qcyz = q[13];
  const float h2 = prm[H2], p6c = prm[POLY6];
  const float* s_x = tile;
  const float* s_y = tile + T;
  const float* s_z = tile + 2 * T;
  const float* s_vx = tile + 3 * T;
  const float* s_vy = tile + 4 * T;
  const float* s_vz = tile + 5 * T;
  const float* s_vol = tile + 6 * T;
  const float* s_mass = tile + 7 * T;
  const float* s_gd = tile + 8 * T;
  const float* s_gx = tile + 9 * T;
  const float* s_gy = tile + 10 * T;
  const float* s_gz = tile + 11 * T;

  float aPx = 0.0f, aPy = 0.0f, aPz = 0.0f, aB = 0.0f;
  float aDx = 0.0f, aDy = 0.0f, aDz = 0.0f, aE = 0.0f, aF = 0.0f;
  for_each_neighbor(RowsBwdA{}, tile, feats, blk_lo, blk_hi, n, g_mid, qcx,
                    qcyz, qcx >= 0.0f, [&](int k) {
    const float dx = qx - s_x[k], dy = qy - s_y[k], dz = qz - s_z[k];
    const float r2 = dx * dx + dy * dy + dz * dz;
    // outside Poly6's support every term below carries t^2 or w6
    const float t = fmaxf(h2 - r2, 0.0f);
    if (t == 0.0f) return;
    const float t2 = t * t;
    const float w6 = p6c * (t2 * t);
    // velocity differences v_q (candidate) - v_p (query)
    const float dvx = s_vx[k] - qvx, dvy = s_vy[k] - qvy, dvz = s_vz[k] - qvz;
    const float volq = s_vol[k], gdq = s_gd[k];
    const float gxx = s_gx[k], gxy = s_gy[k], gxz = s_gz[k];
    // s_pq = gd_p m_q + vol_q (gx_p . (v_q - v_p))
    const float s_pq =
        qgd * s_mass[k] + volq * (qgx * dvx + qgy * dvy + qgz * dvz);
    // X = gx_q . (v_p - v_q); s_qp = gd_q m_p + vol_p X
    const float xq = -(gxx * dvx + gxy * dvy + gxz * dvz);
    const float s_qp = gdq * qmass + qvol * xq;
    const float tt = t2 * (s_pq + s_qp);
    aPx += tt * dx;
    aPy += tt * dy;
    aPz += tt * dz;
    aB += w6 * volq;
    aDx += w6 * gxx;
    aDy += w6 * gxy;
    aDz += w6 * gxz;
    aE += w6 * gdq;
    aF += w6 * xq;
  });

  float* o = out + row * 16;
  const float m6c = -6.0f * p6c;
  o[0] = m6c * aPx;
  o[1] = m6c * aPy;
  o[2] = m6c * aPz;
  o[3] = qvol * aDx - qgx * aB;
  o[4] = qvol * aDy - qgy * aB;
  o[5] = qvol * aDz - qgz * aB;
  o[6] = aF;  // d_vol
  o[7] = aE;  // d_mass
#pragma unroll
  for (int c = 8; c < 16; ++c) o[c] = 0.0f;
}

// VJP of sweep B's pair sums (replaces _kernel_bwd_b). Query columns:
// [pos3 | u3 | vol | P | vm | ga3 | cx | cyz | gl | -], ga3 / gl the
// cotangents of the acceleration and Laplacian sums. Output:
// [d_pos3 | d_u3 | d_P | d_vm | d_vol | d_mu partial | 0 x 6]; the caller
// sums the d_mu partials over the rows.
__global__ void sweep_bwd_b_kernel(const float* __restrict__ qm,
                                   const float* __restrict__ feats,
                                   const int* __restrict__ blk_lo,
                                   const int* __restrict__ blk_hi,
                                   const float* __restrict__ prm,
                                   float* __restrict__ out, int n,
                                   int g_mid) {
  extern __shared__ float tile[];
  const int T = blockDim.x;
  const size_t row = (size_t)blockIdx.x * T + threadIdx.x;
  const float* q = qm + row * 16;
  const float qx = q[0], qy = q[1], qz = q[2];
  const float qux = q[3], quy = q[4], quz = q[5];
  const float qvol = q[6], qP = q[7], qvm = q[8];
  const float qgax = q[9], qgay = q[10], qgaz = q[11];
  const float qcx = q[12], qcyz = q[13], qgl = q[14];
  const float h = prm[KERNEL_H], inv_h = prm[INV_H];
  const float spk = prm[SPIKY], bs_c = prm[BSPLINE];
  const float bsd = bs_c * inv_h;
  const float mu = prm[MU_VISCOSITY];
  const float musp = mu * spk, hspk = 0.5f * spk;
  const float* s_x = tile;
  const float* s_y = tile + T;
  const float* s_z = tile + 2 * T;
  const float* s_ux = tile + 3 * T;
  const float* s_uy = tile + 4 * T;
  const float* s_uz = tile + 5 * T;
  const float* s_vol = tile + 6 * T;
  const float* s_P = tile + 7 * T;
  const float* s_vm = tile + 8 * T;
  const float* s_gax = tile + 9 * T;
  const float* s_gay = tile + 10 * T;
  const float* s_gaz = tile + 11 * T;
  const float* s_gl = tile + 12 * T;

  float gx_ = 0.0f, gy_ = 0.0f, gz_ = 0.0f, ux = 0.0f, uy = 0.0f, uz = 0.0f;
  float aP = 0.0f, aVM = 0.0f, aVOL = 0.0f, aMU = 0.0f;
  for_each_neighbor(RowsBwdB{}, tile, feats, blk_lo, blk_hi, n, g_mid, qcx,
                    qcyz, qcx >= 0.0f, [&](int k) {
    const float dx = qx - s_x[k], dy = qy - s_y[k], dz = qz - s_z[k];
    const float r2 = dx * dx + dy * dy + dz * dz;
    if (!(r2 > kPairEps)) return;  // cpp:546
    const float inv_r = rsqrtf(r2);
    const float rr = r2 * inv_r;
    const float qr = rr * inv_h;
    // beyond B_spline_2's support (2h, and so beyond Spiky's h) every term
    // below is 0: hrm, w2m and w2pm all vanish
    if (qr >= 2.0f) return;
    const float hrm = fmaxf(h - rr, 0.0f);
    const float w2m = bs_c * (1.5f * fmaxf(2.0f - qr, 0.0f) -
                              6.0f * fmaxf(1.0f - qr, 0.0f));
    // w2' on its active pieces (subgradient 0 at the kinks, as autodiff of
    // the forward's relu form gives)
    const float w2pm = bsd * (6.0f * (qr < 1.0f ? 1.0f : 0.0f) -
                              1.5f * (qr < 2.0f ? 1.0f : 0.0f));
    const float volq = s_vol[k], Pq = s_P[k], vmq = s_vm[k], glq = s_gl[k];
    const float gax = s_gax[k], gay = s_gay[k], gaz = s_gaz[k];
    // u_q - u_p
    const float dux = s_ux[k] - qux, duy = s_uy[k] - quy, duz = s_uz[k] - quz;
    const float gaP_d = qgax * dx + qgay * dy + qgaz * dz;
    const float gaQ_d = gax * dx + gay * dy + gaz * dz;
    const float gaP_du = qgax * dux + qgay * duy + qgaz * duz;
    const float gaQ_du = gax * dux + gay * duy + gaz * duz;
    const float psum = qP + Pq;
    const float hr2ir = hrm * hrm * inv_r;
    // d_P: (S/2) hr^2/r [vol_q (ga_p . D) - vol_p (ga_q . D)]
    aP += hr2ir * (volq * gaP_d - qvol * gaQ_d);
    // d_u: mu S hr [vol_p ga_q - vol_q ga_p]
    ux += hrm * (qvol * gax - volq * qgax);
    uy += hrm * (qvol * gay - volq * qgay);
    uz += hrm * (qvol * gaz - volq * qgaz);
    // d_vm: w2 [vol_p gl_q - vol_q gl_p]
    aVM += w2m * (qvol * glq - volq * qgl);
    // d_vol (candidate role): ga_q . [mu S hr (u_p - u_q)
    //   - (S/2) hr^2/r (P_p + P_q) D] + gl_q w2 (vm_p - vm_q)
    aVOL += musp * hrm * (-gaQ_du) - hspk * hr2ir * psum * gaQ_d +
            w2m * glq * (qvm - vmq);
    // d_mu (query role; the caller sums it over all rows)
    aMU += spk * volq * hrm * gaP_du;
    // d_pos: both roles; hr' = -1 only inside Spiky's support, so the
    // viscosity term is gated on hrm > 0 (out-of-support pairs in the
    // stencil have subgradient 0); the radial, iso and Laplacian terms
    // carry their own hrm / w2pm factors
    const float visc = (hrm > 0.0f ? musp * inv_r : 0.0f) *
                       (qvol * gaQ_du - volq * gaP_du);
    const float cpre = hspk * psum;
    const float radial = cpre * (2.0f * hrm + hr2ir) * inv_r * inv_r *
                         (volq * gaP_d - qvol * gaQ_d);
    const float lapr = w2pm * inv_r *
                       (volq * qgl * (vmq - qvm) + qvol * glq * (qvm - vmq));
    const float scal = visc - radial + lapr;
    const float iso = cpre * hr2ir;
    gx_ += scal * dx + iso * (volq * qgax - qvol * gax);
    gy_ += scal * dy + iso * (volq * qgay - qvol * gay);
    gz_ += scal * dz + iso * (volq * qgaz - qvol * gaz);
  });

  float* o = out + row * 16;
  o[0] = gx_;
  o[1] = gy_;
  o[2] = gz_;
  o[3] = musp * ux;
  o[4] = musp * uy;
  o[5] = musp * uz;
  o[6] = hspk * aP;  // d_P
  o[7] = aVM;        // d_vm
  o[8] = aVOL;       // d_vol
  o[9] = aMU;        // d_mu partial
#pragma unroll
  for (int c = 10; c < 16; ++c) o[c] = 0.0f;
}

}  // namespace

extern "C" {

int sph_sweep_bwd_a(const float* qm, const float* feats, const int* blk_lo,
                    const int* blk_hi, const float* prm, float* out, int n,
                    int sub_q, int g_mid, void* stream) {
  const size_t smem = RowsBwdA::count * (size_t)sub_q * sizeof(float);
  sweep_bwd_a_kernel<<<n / sub_q, sub_q, smem, (cudaStream_t)stream>>>(
      qm, feats, blk_lo, blk_hi, prm, out, n, g_mid);
  return (int)cudaGetLastError();
}

int sph_sweep_bwd_b(const float* qm, const float* feats, const int* blk_lo,
                    const int* blk_hi, const float* prm, float* out, int n,
                    int sub_q, int g_mid, void* stream) {
  const size_t smem = RowsBwdB::count * (size_t)sub_q * sizeof(float);
  sweep_bwd_b_kernel<<<n / sub_q, sub_q, smem, (cudaStream_t)stream>>>(
      qm, feats, blk_lo, blk_hi, prm, out, n, g_mid);
  return (int)cudaGetLastError();
}

}  // extern "C"

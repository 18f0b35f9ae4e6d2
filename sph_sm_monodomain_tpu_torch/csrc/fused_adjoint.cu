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
// Design: the warp walk of the redesigned forward sweeps K1 / K2
// (sweep_common.cuh for_each_warp_candidate, fused_sweeps.cu
// sweep_b3_xyz3_kernel), under CellWindows. One block of `Slices` warps
// per 32 consecutive sorted query rows (lane = row; Slices from
// warp_slices: 16 on biceps_full, 2 on x56); each warp walks its slice of
// the sub-block's three windows, stages only the candidates inside the
// warp's cell ranges (a ballot per 32-candidate pass, 16 floats a slot,
// __syncwarp only), and every live row applies the exact full per-axis mask
// and runs the pair body on the staged slot, accumulating in fp32 registers
// (9 sums for sweep A, 10 for sweep B). Then the slices' partial sums go
// through shared memory, reusing the warps' stages once every warp has
// finished its walk (sweep_common.cuh add_slices: a 16-slice block stages
// 32 KB, and 16 x 10 x 32 partials take 20 KB, so static shared memory
// stays under the 48 KB limit), warp 0 adds them in
// slice order (no atomics: two launches on the same inputs give the same
// bits) and writes the (N, 16) output contract with zeros in the unused
// columns.
//
// What bounded the first form (one block of 128 threads a sub-block, one
// thread a row, every staged tile between two barriers) on the H100: 145
// blocks of 4 warps on 132 SMs at biceps_full, about 4 resident warps an
// SM, each thread a serial loop over all of its sub-block's candidates.
// This form runs 580 blocks of 16 warps there. The bound is the pair
// arithmetic (43 FLOPs per pair within h for sweep A, 129 within 2h for
// sweep B: tools/roofline.py PAIR_FLOPS); the feature matrix (16 x 18,560
// f32 = 1.2 MB on biceps_full) stays in the 50 MB L2. The pair bodies skip
// a pair as soon as every one of its terms is known to be 0 (outside
// Poly6's support for sweep A, beyond 2h for sweep B).
//
// Measured (H100 80GB HBM3, 700 W, torch.profiler device time,
// compare_builds.py; the first form in brackets): biceps_full K4 0.066 ms
// [0.366], K5 0.134 ms [0.535], at 4.4% and 14.3% of their operation
// bounds; x56 (1,034,600 particles, 2 slices) K4 1.61 ms [2.68], K5 4.18 ms
// [5.96]. K5 launches for 32 warps an SM, so ptxas holds it to 64
// registers at every slice count, with no spill: left to its heuristics it
// took 86 registers at 16 slices (one 512-thread block an SM) and ran
// 0.169 ms (x56: 4.35 ms). ptxas gives K4 64 registers at 8 and 16
// slices, 56 at 2 and 4 (28 bytes spilled).
//
// Numerics: fp32 throughout, IEEE division and sqrt (no --use_fast_math).
// Sweep B's backward uses rsqrtf (maximum error 2 ulp) for 1/r, as the
// forward sweep B does.

#include "sweep_common.cuh"

namespace {

using namespace sph;

// Staged words of a candidate (the transposed query matrix's rows; the
// walk appends cx and cyz from rows 12 and 13):
//   sweep A: pos3 | v3 | vol | mass | gd | gx3 | 0 | 0
//   sweep B: pos3 | u3 | vol | P | vm | ga3 | gl | 0
using WordsBwdA = Rows<0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, -1, -1>;
using WordsBwdB = Rows<0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 14, -1>;

// VJP of sweep A's pair sums (replaces _kernel_bwd_a). Query columns:
// [pos3 | v3 | vol | mass | gd | gx3 | cx | cyz | - -], gd / gx3 the
// cotangents of the density and XSPH sums. Output:
// [d_pos3 | d_v3 | d_vol | d_mass | 0 x 8].
template <int Slices>
__global__ void __launch_bounds__(32 * Slices)
    sweep_bwd_a_kernel(const float* __restrict__ qm,
                       const float* __restrict__ feats,
                       const int* __restrict__ blk_lo,
                       const int* __restrict__ blk_hi,
                       const float* __restrict__ prm,
                       float* __restrict__ out, int n, int sub_q,
                       int g_mid) {
  constexpr int V = (WordsBwdA::count + 2) / 4;
  __shared__ float4 stage[Slices][32 * V];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const size_t row = (size_t)blockIdx.x * 32 + lane;
  const float* q = qm + row * 16;
  const float qx = q[0], qy = q[1], qz = q[2];
  const float qvx = q[3], qvy = q[4], qvz = q[5];
  const float qvol = q[6], qmass = q[7], qgd = q[8];
  const float qgx = q[9], qgy = q[10], qgz = q[11];
  const float qcx = q[12], qcyz = q[13];
  const float h2 = prm[H2], p6c = prm[POLY6];

  // aP (3), aB, aD (3), aE, aF
  float acc[9] = {};
  for_each_warp_candidate(
      CellWindows{g_mid}, WordsBwdA{}, stage[w], feats, blk_lo, blk_hi, n,
      (int)(row / sub_q), w, Slices, qcyz, qcx, qcx >= 0.0f,
      [&](const float* c) {
        const float dx = qx - c[0], dy = qy - c[1], dz = qz - c[2];
        const float r2 = dx * dx + dy * dy + dz * dz;
        // outside Poly6's support every term below carries t^2 or w6
        const float t = fmaxf(h2 - r2, 0.0f);
        if (t == 0.0f) return;
        const float t2 = t * t;
        const float w6 = p6c * (t2 * t);
        // velocity differences v_q (candidate) - v_p (query)
        const float dvx = c[3] - qvx, dvy = c[4] - qvy, dvz = c[5] - qvz;
        const float volq = c[6], gdq = c[8];
        const float gxx = c[9], gxy = c[10], gxz = c[11];
        // s_pq = gd_p m_q + vol_q (gx_p . (v_q - v_p))
        const float s_pq =
            qgd * c[7] + volq * (qgx * dvx + qgy * dvy + qgz * dvz);
        // X = gx_q . (v_p - v_q); s_qp = gd_q m_p + vol_p X
        const float xq = -(gxx * dvx + gxy * dvy + gxz * dvz);
        const float s_qp = gdq * qmass + qvol * xq;
        const float tt = t2 * (s_pq + s_qp);
        acc[0] += tt * dx;
        acc[1] += tt * dy;
        acc[2] += tt * dz;
        acc[3] += w6 * volq;
        acc[4] += w6 * gxx;
        acc[5] += w6 * gxy;
        acc[6] += w6 * gxz;
        acc[7] += w6 * gdq;
        acc[8] += w6 * xq;
      });
  if (!add_slices(stage, acc)) return;

  float* o = out + row * 16;
  const float m6c = -6.0f * p6c;
  o[0] = m6c * acc[0];
  o[1] = m6c * acc[1];
  o[2] = m6c * acc[2];
  o[3] = qvol * acc[4] - qgx * acc[3];
  o[4] = qvol * acc[5] - qgy * acc[3];
  o[5] = qvol * acc[6] - qgz * acc[3];
  o[6] = acc[8];  // d_vol
  o[7] = acc[7];  // d_mass
#pragma unroll
  for (int c = 8; c < 16; ++c) o[c] = 0.0f;
}

// VJP of sweep B's pair sums (replaces _kernel_bwd_b). Query columns:
// [pos3 | u3 | vol | P | vm | ga3 | cx | cyz | gl | -], ga3 / gl the
// cotangents of the acceleration and Laplacian sums. Output:
// [d_pos3 | d_u3 | d_P | d_vm | d_vol | d_mu partial | 0 x 6]; the caller
// sums the d_mu partials over the rows.
template <int Slices>
__global__ void __launch_bounds__(32 * Slices, 1024 / (32 * Slices))
    sweep_bwd_b_kernel(const float* __restrict__ qm,
                       const float* __restrict__ feats,
                       const int* __restrict__ blk_lo,
                       const int* __restrict__ blk_hi,
                       const float* __restrict__ prm,
                       float* __restrict__ out, int n, int sub_q,
                       int g_mid) {
  constexpr int V = (WordsBwdB::count + 2) / 4;
  __shared__ float4 stage[Slices][32 * V];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const size_t row = (size_t)blockIdx.x * 32 + lane;
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

  // d_pos (3), u (3), aP, aVM, aVOL, aMU
  float acc[10] = {};
  for_each_warp_candidate(
      CellWindows{g_mid}, WordsBwdB{}, stage[w], feats, blk_lo, blk_hi, n,
      (int)(row / sub_q), w, Slices, qcyz, qcx, qcx >= 0.0f,
      [&](const float* c) {
        const float dx = qx - c[0], dy = qy - c[1], dz = qz - c[2];
        const float r2 = dx * dx + dy * dy + dz * dz;
        if (!(r2 > kPairEps)) return;  // cpp:546
        const float inv_r = rsqrtf(r2);
        const float rr = r2 * inv_r;
        const float qr = rr * inv_h;
        // beyond B_spline_2's support (2h, and so beyond Spiky's h) every
        // term below is 0: hrm, w2m and w2pm all vanish
        if (qr >= 2.0f) return;
        const float hrm = fmaxf(h - rr, 0.0f);
        const float w2m = bs_c * (1.5f * fmaxf(2.0f - qr, 0.0f) -
                                  6.0f * fmaxf(1.0f - qr, 0.0f));
        // w2' on its active pieces (subgradient 0 at the kinks, as autodiff
        // of the forward's relu form gives)
        const float w2pm = bsd * (6.0f * (qr < 1.0f ? 1.0f : 0.0f) -
                                  1.5f * (qr < 2.0f ? 1.0f : 0.0f));
        const float volq = c[6], Pq = c[7], vmq = c[8], glq = c[12];
        const float gax = c[9], gay = c[10], gaz = c[11];
        // u_q - u_p
        const float dux = c[3] - qux, duy = c[4] - quy, duz = c[5] - quz;
        const float gaP_d = qgax * dx + qgay * dy + qgaz * dz;
        const float gaQ_d = gax * dx + gay * dy + gaz * dz;
        const float gaP_du = qgax * dux + qgay * duy + qgaz * duz;
        const float gaQ_du = gax * dux + gay * duy + gaz * duz;
        const float psum = qP + Pq;
        const float hr2ir = hrm * hrm * inv_r;
        // d_P: (S/2) hr^2/r [vol_q (ga_p . D) - vol_p (ga_q . D)]
        acc[6] += hr2ir * (volq * gaP_d - qvol * gaQ_d);
        // d_u: mu S hr [vol_p ga_q - vol_q ga_p]
        acc[3] += hrm * (qvol * gax - volq * qgax);
        acc[4] += hrm * (qvol * gay - volq * qgay);
        acc[5] += hrm * (qvol * gaz - volq * qgaz);
        // d_vm: w2 [vol_p gl_q - vol_q gl_p]
        acc[7] += w2m * (qvol * glq - volq * qgl);
        // d_vol (candidate role): ga_q . [mu S hr (u_p - u_q)
        //   - (S/2) hr^2/r (P_p + P_q) D] + gl_q w2 (vm_p - vm_q)
        acc[8] += musp * hrm * (-gaQ_du) - hspk * hr2ir * psum * gaQ_d +
                  w2m * glq * (qvm - vmq);
        // d_mu (query role; the caller sums it over all rows)
        acc[9] += spk * volq * hrm * gaP_du;
        // d_pos: both roles; hr' = -1 only inside Spiky's support, so the
        // viscosity term is gated on hrm > 0 (out-of-support pairs in the
        // stencil have subgradient 0); the radial, iso and Laplacian terms
        // carry their own hrm / w2pm factors
        const float visc = (hrm > 0.0f ? musp * inv_r : 0.0f) *
                           (qvol * gaQ_du - volq * gaP_du);
        const float cpre = hspk * psum;
        const float radial = cpre * (2.0f * hrm + hr2ir) * inv_r * inv_r *
                             (volq * gaP_d - qvol * gaQ_d);
        const float lapr =
            w2pm * inv_r *
            (volq * qgl * (vmq - qvm) + qvol * glq * (qvm - vmq));
        const float scal = visc - radial + lapr;
        const float iso = cpre * hr2ir;
        acc[0] += scal * dx + iso * (volq * qgax - qvol * gax);
        acc[1] += scal * dy + iso * (volq * qgay - qvol * gay);
        acc[2] += scal * dz + iso * (volq * qgaz - qvol * gaz);
      });
  if (!add_slices(stage, acc)) return;

  float* o = out + row * 16;
  o[0] = acc[0];
  o[1] = acc[1];
  o[2] = acc[2];
  o[3] = musp * acc[3];
  o[4] = musp * acc[4];
  o[5] = musp * acc[5];
  o[6] = hspk * acc[6];  // d_P
  o[7] = acc[7];         // d_vm
  o[8] = acc[8];         // d_vol
  o[9] = acc[9];         // d_mu partial
#pragma unroll
  for (int c = 10; c < 16; ++c) o[c] = 0.0f;
}

template <int Slices>
struct LaunchBwdA {
  template <class... Args>
  static void run(dim3 grid, cudaStream_t st, Args... args) {
    sweep_bwd_a_kernel<Slices><<<grid, 32 * Slices, 0, st>>>(args...);
  }
};

template <int Slices>
struct LaunchBwdB {
  template <class... Args>
  static void run(dim3 grid, cudaStream_t st, Args... args) {
    sweep_bwd_b_kernel<Slices><<<grid, 32 * Slices, 0, st>>>(args...);
  }
};

}  // namespace

extern "C" {

int sph_sweep_bwd_a(const float* qm, const float* feats, const int* blk_lo,
                    const int* blk_hi, const float* prm, float* out, int n,
                    int sub_q, int g_mid, void* stream) {
  return launch_sliced<LaunchBwdA>(n, stream, qm, feats, blk_lo, blk_hi, prm,
                                   out, n, sub_q, g_mid);
}

int sph_sweep_bwd_b(const float* qm, const float* feats, const int* blk_lo,
                    const int* blk_hi, const float* prm, float* out, int n,
                    int sub_q, int g_mid, void* stream) {
  return launch_sliced<LaunchBwdB>(n, stream, qm, feats, blk_lo, blk_hi, prm,
                                   out, n, sub_q, g_mid);
}

}  // extern "C"

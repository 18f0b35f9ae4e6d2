// Neighbor sweeps of the fused coupled step (v4, v3 and v5 forms) and of the
// frozen-cloud monodomain mode, hand-written for Hopper (sm_90a). Plain C
// interface, loaded through ctypes (sph_sm_monodomain_tpu_torch/ops/
// cuda_lib.py); the Python wrappers are sweep_a3 / sweep_b3 /
// sweep_a3_hash9 / sweep_b3_hash9 / sweep_a5 / sweep_b5 / sweep_lap3 in
// ops/fused_step.py, beside their plain PyTorch versions (sweep_*_plain).
//
// Replaces the Pallas TPU kernels of sph_sm_monodomain_tpu/ops/fused_step.py:
//   _kernel_a3 / _kernel_b3 with stencil="xyz3" (enumeration _gather_loop4)
//     -> sweep_a3_xyz3_kernel / sweep_b3_xyz3_kernel       (K1, K2), over
//        all N sorted rows (sph_sweep_a3 / sph_sweep_b3) or, as the JAX
//        kernels with q_slice and the multi-device steps run them, over a
//        slab of n_q query rows against n_c candidates (sph_sweep_a3_rows
//        / sph_sweep_b3_rows)
//   _kernel_a3 / _kernel_b3 with stencil="hash9" (enumeration _gather_loop)
//     -> sweep_a3_hash9_kernel / sweep_b3_hash9_kernel     (K6)
//   _kernel_a5 / _kernel_b5 (packed slabs)
//     -> sweep_a5_kernel / sweep_b5_kernel                 (K7)
//   _kernel_lap3 (the Laplacian-only sweep) -> sweep_lap3_kernel (K3)
//
// Design: every sweep here runs blocks of `Slices` warps (2 to 16, from
// warp_slices) per 32 sorted query rows; each warp walks a slice of the
// rows' candidates (sweep_common.cuh: the three v4 windows or the nine v3
// hash run windows through for_each_warp_candidate, the v5 slabs through
// for_each_warp_slab_candidate), stages only those inside the warp's cell
// or hash ranges, sums its pairs in fp32 registers, and the slices' sums are
// added in slice order through shared memory (no atomics) before warp 0
// runs the row's epilogue. The windows are iterated exactly; the TPU's
// 128-row start alignment, VMEM/HBM split, chunked DMA, feature padding and
// SMEM budgets are not needed here. The candidate features of a step (16 x
// 18,560 f32 = 1.2 MB on biceps_full) stay in the 50 MB L2; the bound is the
// pair arithmetic.
//
// Numerics: fp32 throughout, IEEE division and sqrt (no --use_fast_math).
// The pair distance uses rsqrtf (maximum error 2 ulp, CUDA math API) where
// the Pallas kernel uses lax.rsqrt. Sums run in window order rather than the
// TPU's lane-wise partial sums, so results agree with the plain version to
// fp32 rounding, not bit for bit.

#include "sweep_common.cuh"

namespace {

using namespace sph;

// Sweep A's epilogue (_a_epilogue, cpp:483-503, 575-593, 699): the OUT_A row
// `o` from the QM_A row `q` and the pair sums. Columns 12-14 (the cell
// features: cx cyz -, hash 0 -, or cf cm cs) are copied through.
__device__ __forceinline__ void epilogue_a(const float* q, const PairSumsA& s,
                                           const float* prm, int with_ep,
                                           int q_double, int q_gate,
                                           int q_acc, float* o) {
  const float mass = q[6], vm = q[8], stim = q[9], iion = q[10], w = q[11];
  const float vmix = prm[VELOCITY_MIXING];
  float dens = s.a_d;
  if (q_double) dens = dens + mass * (s.p6c * s.h2 * s.h2 * s.h2);
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
  o[0] = s.qx;
  o[1] = s.qy;
  o[2] = s.qz;
  o[3] = s.qvx + s.a_x * vmix;
  o[4] = s.qvy + s.a_y * vmix;
  o[5] = s.qvz + s.a_z * vmix;
  o[6] = pres;
  o[7] = vm;
  o[8] = dens;
  o[9] = react;
  o[10] = mass;
  o[11] = iion_n;
  o[12] = q[12];
  o[13] = q[13];
  o[14] = q[14];
  o[15] = w_n;
}

// Sweep B's epilogue (_b_epilogue, cpp:568-571, 596-651): acceleration,
// voltage update, semi-implicit Euler, walls and the AABB clamp.
__device__ __forceinline__ void epilogue_b(const float* q, const PairSumsB& s,
                                           const float* prm, float* o) {
  const float dens = q[8], react = q[9], mass = q[10];
  const float dt = prm[DT];
  const float dens_g = dens > 0.0f ? dens : 1.0f;
  const float acc[3] = {s.a_ax / dens_g, s.a_ay / dens_g, s.a_az / dens_g};
  const float dtm = dt / mass;
  float inter_vm = 0.0f, vm_new = s.qvm;
  if (s.with_ep) {
    inter_vm = s.a_lap + prm[VM_SCALE] * s.a_lap - react;
    vm_new = clampf(s.qvm + inter_vm * dtm, -prm[MAX_VOLTAGE],
                    prm[MAX_VOLTAGE]);
  }
  const float wall_hit = prm[WALL_HIT];
  const float qpos[3] = {s.qx, s.qy, s.qz};
  const float qiv[3] = {s.qivx, s.qivy, s.qivz};
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
  o[8] = s.qp;
  o[9] = q[11];   // iion'
  o[10] = q[15];  // w'
  o[11] = inter_vm;
  o[15] = 0.0f;
}

// The v3 sweeps A and B (K6; replace _kernel_a3 / _kernel_b3 with stencil
// "hash9"): K1's / K2's pair sums under the full hash mask over the nine
// run windows of the row's sub-block, walked by for_each_warp_candidate
// under HashWindows, then the same epilogues. One block of `Slices` warps
// per 32 sorted query rows, the slices' sums added in slice order.
//
// What bounded the first form (one block of sub_q threads a sub-block, one
// thread a row, the nine windows staged through shared memory in tiles of
// sub_q rows, two block barriers a tile) on the H100 80GB HBM3 at 700 W: 145
// blocks of 4 warps on 132 SMs at biceps_full (sub_q 128), each thread
// walking all of its sub-block's ~1,700-1,876 window rows, of which the
// mask kept ~554; A 0.290 ms, B 0.302 ms of device time. This form stages
// only the run of each window inside the warp's hash range, found by binary
// search: 829 candidates a row warp there, of which a row pairs with 67%
// (tests/test_torch_warp_walk.py).
//
// Measured (same card, torch.profiler device time, compare_builds.py; the
// first form in brackets): biceps_full (16 slices) A 0.040 ms [0.290], B
// 0.056 ms [0.302], at 5.0% and 12.5% of their operation bounds; the trim
// is worth 12-20% at sub_q 128 and costs 7% at sub_q 32, where a warp's
// range is its sub-block's. On x56 (2 slices) A 3.22 ms [4.25], B 3.36 ms
// [4.38]: 7 of its 32,332 row warps span a hash range of a whole x-row
// (2,100 cells) or more and stage up to ~100,000 candidates each.
template <int Slices>
__global__ void __launch_bounds__(32 * Slices)
    sweep_a3_hash9_kernel(const float* __restrict__ qm,
                          const float* __restrict__ feats,
                          const int* __restrict__ blk_lo,
                          const int* __restrict__ blk_hi,
                          const float* __restrict__ prm,
                          float* __restrict__ out, int n, int sub_q,
                          int with_ep, int gx, int gy, int q_double,
                          int q_gate, int q_acc) {
  constexpr int V = (WordsHashA::count + 1) / 4;
  __shared__ float4 stage[Slices][32 * V];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const size_t row = (size_t)blockIdx.x * 32 + lane;
  const float* q = qm + row * 16;
  const float qh = q[12];
  PairSumsA s(q, prm);
  // dead rows (hash sentinel) keep zero sums, like the plain version
  for_each_warp_candidate(HashWindows{gx, gy}, WordsHashA{}, stage[w], feats,
                          blk_lo, blk_hi, n, (int)(row / sub_q), w, Slices,
                          qh, 0.0f, qh >= 0.0f,
                          [&](const float* c) { s.add(c, 1, 0); });
  float acc[4] = {s.a_d, s.a_x, s.a_y, s.a_z};
  if (!add_slices(stage, acc)) return;
  s.a_d = acc[0];
  s.a_x = acc[1];
  s.a_y = acc[2];
  s.a_z = acc[3];
  epilogue_a(q, s, prm, with_ep, q_double, q_gate, q_acc, out + row * 16);
}

template <int Slices>
__global__ void __launch_bounds__(32 * Slices)
    sweep_b3_hash9_kernel(const float* __restrict__ qm,
                          const float* __restrict__ feats,
                          const int* __restrict__ blk_lo,
                          const int* __restrict__ blk_hi,
                          const float* __restrict__ prm,
                          float* __restrict__ out, int n, int sub_q,
                          int with_ep, int gx, int gy) {
  constexpr int V = (WordsHashB::count + 1) / 4;
  __shared__ float4 stage[Slices][32 * V];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const size_t row = (size_t)blockIdx.x * 32 + lane;
  const float* q = qm + row * 16;
  const float qh = q[12];
  PairSumsB s(q, prm, with_ep);
  for_each_warp_candidate(HashWindows{gx, gy}, WordsHashB{}, stage[w], feats,
                          blk_lo, blk_hi, n, (int)(row / sub_q), w, Slices,
                          qh, 0.0f, qh >= 0.0f,
                          [&](const float* c) { s.add(c, 1, 0); });
  float acc[4] = {s.a_ax, s.a_ay, s.a_az, s.a_lap};
  if (!add_slices(stage, acc)) return;
  s.a_ax = acc[0];
  s.a_ay = acc[1];
  s.a_az = acc[2];
  s.a_lap = acc[3];
  epilogue_b(q, s, prm, out + row * 16);
}

// The redesigned v4 sweeps A (K1) and B (K2) and Laplacian sweep (K3): one
// block of `Slices` warps per 32 sorted query rows, every warp walking its
// slice of the sub-block's windows through for_each_warp_candidate (only
// candidates inside the warp's cell ranges, staged per warp, no block
// barrier in the walk), its pair sums in registers; then the slices'
// partial sums are added in slice order through shared memory (no atomics:
// two launches on the same inputs give the same bits) and warp 0 runs the
// row's epilogue.
//
// What bounded the first form (one block of sub_q threads a sub-block, one
// thread a row) on the H100: 145 blocks of 4 warps on 132 SMs at
// biceps_full (one thin wave, ~4 resident warps an SM), each thread walking
// all 1,876 candidates of its sub-block's windows a row, of which the mask
// kept 554, with every staged tile between two barriers. This form runs 580
// blocks of 16 warps there (the card full) and stages only the candidates
// inside each warp's cell ranges. The bound is the pair arithmetic: 15
// FLOPs per pair within h for sweep A, 40 within 2h for sweep B, 16 for the
// Laplacian sweep (tools/roofline.py PAIR_FLOPS).
//
// warp_slices (sweep_common.cuh) picks `Slices`: 16 on biceps_full (580
// row warps), 2 on biceps_full x56.
//
// Measured (H100 80GB HBM3, 700 W, CUDA events, compare_builds.py; the
// first form in brackets): biceps_full K2 0.074-0.075 ms [0.362-0.363],
// K3 0.055-0.058 ms [0.386-0.387] against 0.047 ms for a CSR SpMV of K3's
// operator; x56 (1,034,600 particles) K3 1.40 ms [2.13-2.14] against a
// 0.21 ms bound.

// Staged words of a candidate (before its cx, cyz): sweep A pos3 | cvel3 |
// vol_prev | mass | 0 | 0, sweep B pos3 | ivel3 | vol | pres | vm | 0, the
// Laplacian sweep pos3 | vol | vm | 0
using WordsA = Rows<0, 1, 2, 3, 4, 5, 6, 7, -1, -1>;
using WordsB = Rows<0, 1, 2, 3, 4, 5, 6, 7, 8, -1>;
using WordsL = Rows<0, 1, 2, 3, 4, -1>;

// Sweep A on the v4 windows (replaces _kernel_a3 with stencil "xyz3"): the
// PairSumsA sums under the full per-axis mask, then epilogue_a with the
// quirks, with_ep and the constants `prm` (a dynp vector or the config's).
// The launch's rows are the query rows of `qm` (the grid), `blk_lo` /
// `blk_hi` hold their sub-blocks' windows, and `n_c` is the candidate
// count, the row stride of the (16, n_c) `feats`: a slab of query rows
// (the multi-device steps) comes as pointers to its first row and its
// first sub-block's bounds, with window bounds that index the whole
// candidate matrix.
// The plain version takes the cyz half of the mask alone where Poly6's
// support fits one cell (_mask_a_full false): the pairs that half admits
// and the full mask drops have |dcx| >= 2, so they lie more than a cell
// (>= h) apart, PairSumsA::add returns at t == 0 before adding anything,
// and the sums are the same (tests/test_torch_warp_walk.py checks it).
template <int Slices>
__global__ void __launch_bounds__(32 * Slices)
    sweep_a3_xyz3_kernel(const float* __restrict__ qm,
                         const float* __restrict__ feats,
                         const int* __restrict__ blk_lo,
                         const int* __restrict__ blk_hi,
                         const float* __restrict__ prm,
                         float* __restrict__ out, int n_c, int sub_q,
                         int with_ep, int g_mid, int q_double, int q_gate,
                         int q_acc) {
  constexpr int V = (WordsA::count + 2) / 4;
  __shared__ float4 stage[Slices][32 * V];
  __shared__ float part[4][Slices][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const size_t row = (size_t)blockIdx.x * 32 + lane;
  const float* q = qm + row * 16;
  const float qcx = q[12], qcyz = q[13];
  // dead rows (cell sentinel) keep zero sums, like the plain version
  const bool qlive = qcx >= 0.0f;
  PairSumsA s(q, prm);
  for_each_warp_candidate(CellWindows{g_mid}, WordsA{}, stage[w], feats,
                          blk_lo, blk_hi, n_c, (int)(row / sub_q), w, Slices,
                          qcyz, qcx, qlive,
                          [&](const float* c) { s.add(c, 1, 0); });
  part[0][w][lane] = s.a_d;
  part[1][w][lane] = s.a_x;
  part[2][w][lane] = s.a_y;
  part[3][w][lane] = s.a_z;
  __syncthreads();
  if (w != 0) return;
  s.a_d = part[0][0][lane];
  s.a_x = part[1][0][lane];
  s.a_y = part[2][0][lane];
  s.a_z = part[3][0][lane];
#pragma unroll
  for (int k = 1; k < Slices; ++k) {
    s.a_d += part[0][k][lane];
    s.a_x += part[1][k][lane];
    s.a_y += part[2][k][lane];
    s.a_z += part[3][k][lane];
  }
  epilogue_a(q, s, prm, with_ep, q_double, q_gate, q_acc, out + row * 16);
}

// Sweep B on the v4 windows (replaces _kernel_b3 with stencil "xyz3"): the
// PairSumsB sums under the full per-axis mask, then epilogue_b.
template <int Slices>
__global__ void __launch_bounds__(32 * Slices)
    sweep_b3_xyz3_kernel(const float* __restrict__ qm,
                         const float* __restrict__ feats,
                         const int* __restrict__ blk_lo,
                         const int* __restrict__ blk_hi,
                         const float* __restrict__ prm,
                         float* __restrict__ out, int n_c, int sub_q,
                         int with_ep, int g_mid) {
  constexpr int V = (WordsB::count + 2) / 4;
  __shared__ float4 stage[Slices][32 * V];
  __shared__ float part[4][Slices][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const size_t row = (size_t)blockIdx.x * 32 + lane;
  const float* q = qm + row * 16;
  const float qcx = q[12], qcyz = q[13];
  const bool qlive = qcx >= 0.0f;
  PairSumsB s(q, prm, with_ep);
  for_each_warp_candidate(CellWindows{g_mid}, WordsB{}, stage[w], feats,
                          blk_lo, blk_hi, n_c, (int)(row / sub_q), w, Slices,
                          qcyz, qcx, qlive,
                          [&](const float* c) { s.add(c, 1, 0); });
  part[0][w][lane] = s.a_ax;
  part[1][w][lane] = s.a_ay;
  part[2][w][lane] = s.a_az;
  part[3][w][lane] = s.a_lap;
  __syncthreads();
  if (w != 0) return;
  s.a_ax = part[0][0][lane];
  s.a_ay = part[1][0][lane];
  s.a_az = part[2][0][lane];
  s.a_lap = part[3][0][lane];
#pragma unroll
  for (int k = 1; k < Slices; ++k) {
    s.a_ax += part[0][k][lane];
    s.a_ay += part[1][k][lane];
    s.a_az += part[2][k][lane];
    s.a_lap += part[3][k][lane];
  }
  epilogue_b(q, s, prm, out + row * 16);
}

// Laplacian-only sweep (replaces _kernel_lap3): the Vm diffusion half of
// Compute_Force (cpp:562-563) for the frozen-cloud monodomain mode, with two
// accumulators a_vw = sum_j vol_j W2(r_ij) and a_vwvm = sum_j vol_j W2(r_ij)
// vm_j under the full 27-cell mask (W2's support is 2h, so the truncation
// to the stencil is part of the function) and the r^2 > 1e-12 guard. The
// same kernel runs the mode's backward sweep (unit volumes, the cotangent
// as candidate vm, zero query vm), where padding rows are excluded by the
// cell mask alone: their cx sentinel fails |qcx - ccx| <= 1.
template <int Slices>
__global__ void __launch_bounds__(32 * Slices)
    sweep_lap3_kernel(const float* __restrict__ qm,
                      const float* __restrict__ feats,
                      const int* __restrict__ blk_lo,
                      const int* __restrict__ blk_hi,
                      const float* __restrict__ prm, float* __restrict__ out,
                      int n, int sub_q, int g_mid) {
  constexpr int V = (WordsL::count + 2) / 4;
  __shared__ float4 stage[Slices][32 * V];
  __shared__ float part[2][Slices][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const size_t row = (size_t)blockIdx.x * 32 + lane;
  const float* q = qm + row * 16;
  const float qx = q[0], qy = q[1], qz = q[2], qvm = q[3];
  const float qcx = q[12], qcyz = q[13];
  const bool qlive = qcx >= 0.0f;
  const float inv_h = prm[INV_H], bs_c = prm[BSPLINE];

  float a_vw = 0.0f, a_vwvm = 0.0f;
  for_each_warp_candidate(
      CellWindows{g_mid}, WordsL{}, stage[w], feats, blk_lo, blk_hi, n,
      (int)(row / sub_q), w, Slices, qcyz, qcx, qlive, [&](const float* c) {
        const float dx = qx - c[0], dy = qy - c[1], dz = qz - c[2];
        const float r2 = dx * dx + dy * dy + dz * dz;
        if (!(r2 > kPairEps)) return;  // cpp:546
        const float qr = (r2 * rsqrtf(r2)) * inv_h;
        // B_spline_2 (cpp:186-196) in relu form: exactly 0 from q = 2 on
        if (qr >= 2.0f) return;
        const float w2 = bs_c * (1.5f * fmaxf(2.0f - qr, 0.0f) -
                                 6.0f * fmaxf(1.0f - qr, 0.0f));
        const float vw = c[3] * w2;
        a_vw += vw;
        a_vwvm += vw * c[4];
      });
  part[0][w][lane] = a_vw;
  part[1][w][lane] = a_vwvm;
  __syncthreads();
  if (w != 0) return;
  a_vw = part[0][0][lane];
  a_vwvm = part[1][0][lane];
#pragma unroll
  for (int k = 1; k < Slices; ++k) {
    a_vw += part[0][k][lane];
    a_vwvm += part[1][k][lane];
  }
  float* o = out + row * 16;
  o[0] = a_vwvm - a_vw * qvm;
#pragma unroll
  for (int c = 1; c < 16; ++c) o[c] = 0.0f;
}

// The redesigned v5 slab sweeps (K7; replace _kernel_a5 / _kernel_b5): the
// pair sums of sweep A or B over each row's own packed slab under the
// per-axis cell mask, then the same epilogues. One block of `Slices` warps
// per 32 query rows, each warp walking its slice of the slots of the
// slab(s) of its rows through for_each_warp_slab_candidate (a warp spans
// two slabs at sub_q 16, one at 32 and up), the slices' sums added in
// slice order as in the v4 sweeps. A sub-block walks the first
// trips[b] * w_chunk slots of its slab, clipped to kb, or the whole slab
// (v5s, static_trips): both give the same bits, since the padding slots
// are never staged and a slot's slice follows from its index alone.
//
// What bounded the first form (one block of sub_q threads a sub-block):
// 580 one-warp blocks on biceps_full (sub_q 32), 4.4 warps an SM, each
// thread walking every one of its block's 876 slots a row in 32-slot tiles
// between two barriers. The bound is the pair arithmetic, as for K1 / K2.
struct SlabCount {
  const int* trips;
  int kb, w_chunk, static_trips;
  __device__ int operator()(int b) const {
    return static_trips ? kb : min(trips[b] * w_chunk, kb);
  }
};

// Staged words of a slot (before its cf, cm, cs): sweep A pos3 | cvel3 |
// vol_prev | mass | 0, sweep B pos3 | ivel3 | vol | pres | vm
using WordsA5 = Rows<0, 1, 2, 3, 4, 5, 6, 7, -1>;
using WordsB5 = Rows<0, 1, 2, 3, 4, 5, 6, 7, 8>;

template <int Slices>
__global__ void __launch_bounds__(32 * Slices)
    sweep_a5_kernel(const float* __restrict__ qm,
                    const float* __restrict__ slabs,
                    const int* __restrict__ trips,
                    const float* __restrict__ prm, float* __restrict__ out,
                    int n, int sub_q, int kb, int w_chunk, int static_trips,
                    int with_ep, int q_double, int q_gate, int q_acc) {
  constexpr int V = (WordsA5::count + 3) / 4;
  __shared__ float4 stage[Slices][32 * V];
  __shared__ float part[4][Slices][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r0 = blockIdx.x * 32;
  const size_t row = (size_t)r0 + lane;
  // rows past n (a last partial warp) read row n - 1 and write nothing
  const float* q = qm + (size_t)min(r0 + lane, n - 1) * 16;
  PairSumsA s(q, prm);
  for_each_warp_slab_candidate(
      WordsA5{}, stage[w], qm, slabs, n, sub_q, kb,
      SlabCount{trips, kb, w_chunk, static_trips}, r0, w, Slices,
      [&](const float* c) { s.add(c, 1, 0); });
  part[0][w][lane] = s.a_d;
  part[1][w][lane] = s.a_x;
  part[2][w][lane] = s.a_y;
  part[3][w][lane] = s.a_z;
  __syncthreads();
  if (w != 0 || row >= (size_t)n) return;
  s.a_d = part[0][0][lane];
  s.a_x = part[1][0][lane];
  s.a_y = part[2][0][lane];
  s.a_z = part[3][0][lane];
#pragma unroll
  for (int k = 1; k < Slices; ++k) {
    s.a_d += part[0][k][lane];
    s.a_x += part[1][k][lane];
    s.a_y += part[2][k][lane];
    s.a_z += part[3][k][lane];
  }
  epilogue_a(q, s, prm, with_ep, q_double, q_gate, q_acc, out + row * 16);
}

template <int Slices>
__global__ void __launch_bounds__(32 * Slices)
    sweep_b5_kernel(const float* __restrict__ qm,
                    const float* __restrict__ slabs,
                    const int* __restrict__ trips,
                    const float* __restrict__ prm, float* __restrict__ out,
                    int n, int sub_q, int kb, int w_chunk, int static_trips,
                    int with_ep) {
  constexpr int V = (WordsB5::count + 3) / 4;
  __shared__ float4 stage[Slices][32 * V];
  __shared__ float part[4][Slices][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r0 = blockIdx.x * 32;
  const size_t row = (size_t)r0 + lane;
  // rows past n (a last partial warp) read row n - 1 and write nothing
  const float* q = qm + (size_t)min(r0 + lane, n - 1) * 16;
  PairSumsB s(q, prm, with_ep);
  for_each_warp_slab_candidate(
      WordsB5{}, stage[w], qm, slabs, n, sub_q, kb,
      SlabCount{trips, kb, w_chunk, static_trips}, r0, w, Slices,
      [&](const float* c) { s.add(c, 1, 0); });
  part[0][w][lane] = s.a_ax;
  part[1][w][lane] = s.a_ay;
  part[2][w][lane] = s.a_az;
  part[3][w][lane] = s.a_lap;
  __syncthreads();
  if (w != 0 || row >= (size_t)n) return;
  s.a_ax = part[0][0][lane];
  s.a_ay = part[1][0][lane];
  s.a_az = part[2][0][lane];
  s.a_lap = part[3][0][lane];
#pragma unroll
  for (int k = 1; k < Slices; ++k) {
    s.a_ax += part[0][k][lane];
    s.a_ay += part[1][k][lane];
    s.a_az += part[2][k][lane];
    s.a_lap += part[3][k][lane];
  }
  epilogue_b(q, s, prm, out + row * 16);
}

template <int Slices>
struct LaunchA3 {
  template <class... Args>
  static void run(dim3 grid, cudaStream_t st, Args... args) {
    sweep_a3_xyz3_kernel<Slices><<<grid, 32 * Slices, 0, st>>>(args...);
  }
};

template <int Slices>
struct LaunchB3 {
  template <class... Args>
  static void run(dim3 grid, cudaStream_t st, Args... args) {
    sweep_b3_xyz3_kernel<Slices><<<grid, 32 * Slices, 0, st>>>(args...);
  }
};

template <int Slices>
struct LaunchA3Hash9 {
  template <class... Args>
  static void run(dim3 grid, cudaStream_t st, Args... args) {
    sweep_a3_hash9_kernel<Slices><<<grid, 32 * Slices, 0, st>>>(args...);
  }
};

template <int Slices>
struct LaunchB3Hash9 {
  template <class... Args>
  static void run(dim3 grid, cudaStream_t st, Args... args) {
    sweep_b3_hash9_kernel<Slices><<<grid, 32 * Slices, 0, st>>>(args...);
  }
};

template <int Slices>
struct LaunchLap3 {
  template <class... Args>
  static void run(dim3 grid, cudaStream_t st, Args... args) {
    sweep_lap3_kernel<Slices><<<grid, 32 * Slices, 0, st>>>(args...);
  }
};

template <int Slices>
struct LaunchA5 {
  template <class... Args>
  static void run(dim3 grid, cudaStream_t st, Args... args) {
    sweep_a5_kernel<Slices><<<grid, 32 * Slices, 0, st>>>(args...);
  }
};

template <int Slices>
struct LaunchB5 {
  template <class... Args>
  static void run(dim3 grid, cudaStream_t st, Args... args) {
    sweep_b5_kernel<Slices><<<grid, 32 * Slices, 0, st>>>(args...);
  }
};

}  // namespace

extern "C" {

// `mask_full` stays in the interface (compare_builds.py swaps libraries
// of one interface); the warp walk takes the full mask either way, which
// gives the same sums (sweep_a3_xyz3_kernel).
int sph_sweep_a3(const float* qm, const float* feats, const int* blk_lo,
                 const int* blk_hi, const float* prm, float* out, int n,
                 int sub_q, int with_ep, int mask_full, int g_mid,
                 int quirk_double_self_density, int quirk_pressure_stim_gate,
                 int quirk_iion_accumulate, void* stream) {
  (void)mask_full;
  return launch_sliced<LaunchA3>(n, stream, qm, feats, blk_lo, blk_hi, prm,
                                 out, n, sub_q, with_ep, g_mid,
                                 quirk_double_self_density,
                                 quirk_pressure_stim_gate,
                                 quirk_iion_accumulate);
}

int sph_sweep_b3(const float* qm, const float* feats, const int* blk_lo,
                 const int* blk_hi, const float* prm, float* out, int n,
                 int sub_q, int with_ep, int g_mid, void* stream) {
  return launch_sliced<LaunchB3>(n, stream, qm, feats, blk_lo, blk_hi, prm,
                                 out, n, sub_q, with_ep, g_mid);
}

// K1 / K2 on a slab of query rows (the JAX kernels' q_slice, and the halo
// step's S local rows against its S + 2H merged candidates): `qm`, `blk_lo`
// and `blk_hi` point at the slab's first row and first sub-block, `out`
// receives its n_q rows, and `feats` is the whole (16, n_c) candidate
// matrix the windows index. The warp-slice count is picked from n_q, not
// n_c: warp_slices fills the card with the launch's n_q / 32 row warps,
// and a row warp's own walk does not depend on how many candidates lie
// outside its windows.
int sph_sweep_a3_rows(const float* qm, const float* feats,
                      const int* blk_lo, const int* blk_hi, const float* prm,
                      float* out, int n_q, int n_c, int sub_q, int with_ep,
                      int g_mid, int quirk_double_self_density,
                      int quirk_pressure_stim_gate,
                      int quirk_iion_accumulate, void* stream) {
  return launch_sliced<LaunchA3>(n_q, stream, qm, feats, blk_lo, blk_hi, prm,
                                 out, n_c, sub_q, with_ep, g_mid,
                                 quirk_double_self_density,
                                 quirk_pressure_stim_gate,
                                 quirk_iion_accumulate);
}

int sph_sweep_b3_rows(const float* qm, const float* feats,
                      const int* blk_lo, const int* blk_hi, const float* prm,
                      float* out, int n_q, int n_c, int sub_q, int with_ep,
                      int g_mid, void* stream) {
  return launch_sliced<LaunchB3>(n_q, stream, qm, feats, blk_lo, blk_hi, prm,
                                 out, n_c, sub_q, with_ep, g_mid);
}

int sph_sweep_a3_hash9(const float* qm, const float* feats,
                       const int* blk_lo, const int* blk_hi, const float* prm,
                       float* out, int n, int sub_q, int with_ep, int gx,
                       int gy, int quirk_double_self_density,
                       int quirk_pressure_stim_gate,
                       int quirk_iion_accumulate, void* stream) {
  return launch_sliced<LaunchA3Hash9>(n, stream, qm, feats, blk_lo, blk_hi,
                                      prm, out, n, sub_q, with_ep, gx, gy,
                                      quirk_double_self_density,
                                      quirk_pressure_stim_gate,
                                      quirk_iion_accumulate);
}

int sph_sweep_b3_hash9(const float* qm, const float* feats,
                       const int* blk_lo, const int* blk_hi, const float* prm,
                       float* out, int n, int sub_q, int with_ep, int gx,
                       int gy, void* stream) {
  return launch_sliced<LaunchB3Hash9>(n, stream, qm, feats, blk_lo, blk_hi,
                                      prm, out, n, sub_q, with_ep, gx, gy);
}

int sph_sweep_a5(const float* qm, const float* slab, const int* trips,
                 const float* prm, float* out, int n, int sub_q, int kb,
                 int w_chunk, int static_trips, int with_ep,
                 int quirk_double_self_density, int quirk_pressure_stim_gate,
                 int quirk_iion_accumulate, void* stream) {
  return launch_sliced<LaunchA5>(n, stream, qm, slab, trips, prm, out, n,
                                 sub_q, kb, w_chunk, static_trips, with_ep,
                                 quirk_double_self_density,
                                 quirk_pressure_stim_gate,
                                 quirk_iion_accumulate);
}

int sph_sweep_b5(const float* qm, const float* slab, const int* trips,
                 const float* prm, float* out, int n, int sub_q, int kb,
                 int w_chunk, int static_trips, int with_ep, void* stream) {
  return launch_sliced<LaunchB5>(n, stream, qm, slab, trips, prm, out, n,
                                 sub_q, kb, w_chunk, static_trips, with_ep);
}

int sph_sweep_lap3(const float* qm, const float* feats, const int* blk_lo,
                   const int* blk_hi, const float* prm, float* out, int n,
                   int sub_q, int g_mid, void* stream) {
  return launch_sliced<LaunchLap3>(n, stream, qm, feats, blk_lo, blk_hi, prm,
                                   out, n, sub_q, g_mid);
}

const char* sph_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

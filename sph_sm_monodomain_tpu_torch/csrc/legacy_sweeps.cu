// The v1 and v2 raw-sum neighbor sweeps, hand-written for Hopper (sm_90a):
// the ablation baselines of the fused step. Plain C interface, loaded through
// ctypes (sph_sm_monodomain_tpu_torch/ops/cuda_lib.py); the Python wrappers
// are sweep_a / sweep_b / sweep_a2 / sweep_b2 in ablation/legacy_sweeps.py,
// beside their plain PyTorch versions (sweep_*_plain).
//
// Replaces the Pallas TPU kernels of
// sph_sm_monodomain_tpu/ablation/legacy_sweeps.py:
//   _sweep_a_kernel / _sweep_b_kernel (v1)   -> sweep_a1_kernel / sweep_b1_kernel
//                                               (K8)
//   _sweep_a2_kernel / _sweep_b2_kernel (v2) -> sweep_a2_kernel / sweep_b2_kernel
//                                               (K9)
// Each writes the raw pair sums of a sorted query row, (N, 4) f32, with no
// epilogue: sweep A [dens, xsph3] (the query's own row counted in the
// density), sweep B [acc_raw3 (before the division by the query's density),
// lap]. The step's glue (ablation/legacy_steps.py) runs the pointwise phases
// in PyTorch.
//
// K8 design. K9's blocks and slices (2 to 16 warps per 32 sorted query
// rows, from warp_slices; the slices' raw sums added in slice order by
// add_slices) on the run walk (sweep_common.cuh
// for_each_warp_run_candidate): each sorted row brings its nine exact runs
// [qstart[i, r], qend[i, r]) (sweep_bookkeeping: the x-neighbour cells of
// one (dy, dz) row of its 27-cell stencil), and window r of a warp is the
// union of its rows' nonempty runs r, cut at the widest gap between them
// (the warp whose rows span two x-rows skips the x-row between). No binary
// search and no hash: each staged slot carries its candidate's row index,
// and each row masks it by its own run. The TPU kernel walks each
// sub-block's 128-aligned block windows and masks every candidate by the
// query's runs; the block windows are supersets of the runs, so walking
// the runs computes the same function, and the kernel does not read them.
//
// K9 design. K6's (sweep_common.cuh for_each_warp_candidate under
// HashWindows): blocks of `Slices` warps (2 to 16, from warp_slices) per
// 32 sorted query rows of a sub-block of sub_q rows; each warp trims the
// sub-block's nine run windows [lo, hi) (sweep_bookkeeping2) to the runs
// inside its rows' hash range, walks its slice of them laid end to end,
// stages the candidates per warp (no block barrier in the walk) and masks
// each by |qh + d_r - ch| <= 1 on the linear cell hash in row / column 12;
// the slices' raw sums are added in slice order (add_slices). The TPU's
// 128-aligned window start only adds rows the hash test rejects. The pair
// sums are K1's / K2's (PairSumsA / PairSumsB).
//
// Pair arithmetic. K8 A and both K9 sweeps use PairSumsA / PairSumsB. K8 B
// keeps v1's own (PairSumsB1): r = sqrtf(r^2) and 1/r a division (IEEE:
// no --use_fast_math), Spiky support r <= h, the B-spline in its piecewise
// form with support q < 2, and q = r * (1/h) with 1/h an fp32 division.
// Every sum is accumulated per pair in difference form, f * (x_j - x_i), not
// the TPU's sum-then-subtract x_i * sum f - sum f * x_j: that form is the
// layout of the MXU output contraction (_dotT), and it loses about |x|/|dx|
// of relative precision; this card runs fp32 without tensor cores.
//
// What bounds K8 and K9 on the H100, like K6: the pair arithmetic and the
// warp's staging, not memory (the features and run bounds are a few MB and
// stay in the 50 MB L2). The run walk stages 816 candidates a row warp on
// biceps_full, of which a row pairs with 68% (554 pairs a row), and on x56
// at most 8,933 (the union uncut: 100,572); the first form, one thread a
// row looping over its own runs in 580 warps, ran at 1.7% / 1.9% of the
// operation bound. Measured (H100 80GB HBM3, 700 W, torch.profiler device
// time, compare_builds.py, on the inputs the v1 / v2 step gives them; the
// first forms in brackets): K8 biceps_full A 0.045 ms [0.118], B 0.075 ms
// [0.359], 4.4% / 9.3% of the bound; x56 (2 slices) A 1.09 ms [1.09], B
// 2.38 ms [2.58]. K9 biceps_full A 0.037 ms [0.261], B 0.055 ms [0.300] at
// sub_q 128, the same [0.220, 0.252] at sub_q 32; x56 (2 slices, on K6's
// matrices) A 3.60 ms [3.71], B 3.27 ms [4.30].

#include "sweep_common.cuh"

namespace {

using namespace sph;

// v1 sweep B's pair sums (legacy_sweeps.py:239-272), reading rows 0-8 of
// candidate k of a row-major feature block of width T (a staged slot: T =
// 1, k = 0).
struct PairSumsB1 {
  float qx, qy, qz, qivx, qivy, qivz, qp, qvm, h, inv_h, spiky_c, bs_c, mu;
  float a_ax = 0.0f, a_ay = 0.0f, a_az = 0.0f, a_lap = 0.0f;

  __device__ PairSumsB1(const float* q, const float* prm)
      : qx(q[0]), qy(q[1]), qz(q[2]), qivx(q[3]), qivy(q[4]), qivz(q[5]),
        qp(q[6]), qvm(q[7]), h(prm[KERNEL_H]), inv_h(1.0f / prm[KERNEL_H]),
        spiky_c(prm[SPIKY]), bs_c(prm[BSPLINE]), mu(prm[MU_VISCOSITY]) {}

  __device__ __forceinline__ void add(const float* f, int T, int k) {
    const float dx = qx - f[k], dy = qy - f[T + k], dz = qz - f[2 * T + k];
    const float r2 = dx * dx + dy * dy + dz * dz;
    if (!(r2 > kPairEps)) return;  // cpp:546
    const float rr = sqrtf(r2);
    const float inv_rr = 1.0f / rr;
    const float vol = f[6 * T + k];
    if (rr <= h) {
      // pressure (cpp:550-554) and viscosity (cpp:556-560) share the
      // support [0, h] and the factor vol * Spiky_c * (h - r)
      const float hr = h - rr;
      const float common = vol * (spiky_c * hr);
      const float f_p =
          common * (hr * (-0.5f) * inv_rr) * (qp + f[7 * T + k]);
      const float f_v = mu * common;
      a_ax += f_v * (f[3 * T + k] - qivx) - f_p * dx;
      a_ay += f_v * (f[4 * T + k] - qivy) - f_p * dy;
      a_az += f_v * (f[5 * T + k] - qivz) - f_p * dz;
    }
    // monodomain Laplacian (cpp:562-563): B_spline_2 on [0, 2h)
    const float qr = rr * inv_h;
    const float w2 = qr < 1.0f   ? bs_c * (-3.0f + 4.5f * qr)
                     : qr < 2.0f ? bs_c * 1.5f * (2.0f - qr)
                                 : 0.0f;
    a_lap += (vol * w2) * (f[8 * T + k] - qvm);
  }
};

// v1 sweep A (replaces _sweep_a_kernel): Poly6 density + XSPH over the
// runs, on the run walk.
template <int Slices>
__global__ void __launch_bounds__(32 * Slices)
    sweep_a1_kernel(const float* __restrict__ qm,
                    const float* __restrict__ feats,
                    const int* __restrict__ qstart,
                    const int* __restrict__ qend,
                    const float* __restrict__ prm, float* __restrict__ out,
                    int n) {
  constexpr int V = (WordsHashA::count + 1) / 4;
  __shared__ float4 stage[Slices][32 * V];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const size_t row = (size_t)blockIdx.x * 32 + lane;
  const bool in = row < (size_t)n;
  PairSumsA s(qm + (in ? row : 0) * 16, prm);
  for_each_warp_run_candidate(WordsHashA{}, stage[w], feats, qstart, qend, n,
                              row, w, Slices,
                              [&](const float* c) { s.add(c, 1, 0); });
  float acc[4] = {s.a_d, s.a_x, s.a_y, s.a_z};
  if (!add_slices(stage, acc) || !in) return;
  float* o = out + row * 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = acc[k];
}

// v1 sweep B (replaces _sweep_b_kernel): forces + Vm Laplacian over the
// runs, on the run walk.
template <int Slices>
__global__ void __launch_bounds__(32 * Slices)
    sweep_b1_kernel(const float* __restrict__ qm,
                    const float* __restrict__ feats,
                    const int* __restrict__ qstart,
                    const int* __restrict__ qend,
                    const float* __restrict__ prm, float* __restrict__ out,
                    int n) {
  constexpr int V = (WordsHashB::count + 1) / 4;
  __shared__ float4 stage[Slices][32 * V];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const size_t row = (size_t)blockIdx.x * 32 + lane;
  const bool in = row < (size_t)n;
  PairSumsB1 s(qm + (in ? row : 0) * 16, prm);
  for_each_warp_run_candidate(WordsHashB{}, stage[w], feats, qstart, qend, n,
                              row, w, Slices,
                              [&](const float* c) { s.add(c, 1, 0); });
  float acc[4] = {s.a_ax, s.a_ay, s.a_az, s.a_lap};
  if (!add_slices(stage, acc) || !in) return;
  float* o = out + row * 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = acc[k];
}

// v2 sweep A (replaces _sweep_a2_kernel): K6's run windows, hash mask and
// walk, raw sums. A dead query (hash sentinel) keeps zero sums.
template <int Slices>
__global__ void __launch_bounds__(32 * Slices)
    sweep_a2_kernel(const float* __restrict__ qm,
                    const float* __restrict__ feats,
                    const int* __restrict__ blk_lo,
                    const int* __restrict__ blk_hi,
                    const float* __restrict__ prm, float* __restrict__ out,
                    int n, int sub_q, int gx, int gy) {
  constexpr int V = (WordsHashA::count + 1) / 4;
  __shared__ float4 stage[Slices][32 * V];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const size_t row = (size_t)blockIdx.x * 32 + lane;
  const float* q = qm + row * 16;
  PairSumsA s(q, prm);
  for_each_warp_candidate(HashWindows{gx, gy}, WordsHashA{}, stage[w], feats,
                          blk_lo, blk_hi, n, (int)(row / sub_q), w, Slices,
                          q[12], 0.0f, q[12] >= 0.0f,
                          [&](const float* c) { s.add(c, 1, 0); });
  float acc[4] = {s.a_d, s.a_x, s.a_y, s.a_z};
  if (!add_slices(stage, acc)) return;
  float* o = out + row * 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = acc[k];
}

// v2 sweep B (replaces _sweep_b2_kernel).
template <int Slices>
__global__ void __launch_bounds__(32 * Slices)
    sweep_b2_kernel(const float* __restrict__ qm,
                    const float* __restrict__ feats,
                    const int* __restrict__ blk_lo,
                    const int* __restrict__ blk_hi,
                    const float* __restrict__ prm, float* __restrict__ out,
                    int n, int sub_q, int gx, int gy) {
  constexpr int V = (WordsHashB::count + 1) / 4;
  __shared__ float4 stage[Slices][32 * V];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const size_t row = (size_t)blockIdx.x * 32 + lane;
  const float* q = qm + row * 16;
  PairSumsB s(q, prm, 1);
  for_each_warp_candidate(HashWindows{gx, gy}, WordsHashB{}, stage[w], feats,
                          blk_lo, blk_hi, n, (int)(row / sub_q), w, Slices,
                          q[12], 0.0f, q[12] >= 0.0f,
                          [&](const float* c) { s.add(c, 1, 0); });
  float acc[4] = {s.a_ax, s.a_ay, s.a_az, s.a_lap};
  if (!add_slices(stage, acc)) return;
  float* o = out + row * 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = acc[k];
}

template <int Slices>
struct LaunchA1 {
  template <class... Args>
  static void run(dim3 grid, cudaStream_t st, Args... args) {
    sweep_a1_kernel<Slices><<<grid, 32 * Slices, 0, st>>>(args...);
  }
};

template <int Slices>
struct LaunchB1 {
  template <class... Args>
  static void run(dim3 grid, cudaStream_t st, Args... args) {
    sweep_b1_kernel<Slices><<<grid, 32 * Slices, 0, st>>>(args...);
  }
};

template <int Slices>
struct LaunchA2 {
  template <class... Args>
  static void run(dim3 grid, cudaStream_t st, Args... args) {
    sweep_a2_kernel<Slices><<<grid, 32 * Slices, 0, st>>>(args...);
  }
};

template <int Slices>
struct LaunchB2 {
  template <class... Args>
  static void run(dim3 grid, cudaStream_t st, Args... args) {
    sweep_b2_kernel<Slices><<<grid, 32 * Slices, 0, st>>>(args...);
  }
};

}  // namespace

extern "C" {

int sph_sweep_a1(const float* qm, const float* feats, const int* qstart,
                 const int* qend, const float* prm, float* out, int n,
                 void* stream) {
  return launch_sliced<LaunchA1>(n, stream, qm, feats, qstart, qend, prm, out,
                                 n);
}

int sph_sweep_b1(const float* qm, const float* feats, const int* qstart,
                 const int* qend, const float* prm, float* out, int n,
                 void* stream) {
  return launch_sliced<LaunchB1>(n, stream, qm, feats, qstart, qend, prm, out,
                                 n);
}

int sph_sweep_a2(const float* qm, const float* feats, const int* blk_lo,
                 const int* blk_hi, const float* prm, float* out, int n,
                 int sub_q, int gx, int gy, void* stream) {
  return launch_sliced<LaunchA2>(n, stream, qm, feats, blk_lo, blk_hi, prm,
                                 out, n, sub_q, gx, gy);
}

int sph_sweep_b2(const float* qm, const float* feats, const int* blk_lo,
                 const int* blk_hi, const float* prm, float* out, int n,
                 int sub_q, int gx, int gy, void* stream) {
  return launch_sliced<LaunchB2>(n, stream, qm, feats, blk_lo, blk_hi, prm,
                                 out, n, sub_q, gx, gy);
}

}  // extern "C"

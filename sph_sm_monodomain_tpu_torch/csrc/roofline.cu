// The fp32 FMA-chain throughput probe of the roofline tool, hand-written for
// Hopper (sm_90a). Plain C interface, loaded through ctypes
// (sph_sm_monodomain_tpu_torch/ops/cuda_lib.py); the Python wrapper is
// fma_chains in sph_sm_monodomain_tpu_torch/tools/roofline.py, beside its
// plain PyTorch version fma_chains_plain.
//
// Replaces the Pallas TPU kernel of tools/roofline.py: the inner `kernel` of
// measure_vpu_peak (16 independent chains a = a * 1.0000001 + 0.5 on an
// (8, 128) tile, register-resident, summed at the end).
//
// Design. Each thread runs kChains independent register-resident chains
// a_k = fmaf(a_k, 1.0000001f, 0.5f), starting from x[i] * (1 + 0.001 k), and
// writes their sum (in chain order) so nothing folds away. An FMA has a
// latency of about 4 cycles and each of an SM's four schedulers issues one
// warp instruction a cycle, so 16 independent chains per thread keep every
// FP32 lane busy with one warp per scheduler; the launch gives each SM
// several warps besides. The iteration count is a run-time argument (so the
// compiler cannot fold the chains) and the loop is unrolled 8 deep, so its
// counter costs about one issue slot in 128. Bound by operations by design:
// 2 FLOPs (one FMA) per chain and iteration, 4 bytes read and 4 written per
// thread.

#include <cuda_runtime.h>

namespace {

constexpr int kChains = 16;  // tools/roofline.py FMA_CHAINS

__global__ void fma_chains_kernel(const float* __restrict__ x,
                                  float* __restrict__ out, int n, int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k)
    a[k] = x[i] * (float)(1.0 + 0.001 * k);  // the double, rounded once
#pragma unroll 8
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) a[k] = fmaf(a[k], 1.0000001f, 0.5f);
  }
  float s = a[0];
#pragma unroll
  for (int k = 1; k < kChains; ++k) s += a[k];
  out[i] = s;
}

}  // namespace

extern "C" {

int sph_fma_chains(const float* x, float* out, int n, int iters,
                   int threads_per_block, void* stream) {
  const int blocks = (n + threads_per_block - 1) / threads_per_block;
  fma_chains_kernel<<<blocks, threads_per_block, 0, (cudaStream_t)stream>>>(
      x, out, n, iters);
  return (int)cudaGetLastError();
}

}  // extern "C"

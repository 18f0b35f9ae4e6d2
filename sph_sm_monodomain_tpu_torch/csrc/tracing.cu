// Program tracing on the card: the device stamp and the kernel-node count of
// a captured graph. Plain C interface, loaded through ctypes
// (sph_sm_monodomain_tpu_torch/ops/cuda_lib.py); the Python side is
// sph_sm_monodomain_tpu_torch/utils/tracing.py.
//
// Replaces no TPU kernel: the JAX package times its phases from outside the
// compiled step. Here a step's stages are timed from inside the captured
// graph that runs it, with no host sync and no profiler.
//
// The stamp. One thread reads the card's global nanosecond timer
// (%globaltimer), adds the time since the previous stamp into acc[slot] and
// stores the new time in acc[last]. acc[last] == 0 means no stamp yet, so no
// time is charged before a unit's first stamp. Stamps launch on the stream of
// the work they bound, so each reads the timer once everything before it on
// that stream has finished: a slot holds the time from the previous stamp's
// start to its own, the kernels between them and their launch gaps. Bound by
// launch latency (about a microsecond inside a graph); it reads and writes
// 16 bytes.
//
// The node count. Walks a captured (not yet destroyed) cudaGraph_t, child
// graphs included, and counts its kernel nodes (every kernel a replay
// launches, the port's own and PyTorch's alike), its memcpy nodes and its
// memset nodes.

#include <cuda_runtime.h>

#include <vector>

namespace {

__global__ void stamp_kernel(long long* __restrict__ acc, int slot,
                             int last) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long prev = acc[last];
  if (prev != 0) acc[slot] += (long long)now - prev;
  acc[last] = (long long)now;
}

// counts: kernel, memcpy, memset nodes
cudaError_t count_nodes(cudaGraph_t graph, int* counts) {
  size_t n = 0;
  cudaError_t rc = cudaGraphGetNodes(graph, nullptr, &n);
  if (rc != cudaSuccess || n == 0) return rc;
  std::vector<cudaGraphNode_t> nodes(n);
  rc = cudaGraphGetNodes(graph, nodes.data(), &n);
  if (rc != cudaSuccess) return rc;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType type;
    rc = cudaGraphNodeGetType(nodes[i], &type);
    if (rc != cudaSuccess) return rc;
    if (type == cudaGraphNodeTypeKernel) {
      ++counts[0];
    } else if (type == cudaGraphNodeTypeMemcpy) {
      ++counts[1];
    } else if (type == cudaGraphNodeTypeMemset) {
      ++counts[2];
    } else if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      rc = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (rc != cudaSuccess) return rc;
      rc = count_nodes(child, counts);
      if (rc != cudaSuccess) return rc;
    }
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

int sph_stamp(long long* acc, int slot, int last, void* stream) {
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(acc, slot, last);
  return (int)cudaGetLastError();
}

int sph_graph_nodes(void* graph, int* counts) {
  counts[0] = counts[1] = counts[2] = 0;
  return (int)count_nodes((cudaGraph_t)graph, counts);
}

}  // extern "C"

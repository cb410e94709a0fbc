// Histogram bucket probe (paper section 4.2) for Hopper (sm_90a).
//
// Replaces the TPU kernel `bucketize_kernel`
// (src/repro/kernels/bucketize/kernel.py:40, pallas_call at :48):
//   ids[i] = clip(#{bounds <= values[i]} - 1, 0, resolution - 1)
// which equals searchsorted(bounds, v, side="right") - 1, clipped, for
// nondecreasing bounds. Callers: the index build (every tuple of the table)
// and predicate conversion (both endpoints of every predicate).
//
// What bounds it on the H100: bytes. Each value is read once (4 B) and its
// id written once (4 B); the H+1 bounds are a few KB. At SF10 (60 M values)
// that is 480 MB, ~0.14 ms at the H100 SXM's published 3.35 TB/s (700 W).
//
// Design: the TPU version compared every value with every bound (O(H) vector
// compares per value) because a branchy search is hostile to its vector
// unit. Here the bounds sit in shared memory and each thread runs a binary
// search (O(log H) shared-memory reads, the branch turned into selects), so
// the probe stays well under the memory time. A grid-stride loop over a
// capped grid loads the bounds into shared memory once per block, not once
// per 256 values. Values are read and ids written by consecutive threads at
// consecutive addresses (coalesced).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;  // 32 blocks per SM, then stride

__global__ void bucketize_kernel(const float* __restrict__ values, int64_t n,
                                 const float* __restrict__ bounds, int nb,
                                 int resolution, int* __restrict__ out) {
  extern __shared__ float sb[];
  for (int i = threadIdx.x; i < nb; i += blockDim.x) sb[i] = bounds[i];
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float v = values[i];
    // upper bound: the number of bounds <= v
    int first = 0;
    int len = nb;
    while (len > 0) {
      const int half = len >> 1;
      const bool right = sb[first + half] <= v;
      first = right ? first + half + 1 : first;
      len = right ? len - half - 1 : half;
    }
    int id = first - 1;
    id = id < 0 ? 0 : id;
    id = id > resolution - 1 ? resolution - 1 : id;
    out[i] = id;
  }
}

}  // namespace

extern "C" int hippo_bucketize(const float* values, int64_t n,
                               const float* bounds, int nb, int resolution,
                               int* out, cudaStream_t stream) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks > 0) {
    bucketize_kernel<<<(unsigned)blocks, kThreads, nb * sizeof(float),
                       stream>>>(values, n, bounds, nb, resolution, out);
  }
  return (int)cudaGetLastError();
}

// Error text for the codes the C entry points of every csrc file return.
extern "C" const char* hippo_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

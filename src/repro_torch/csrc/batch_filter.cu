// Sharded joint-bucket filter (paper section 3.2, batched) for Hopper (sm_90a).
//
// Replaces the TPU kernel `batch_filter_sharded_kernel`
// (src/repro/kernels/batch_filter/kernel.py:59, pallas_call at :74):
//   out[s, q, e] = live[s, e] && any_w(queries[s, q, w] & entries[s, e, w])
// Two changes of contract against the TPU kernel: the queries carry a shard
// axis (S, Q, W), one conversion per shard bounds epoch as the main path
// feeds them (src/repro/core/index.py:428 vmaps over per-shard query
// bitmaps), and the live-slot mask (`slot_live & slot < num_slots`,
// src/repro/core/index.py:426-429) is fused in. Words are int32 holding the
// reference's uint32 bits.
//
// What bounds it on the H100: bytes. Entry words are read once (S*E*W*4 B),
// the (S, Q, E) match bytes written once; the queries are a few KB. At SF10
// (S=4, E=470 K slots, W=13, Q=64) that is ~98 MB in and ~120 MB out,
// ~0.07 ms at the H100 SXM's published 3.35 TB/s (700 W). The AND work
// (S*Q*E*W word ops) is far below the integer rate.
//
// Design: one block per (tile of 128 entries, shard); each thread keeps its
// entry's W words in registers (read once) and loops over the shard's
// queries, which are staged in shared memory 64 at a time and read as
// broadcasts. For one query the threads of a block write consecutive match
// bytes (coalesced stores). Words with bit 31 set are handled as unsigned.
//
// The second entry point, `hippo_batch_filter`, replaces the unsharded TPU
// kernel `batch_filter_kernel` (src/repro/kernels/batch_filter/kernel.py:32,
// pallas_call at :39): out[q, e] = live[e] && any_w(queries[q, w] &
// entries[e, w]), (Q, W) x (E, W) -> (Q, E). It is this kernel at S=1, with
// the live mask fused the same way. It carries `search_many` (the
// HippoIndex batch and each routed per-shard dispatch). Bound at SF10
// (E=1,500,676, W=13, Q=64): ~78 MB of entry words in and ~96 MB of match
// bytes out, ~0.052 ms at 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;    // entries per block
constexpr int kMaxWords = 32;    // resolution <= 1024
constexpr int kQueryTile = 64;   // queries staged in shared memory at once

__global__ void batch_filter_sharded_kernel(
    const int32_t* __restrict__ queries, const int32_t* __restrict__ entries,
    const uint8_t* __restrict__ live, int Q, int E, int W,
    uint8_t* __restrict__ out) {
  __shared__ uint32_t qs[kQueryTile * kMaxWords];
  const int s = blockIdx.y;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = e < E;
  uint32_t words[kMaxWords];
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w) {
    words[w] = (in && w < W)
                   ? (uint32_t)entries[((int64_t)s * E + e) * W + w] : 0u;
  }
  const bool alive = in && live[(int64_t)s * E + e] != 0;
  const int32_t* qshard = queries + (int64_t)s * Q * W;
  uint8_t* oshard = out + (int64_t)s * Q * E;
  for (int q0 = 0; q0 < Q; q0 += kQueryTile) {
    const int nq = min(kQueryTile, Q - q0);
    __syncthreads();
    for (int i = threadIdx.x; i < nq * W; i += blockDim.x) {
      qs[i] = (uint32_t)qshard[(int64_t)q0 * W + i];
    }
    __syncthreads();
    if (in) {
      for (int q = 0; q < nq; ++q) {
        uint32_t acc = 0u;
#pragma unroll
        for (int w = 0; w < kMaxWords; ++w) {
          if (w < W) acc |= words[w] & qs[q * W + w];
        }
        oshard[(int64_t)(q0 + q) * E + e] = (alive && acc != 0u) ? 1 : 0;
      }
    }
  }
}

}  // namespace

extern "C" int hippo_batch_filter_sharded(const int32_t* queries,
                                          const int32_t* entries,
                                          const uint8_t* live, int S, int Q,
                                          int E, int W, uint8_t* out,
                                          cudaStream_t stream) {
  if (W > kMaxWords) return (int)cudaErrorInvalidValue;
  if (S > 0 && E > 0 && Q > 0) {
    dim3 grid((E + kThreads - 1) / kThreads, S);
    batch_filter_sharded_kernel<<<grid, kThreads, 0, stream>>>(
        queries, entries, live, Q, E, W, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int hippo_batch_filter(const int32_t* queries,
                                  const int32_t* entries, const uint8_t* live,
                                  int Q, int E, int W, uint8_t* out,
                                  cudaStream_t stream) {
  return hippo_batch_filter_sharded(queries, entries, live, 1, Q, E, W, out,
                                    stream);
}

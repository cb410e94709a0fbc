// Fused filter-match x interval inspection of the gathered page slab, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `compact_inspect_kernel`
// (src/repro/kernels/compact_inspect/kernel.py:39, pallas_call at :49):
//   counts[s, q, m] = sum_c sel_mask[s, q, m] && valid[s, p, c]
//                           && lo[q] <= keys[s, p, c] <= hi[q],
//   p = sel[s, m], and 0 where p is a pad (p >= P).
// Two changes of contract against the TPU kernel: a shard axis, and the slab
// is never materialized. The kernel reads each selected page straight from
// the (S, P, C) table slabs through the selection index `sel` (S, M), so the
// main path makes no (S, M, C) copy of the table; and C is ragged (the page
// cardinality, 50), where the TPU padded every page to 128 lanes with +inf
// keys (src/repro/kernels/compact_inspect/ops.py:46-58).
//
// What bounds it on the H100: at the main path's shapes, bytes. Each selected
// page is read once (C * 5 B), sel and sel_mask once, and the (S, Q, M) int32
// counts written once. At SF10 with the slab at its never-truncating width
// (S=4, M=375 K, C=50, Q=64) that is ~300 MB of pages (pad selections read
// nothing), ~96 MB of masks and ~384 MB of counts, ~0.23 ms at the H100
// SXM's published 3.35 TB/s (700 W); the compares (~3 per tuple per selected
// (q, m) pair) are the other bound and are counted from the data.
//
// Design: one block of 8 warps per (tile of 32 slab pages, shard). The
// tile's keys and valid bytes are staged in shared memory once and reused by
// every query of the batch; the intervals sit in shared memory too. One warp
// takes one (query, page) pair at a time: lanes cover the page's C slots in
// rounds of 32 (the ragged edge masked), and `__ballot_sync` + `__popc`
// reduce the round. Pairs whose sel_mask is 0 skip the compares (the branch
// is uniform across the warp).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kTilePages = 32;  // slab pages staged per block

__host__ __device__ inline size_t interval_offset(int C) {
  return ((size_t)kTilePages * C * 5 + 15) & ~(size_t)15;
}

__global__ void compact_inspect_kernel(
    const float* __restrict__ keys, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ sel, const uint8_t* __restrict__ sel_mask,
    const float* __restrict__ los, const float* __restrict__ his, int P,
    int C, int M, int Q, int32_t* __restrict__ counts) {
  extern __shared__ unsigned char smem[];
  float* tk = reinterpret_cast<float*>(smem);
  uint8_t* tv = smem + (size_t)kTilePages * C * sizeof(float);
  float* slo = reinterpret_cast<float*>(smem + interval_offset(C));
  float* shi = slo + Q;
  const int s = blockIdx.y;
  const int m0 = blockIdx.x * kTilePages;
  const int nm = min(kTilePages, M - m0);
  for (int i = threadIdx.x; i < nm * C; i += blockDim.x) {
    const int m = i / C;
    const int c = i - m * C;
    const int page = sel[(int64_t)s * M + m0 + m];
    float k = 0.f;
    uint8_t v = 0;
    if (page >= 0 && page < P) {
      const int64_t off = ((int64_t)s * P + page) * C + c;
      k = keys[off];
      v = valid[off];
    }
    tk[i] = k;
    tv[i] = v;
  }
  for (int i = threadIdx.x; i < Q; i += blockDim.x) {
    slo[i] = los[i];
    shi[i] = his[i];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int pair = warp; pair < Q * nm; pair += nwarps) {
    const int q = pair / nm;
    const int m = pair - q * nm;
    const int64_t o = ((int64_t)s * Q + q) * M + m0 + m;
    int cnt = 0;
    if (sel_mask[o]) {
      const float lo = slo[q];
      const float hi = shi[q];
      for (int c0 = 0; c0 < C; c0 += 32) {
        const int c = c0 + lane;
        bool hit = false;
        if (c < C) {
          const float k = tk[m * C + c];
          hit = tv[m * C + c] != 0 && k >= lo && k <= hi;
        }
        cnt += __popc(__ballot_sync(0xffffffffu, hit));
      }
    }
    if (lane == 0) counts[o] = cnt;
  }
}

}  // namespace

extern "C" int hippo_compact_inspect(const float* keys, const uint8_t* valid,
                                     const int32_t* sel,
                                     const uint8_t* sel_mask,
                                     const float* los, const float* his,
                                     int S, int P, int C, int M, int Q,
                                     int32_t* counts, cudaStream_t stream) {
  const size_t smem = interval_offset(C) + (size_t)Q * 2 * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (S > 0 && M > 0 && Q > 0) {
    dim3 grid((M + kTilePages - 1) / kTilePages, S);
    compact_inspect_kernel<<<grid, kThreads, smem, stream>>>(
        keys, valid, sel, sel_mask, los, his, P, C, M, Q, counts);
  }
  return (int)cudaGetLastError();
}

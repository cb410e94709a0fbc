// Exact inspection of the possible qualified pages (paper section 3.3,
// Algorithm 1 step 3) for Hopper (sm_90a).
//
// Replaces the TPU kernel `page_inspect_kernel`
// (src/repro/kernels/page_inspect/kernel.py:35, pallas_call at :42):
//   qual[p, c] = mask[p] && valid[p, c] && lo <= keys[p, c] <= hi,
//   counts[p]  = sum_c qual[p, c]
// Two entry points.
//
// `hippo_page_inspect` keeps the TPU contract (one interval, the (P, C)
// tuple mask and per-page counts): step 3 of the single-query `search`
// (src/repro/core/index.py:233-234). The interval is read from a (2,) f32
// device array, so the caller never synchronizes to pass it. C is ragged
// (the page cardinality, 50) where the TPU padded every page to 128 lanes
// with +inf keys and P to its block (src/repro/kernels/page_inspect/
// ops.py:42-45); here the kernel masks its own edges and pads nothing.
// Bound at SF10 (P=1,199,722, C=50): keys of the selected pages (at most
// 240 MB), valid bytes (60 MB), the qual bytes out (60 MB) and the counts,
// ~0.11 ms at the H100 SXM's published 3.35 TB/s (700 W) when every page is
// selected. Design: one block per tile of 64 pages; threads walk the tile's
// P*C tuples in storage order (coalesced key, valid and qual accesses),
// pages whose mask is 0 skip the key and valid reads, and per-page counts
// gather in shared memory before one store per page.
//
// `hippo_page_inspect_many` is the same test with a query and a shard axis:
//   counts[s, q] = sum_{p, c} page_mask[s, q, p] && valid[s, p, c]
//                  && los[q] <= keys[s, p, c] <= his[q]
// It serves `search_many` and `search_many_sharded`
// (src/repro/core/index.py:265-269), whose reference materializes the
// (Q, P, C) tuple mask (3.84 GB at SF10, Q=64) only to sum it. Bound: the
// tuples are read once (keys 4 B + valid 1 B each), the page masks once
// (S*Q*P bytes) and the counts written once; at SF10 with Q=64 that is
// ~377 MB, ~0.11 ms; the compares (3 per tuple per active (query, page)
// pair) are the other bound and are counted from the data. Design: blocks
// grid-stride over tiles of 2048 tuples of their shard; each thread holds 8
// tuples in registers (read once, coalesced) and tests them against every
// query, whose interval sits in shared memory. The interval compares come
// first, so a tuple outside a narrow interval never reads the page mask.
// Per-query counts reduce in the warp (`__reduce_add_sync`), then in shared
// memory, then one integer `atomicAdd` per (block, query) into the output:
// integer sums do not depend on their order, so the result is exact and
// the same on every run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTilePages = 64;    // pages per block (single query)
constexpr int kPerThread = 8;     // tuples per thread per tile (batched)
constexpr int kTile = kThreads * kPerThread;
constexpr int kMaxQueries = 4096; // 12 B per query of shared memory
constexpr int kResidentBlocks = 132 * 8;

__global__ void page_inspect_kernel(const float* __restrict__ keys,
                                    const uint8_t* __restrict__ valid,
                                    const uint8_t* __restrict__ mask,
                                    const float* __restrict__ interval, int P,
                                    int C, uint8_t* __restrict__ qual,
                                    int32_t* __restrict__ counts) {
  __shared__ int cnt[kTilePages];
  const int p0 = blockIdx.x * kTilePages;
  const int np = min(kTilePages, P - p0);
  if (threadIdx.x < kTilePages) cnt[threadIdx.x] = 0;
  __syncthreads();
  const float lo = interval[0];
  const float hi = interval[1];
  const int64_t base = (int64_t)p0 * C;
  const int n = np * C;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int p = i / C;
    uint8_t hit = 0;
    if (mask[p0 + p] != 0 && valid[base + i] != 0) {
      const float k = keys[base + i];
      hit = (k >= lo && k <= hi) ? 1 : 0;
    }
    qual[base + i] = hit;
    if (hit) atomicAdd(&cnt[p], 1);
  }
  __syncthreads();
  if (threadIdx.x < np) counts[p0 + threadIdx.x] = cnt[threadIdx.x];
}

__global__ void page_inspect_many_kernel(
    const float* __restrict__ keys, const uint8_t* __restrict__ valid,
    const uint8_t* __restrict__ page_mask, const float* __restrict__ los,
    const float* __restrict__ his, int P, int C, int Q, int tiles,
    int32_t* __restrict__ counts) {
  extern __shared__ unsigned char smem[];
  float* slo = reinterpret_cast<float*>(smem);
  float* shi = slo + Q;
  int* scnt = reinterpret_cast<int*>(shi + Q);
  const int s = blockIdx.y;
  for (int i = threadIdx.x; i < Q; i += kThreads) {
    slo[i] = los[i];
    shi[i] = his[i];
    scnt[i] = 0;
  }
  __syncthreads();
  const int n = P * C;   // the wrapper keeps one shard's tuples below 2^31
  const float* ks = keys + (int64_t)s * n;
  const uint8_t* vs = valid + (int64_t)s * n;
  const uint8_t* ms = page_mask + (int64_t)s * Q * P;
  const int lane = threadIdx.x & 31;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    // A tuple past the edge or invalid holds a NaN key, which no interval
    // contains, so the query loop needs no validity branch (a NaN key in
    // the table compares false in the reference too).
    float k[kPerThread];
    int page[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int i = t * kTile + j * kThreads + threadIdx.x;
      k[j] = __int_as_float(0x7fc00000);
      page[j] = 0;
      if (i < n && vs[i] != 0) {
        k[j] = ks[i];
        page[j] = i / C;
      }
    }
    for (int q = 0; q < Q; ++q) {
      const float lo = slo[q];
      const float hi = shi[q];
      const uint8_t* mq = ms + (int64_t)q * P;
      int c = 0;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        if (k[j] >= lo && k[j] <= hi) c += mq[page[j]];   // mask bytes: 0/1
      }
      c = __reduce_add_sync(0xffffffffu, c);
      if (lane == 0 && c != 0) atomicAdd(&scnt[q], c);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Q; i += kThreads) {
    if (scnt[i] != 0) atomicAdd(&counts[(int64_t)s * Q + i], scnt[i]);
  }
}

}  // namespace

extern "C" int hippo_page_inspect(const float* keys, const uint8_t* valid,
                                  const uint8_t* mask, const float* interval,
                                  int P, int C, uint8_t* qual, int32_t* counts,
                                  cudaStream_t stream) {
  if (P > 0 && C > 0) {
    page_inspect_kernel<<<(P + kTilePages - 1) / kTilePages, kThreads, 0,
                          stream>>>(keys, valid, mask, interval, P, C, qual,
                                    counts);
  }
  return (int)cudaGetLastError();
}

// counts (S, Q) must be zeroed by the caller: blocks add into it.
extern "C" int hippo_page_inspect_many(const float* keys, const uint8_t* valid,
                                       const uint8_t* page_mask,
                                       const float* los, const float* his,
                                       int S, int P, int C, int Q,
                                       int32_t* counts, cudaStream_t stream) {
  if (Q > kMaxQueries || (int64_t)P * C > 0x7fffffffLL - kTile ||
      S > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (S > 0 && P > 0 && C > 0 && Q > 0) {
    const int tiles = (int)(((int64_t)P * C + kTile - 1) / kTile);
    const int per_shard = max(1, min(tiles, kResidentBlocks / S));
    const size_t smem = (size_t)Q * 3 * sizeof(float);
    dim3 grid(per_shard, S);
    page_inspect_many_kernel<<<grid, kThreads, smem, stream>>>(
        keys, valid, page_mask, los, his, P, C, Q, tiles, counts);
  }
  return (int)cudaGetLastError();
}

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
// ~377 MB, ~0.11 ms. Design: kernel B's (page_count.cuh). A persistent grid,
// (blocks per shard, S), sorts the batch's endpoints once per block and walks
// tiles of T = 32 contiguous pages of its shard: it loads the tile's page-mask
// bytes and the next tile's tuples (a warp reads 128 contiguous bytes of
// keys), ranks the tile's tuples, loaded during the previous tile, against
// the sorted endpoints and adds them to the tile's rank histograms; after the
// suffix sums, each (query, page) pair of the tile is its page-mask byte
// times two shared-memory lookups. A thread meets the same (query,
// page-in-tile) pairs in every tile, so it sums them in registers across its
// tiles; at the end the T lanes of each query reduce with shuffles and add
// with one integer `atomicAdd` per (block, query) into the output: integer
// sums do not depend on their order, so the result is exact and the same on
// every run.
#include <cuda_runtime.h>
#include <stdint.h>

#include "page_count.cuh"

namespace {

using namespace hippo_pc;

constexpr int kTilePages = 64;    // pages per block (single query)

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

template <int kSteps, bool kPacked>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    page_inspect_many_kernel(const float* __restrict__ keys,
                             const uint8_t* __restrict__ valid,
                             const uint8_t* __restrict__ page_mask,
                             const float* __restrict__ los,
                             const float* __restrict__ his, int P, int C,
                             int Q, int log_tile, int tiles,
                             int32_t* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int n2 = 1 << kSteps;
  float* eyt = reinterpret_cast<float*>(smem);
  int* plo = reinterpret_cast<int*>(eyt + n2);
  int* phi = plo + Q;
  float* srt = reinterpret_cast<float*>(phi + Q);
  int* buckets = reinterpret_cast<int*>(srt + 2 * Q);
  float* span = reinterpret_cast<float*>(buckets + kBuckets);
  int* hist = reinterpret_cast<int*>(span + 4);
  const int T = 1 << log_tile;
  const int stride = hist_stride(Q, kPacked);
  sort_endpoints(los, his, Q, kSteps, eyt, srt, plo, phi,
                 reinterpret_cast<float*>(buckets));
  const Ranks ranks = make_ranks(eyt, srt, buckets, span, Q);
  int cells[kPairsPerThread];
  pair_cells(plo, phi, Q, log_tile, cells);
  const int s = blockIdx.y;
  const int G = gridDim.x;
  const int tid = threadIdx.x;
  const float* keys_s = keys + (int64_t)s * P * C;
  const uint8_t* valid_s = valid + (int64_t)s * P * C;
  const uint8_t* mask_s = page_mask + (int64_t)s * Q * P;
  auto tile_pages = [&](int t) { return min(T, P - (t << log_tile)); };
  // Loads slot c of page m of the tile that starts at page p0.
  auto from = [=](int p0) {
    return [=](int m, int c, float& k, uint8_t& v) {
      const int64_t off = (int64_t)(p0 + m) * C + c;
      k = keys_s[off];
      v = valid_s[off];
    };
  };
  // Pair j = q * T + m of every tile: this thread's are j = tid + i *
  // kThreads, the same in every tile, so their sums stay in registers.
  int acc[kPairsPerThread];
#pragma unroll
  for (int i = 0; i < kPairsPerThread; ++i) acc[i] = 0;
  int t = blockIdx.x;
  Round cur;
  load_round(cur, 0, tile_pages(t), C, from(t << log_tile));
  for (; t < tiles; t += G) {
    const int p0 = t << log_tile;
    const int nm = tile_pages(t);
    const int tn = t + G;
    __syncthreads();   // the histograms are free
    uint8_t hit[kPairsPerThread];
#pragma unroll
    for (int i = 0; i < kPairsPerThread; ++i) {
      const int j = tid + i * kThreads;
      const int q = j >> log_tile;
      const int m = j & (T - 1);
      hit[i] = q < Q && m < nm ? mask_s[(int64_t)q * P + p0 + m] : 0;
    }
    Round next = {};
    if (tn < tiles) {
      load_round(next, 0, tile_pages(tn), C, from(tn << log_tile));
    }
    clear_hist(hist, T, stride);
    __syncthreads();
    add_round<kSteps, kPacked>(cur, 0, nm, C, ranks, hist, stride);
    for (int r = 1; r * kRoundTuples < nm * C; ++r) {   // pages > 2048 slots
      Round more;
      load_round(more, r, nm, C, from(p0));
      add_round<kSteps, kPacked>(more, r, nm, C, ranks, hist, stride);
    }
    __syncthreads();
    suffix_sums<kPacked>(hist, T, stride, Q);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPairsPerThread; ++i) {
      const int m = (tid + i * kThreads) & (T - 1);
      if (hit[i]) {
        acc[i] += cell_at<kPacked>(hist, stride, m, cells[i] & 0xffff) -
                  cell_at<kPacked>(hist, stride, m, cells[i] >> 16);
      }
    }
    cur = next;
  }
  // The T lanes of one query are T aligned lanes of one warp (T <= 32).
#pragma unroll
  for (int i = 0; i < kPairsPerThread; ++i) {
    int v = acc[i];
    for (int o = T >> 1; o > 0; o >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, o, T);
    }
    const int j = tid + i * kThreads;
    const int q = j >> log_tile;
    if ((j & (T - 1)) == 0 && q < Q && v != 0) {
      atomicAdd(&counts[(int64_t)s * Q + q], v);
    }
  }
}

template <int kSteps, bool kPacked>
cudaError_t launch_many(const float* keys, const uint8_t* valid,
                        const uint8_t* page_mask, const float* los,
                        const float* his, int S, int P, int C, int Q,
                        int32_t* counts, cudaStream_t stream) {
  const size_t smem = shared_bytes(Q, C);
  const int lg = tile_log(Q, C);
  const int tiles = (P + (1 << lg) - 1) >> lg;
  int per_shard = 1;
  const cudaError_t err = persistent_blocks(
      page_inspect_many_kernel<kSteps, kPacked>, smem, tiles, S, &per_shard);
  if (err != cudaSuccess) return err;
  page_inspect_many_kernel<kSteps, kPacked>
      <<<dim3(per_shard, S), kThreads, smem, stream>>>(
          keys, valid, page_mask, los, his, P, C, Q, lg, tiles, counts);
  return cudaGetLastError();
}

template <int kSteps>
cudaError_t launch_many(const float* keys, const uint8_t* valid,
                        const uint8_t* page_mask, const float* los,
                        const float* his, int S, int P, int C, int Q,
                        int32_t* counts, cudaStream_t stream) {
  return packed_counts(C)
             ? launch_many<kSteps, true>(keys, valid, page_mask, los, his, S,
                                         P, C, Q, counts, stream)
             : launch_many<kSteps, false>(keys, valid, page_mask, los, his,
                                          S, P, C, Q, counts, stream);
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
  if (Q > kMaxQueries || S > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (S <= 0 || P <= 0 || C <= 0 || Q <= 0) return (int)cudaGetLastError();
  cudaError_t err;
  switch (search_steps(Q)) {
    case 4:
      err = launch_many<4>(keys, valid, page_mask, los, his, S, P, C, Q,
                           counts, stream);
      break;
    case 8:
      err = launch_many<8>(keys, valid, page_mask, los, his, S, P, C, Q,
                           counts, stream);
      break;
    case 10:
      err = launch_many<10>(keys, valid, page_mask, los, his, S, P, C, Q,
                           counts, stream);
      break;
    default:
      err = launch_many<12>(keys, valid, page_mask, los, his, S, P, C, Q,
                            counts, stream);
  }
  return (int)err;
}

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
// What bounds it on the H100: bytes. Each selected page is read once (C * 5
// B), sel and sel_mask once, and the (S, Q, M) int32 counts written once. At
// SF10 with the slab at its never-truncating width (S=4, M=375 K, C=50,
// Q=64) that is ~300 MB of pages, ~96 MB of masks and ~384 MB of counts,
// ~0.23 ms at the H100 SXM's published 3.35 TB/s (700 W).
//
// Design (page_count.cuh): the count of a (query, page) pair comes from the
// ranks of the page's tuples against the batch's sorted endpoints, so the
// work per page is ~50 tuple ranks plus one lookup pair per query, not Q
// compares per tuple. A persistent grid of blocks, (blocks per
// shard, S), each sorts the endpoints once and then walks tiles of T = 32
// slab pages of its shard:
//   1. it loads the tile's sel_mask bytes and the next tile's tuples
//      (gathered through `sel`, whose entries it read a tile earlier), and
//      the page numbers of the tile after that;
//   2. it ranks the tile's tuples, loaded during the previous tile, adds
//      them to the tile's page histograms and takes their suffix sums;
//   3. threads walk the tile's (query, page) pairs with consecutive pages of
//      one query in consecutive lanes, so the sel_mask loads and the int32
//      count stores are coalesced, and write every pair's count.
#include <cuda_runtime.h>
#include <stdint.h>

#include "page_count.cuh"

namespace {

using namespace hippo_pc;

template <int kSteps, bool kPacked>
__global__ void __launch_bounds__(kThreads, kMinBlocks) compact_inspect_kernel(
    const float* __restrict__ keys, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ sel, const uint8_t* __restrict__ sel_mask,
    const float* __restrict__ los, const float* __restrict__ his, int P,
    int C, int M, int Q, int log_tile, int tiles,
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
  int* pages = hist + T * stride;
  sort_endpoints(los, his, Q, kSteps, eyt, srt, plo, phi,
                 reinterpret_cast<float*>(buckets));
  const Ranks ranks = make_ranks(eyt, srt, buckets, span, Q);
  int cells[kPairsPerThread];
  pair_cells(plo, phi, Q, log_tile, cells);
  const int s = blockIdx.y;
  const int G = gridDim.x;
  const int tid = threadIdx.x;
  const int32_t* sel_s = sel + (int64_t)s * M;
  const float* keys_s = keys + (int64_t)s * P * C;
  const uint8_t* valid_s = valid + (int64_t)s * P * C;
  auto tile_pages = [&](int t) { return min(T, M - (t << log_tile)); };
  // Entry m of tile t's page numbers; past the last tile or entry, a pad.
  auto page_of = [&](int t, int m) {
    const int e = (t << log_tile) + m;
    return t < tiles && e < M ? sel_s[e] : P;
  };
  auto load = [&](int page, int c, float& k, uint8_t& v) {
    if (page >= 0 && page < P) {   // a pad reads nothing
      const int64_t off = (int64_t)page * C + c;
      k = keys_s[off];
      v = valid_s[off];
    }
  };
  auto from_pages = [&](int m, int c, float& k, uint8_t& v) {
    load(pages[m], c, k, v);
  };
  int t = blockIdx.x;
  Round cur;
  if (tid < T) pages[tid] = page_of(t, tid);
  __syncthreads();
  load_round(cur, 0, tile_pages(t), C, from_pages);
  __syncthreads();
  if (tid < T) pages[tid] = page_of(t + G, tid);
  for (; t < tiles; t += G) {
    const int m0 = t << log_tile;
    const int nm = tile_pages(t);
    const int tn = t + G;
    __syncthreads();   // `pages` holds tile tn's; the histograms are free
    // j = q * T + m: a warp covers 32 consecutive pages of one query (T=32).
    uint8_t hit[kPairsPerThread];
#pragma unroll
    for (int i = 0; i < kPairsPerThread; ++i) {
      const int j = tid + i * kThreads;
      const int q = j >> log_tile;
      const int m = j & (T - 1);
      hit[i] = q < Q && m < nm ? sel_mask[((int64_t)s * Q + q) * M + m0 + m]
                               : 0;
    }
    Round next = {};
    if (tn < tiles) load_round(next, 0, tile_pages(tn), C, from_pages);
    const int ahead = tid < T ? page_of(tn + G, tid) : P;
    clear_hist(hist, T, stride);
    __syncthreads();
    add_round<kSteps, kPacked>(cur, 0, nm, C, ranks, hist, stride);
    for (int r = 1; r * kRoundTuples < nm * C; ++r) {   // pages > 2048 slots
      Round more;
      load_round(more, r, nm, C, [&](int m, int c, float& k, uint8_t& v) {
        load(sel_s[m0 + m], c, k, v);
      });
      add_round<kSteps, kPacked>(more, r, nm, C, ranks, hist, stride);
    }
    __syncthreads();
    suffix_sums<kPacked>(hist, T, stride, Q);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPairsPerThread; ++i) {
      const int j = tid + i * kThreads;
      const int q = j >> log_tile;
      const int m = j & (T - 1);
      if (q < Q && m < nm) {
        counts[((int64_t)s * Q + q) * M + m0 + m] =
            hit[i] ? cell_at<kPacked>(hist, stride, m, cells[i] & 0xffff) -
                         cell_at<kPacked>(hist, stride, m, cells[i] >> 16)
                   : 0;
      }
    }
    if (tid < T) pages[tid] = ahead;
    cur = next;
  }
}

template <int kSteps, bool kPacked>
cudaError_t launch(const float* keys, const uint8_t* valid, const int32_t* sel,
                   const uint8_t* sel_mask, const float* los,
                   const float* his, int S, int P, int C, int M, int Q,
                   int32_t* counts, cudaStream_t stream) {
  const size_t smem = shared_bytes(Q, C);
  const int lg = tile_log(Q, C);
  const int tiles = (M + (1 << lg) - 1) >> lg;
  int per_shard = 1;
  const cudaError_t err = persistent_blocks(
      compact_inspect_kernel<kSteps, kPacked>, smem, tiles, S, &per_shard);
  if (err != cudaSuccess) return err;
  compact_inspect_kernel<kSteps, kPacked>
      <<<dim3(per_shard, S), kThreads, smem, stream>>>(
          keys, valid, sel, sel_mask, los, his, P, C, M, Q, lg, tiles,
          counts);
  return cudaGetLastError();
}

template <int kSteps>
cudaError_t launch(const float* keys, const uint8_t* valid, const int32_t* sel,
                   const uint8_t* sel_mask, const float* los,
                   const float* his, int S, int P, int C, int M, int Q,
                   int32_t* counts, cudaStream_t stream) {
  return packed_counts(C)
             ? launch<kSteps, true>(keys, valid, sel, sel_mask, los, his, S,
                                    P, C, M, Q, counts, stream)
             : launch<kSteps, false>(keys, valid, sel, sel_mask, los, his, S,
                                     P, C, M, Q, counts, stream);
}

}  // namespace

extern "C" int hippo_compact_inspect(const float* keys, const uint8_t* valid,
                                     const int32_t* sel,
                                     const uint8_t* sel_mask,
                                     const float* los, const float* his,
                                     int S, int P, int C, int M, int Q,
                                     int32_t* counts, cudaStream_t stream) {
  if (Q > kMaxQueries || S > 65535) return (int)cudaErrorInvalidValue;
  if (S <= 0 || M <= 0 || Q <= 0) return (int)cudaGetLastError();
  if (C <= 0) {   // pages without slots: every count is 0
    return (int)cudaMemsetAsync(counts, 0, (size_t)S * Q * M * 4, stream);
  }
  cudaError_t err;
  switch (search_steps(Q)) {
    case 4:
      err = launch<4>(keys, valid, sel, sel_mask, los, his, S, P, C, M, Q,
                      counts, stream);
      break;
    case 8:
      err = launch<8>(keys, valid, sel, sel_mask, los, his, S, P, C, M, Q,
                      counts, stream);
      break;
    case 10:
      err = launch<10>(keys, valid, sel, sel_mask, los, his, S, P, C, M, Q,
                      counts, stream);
      break;
    default:
      err = launch<12>(keys, valid, sel, sel_mask, los, his, S, P, C, M, Q,
                       counts, stream);
  }
  return (int)err;
}

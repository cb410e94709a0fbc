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
// Bound: bytes. At SF10 (P=1,199,722, C=50, a 100-day query selecting
// 1,178,688 pages) the keys of the selected pages (236 MB), the valid bytes
// (60 MB), the qual bytes out (60 MB), the page mask and the counts: 0.108 ms
// at the H100 SXM's published 3.35 TB/s (700 W). The first design of this
// entry point walked one tuple per thread and paid four load/store
// instructions a tuple, three of them 1 byte a lane, an integer division and
// a shared atomic per hit: 0.329 ms. This one takes 0.125 ms, 1.16x the
// bound and less than the card's own read of the keys and the valid bytes
// plus a fill of qual (0.141 ms) (`python3 chip_smoke.py --baseline-csrc`,
// NVIDIA H100 80GB HBM3, power limit 700.00 W).
// Design: one block per tile of 64 pages (64 * C tuples, so a tile starts on
// a 16-tuple boundary for any C); a thread takes a run of 16 consecutive
// tuples. Where the three bases are 16 B aligned, a run is one 16 B load of
// valid, at most four 16 B loads of keys (a quad of tuples none of whose
// pages is selected is not read) and one 16 B store of qual; the tuple bits
// (selected, valid, in the interval) ride in 16-bit masks and turn into
// bytes by multiplication. A run's first page is one division; the run then
// steps page by page (at most two pages for C >= 16), reading one mask byte
// and adding at most one shared atomic (the popcount of its hits) per (run,
// page). A misaligned base (a slice of a larger tensor) or a tile's partial
// last run takes the same run with one access a tuple.
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
constexpr int kRun = 16;          // consecutive tuples a thread takes

// One bit per byte of w that is not 0, in byte order: the four 0/1 flags at
// bits 0, 8, 16 and 24, times 2^7 + 2^14 + 2^21 + 2^28, land on bits 28-31
// and nowhere else between them.
__device__ __forceinline__ unsigned nonzero_bits(unsigned w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x10204080u) >> 28;
}

// The inverse: four bits to four 0/1 bytes (bit i times 2^(7i) lands on bit
// 8i; no two products overlap).
__device__ __forceinline__ unsigned bit_bytes(unsigned nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

__device__ __forceinline__ unsigned in_interval(float k, float lo, float hi,
                                                int j) {
  return (k >= lo && k <= hi) ? 1u << j : 0u;
}

// Run of 16 tuples at 16 B aligned addresses: the hit bits of `sel` tuples.
__device__ __forceinline__ unsigned run_wide(const float* keys,
                                             const uint8_t* valid,
                                             uint8_t* qual, unsigned sel,
                                             float lo, float hi) {
  const uint4 v = *reinterpret_cast<const uint4*>(valid);
  float4 k[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    k[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    if ((sel >> (4 * q)) & 0xfu) {
      k[q] = *reinterpret_cast<const float4*>(keys + 4 * q);
    }
  }
  const unsigned vb = nonzero_bits(v.x) | nonzero_bits(v.y) << 4 |
                      nonzero_bits(v.z) << 8 | nonzero_bits(v.w) << 12;
  unsigned kb = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    kb |= in_interval(k[q].x, lo, hi, 4 * q) |
          in_interval(k[q].y, lo, hi, 4 * q + 1) |
          in_interval(k[q].z, lo, hi, 4 * q + 2) |
          in_interval(k[q].w, lo, hi, 4 * q + 3);
  }
  const unsigned hit = sel & vb & kb;
  *reinterpret_cast<uint4*>(qual) =
      make_uint4(bit_bytes(hit & 0xfu), bit_bytes((hit >> 4) & 0xfu),
                 bit_bytes((hit >> 8) & 0xfu), bit_bytes(hit >> 12));
  return hit;
}

// The same run, len <= 16 tuples at any address, one access a tuple.
__device__ __forceinline__ unsigned run_narrow(const float* keys,
                                               const uint8_t* valid,
                                               uint8_t* qual, int len,
                                               unsigned sel, float lo,
                                               float hi) {
  unsigned hit = 0;
  for (int j = 0; j < len; ++j) {
    if (((sel >> j) & 1u) && valid[j] != 0) hit |= in_interval(keys[j], lo,
                                                               hi, j);
  }
  for (int j = 0; j < len; ++j) qual[j] = (hit >> j) & 1u;
  return hit;
}

// kWide: keys, valid and qual all start on 16 B boundaries.
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
    page_inspect_kernel(const float* __restrict__ keys,
                        const uint8_t* __restrict__ valid,
                        const uint8_t* __restrict__ mask,
                        const float* __restrict__ interval, int P, int C,
                        uint8_t* __restrict__ qual,
                        int32_t* __restrict__ counts) {
  __shared__ int cnt[kTilePages];
  const int p0 = blockIdx.x * kTilePages;
  const int np = min(kTilePages, P - p0);
  for (int i = threadIdx.x; i < np; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  const float lo = interval[0];
  const float hi = interval[1];
  const int64_t base = (int64_t)p0 * C;
  const float* kt = keys + base;
  const uint8_t* vt = valid + base;
  uint8_t* qt = qual + base;
  const uint8_t* mt = mask + p0;
  const int n = np * C;
  for (int first = threadIdx.x * kRun; first < n;
       first += blockDim.x * kRun) {
    const int len = min(kRun, n - first);
    const int pf = first / C;            // the run's first page, once a run
    const int cf = first - pf * C;
    // The run's tuples on selected pages: one mask byte per page it touches.
    unsigned sel = 0;
    for (int j = 0, p = pf, c = cf; j < len; ++p, c = 0) {
      const int seg = min(C - c, len - j);
      if (__ldg(mt + p)) sel |= ((1u << seg) - 1u) << j;
      j += seg;
    }
    const unsigned hit =
        kWide && len == kRun
            ? run_wide(kt + first, vt + first, qt + first, sel, lo, hi)
            : run_narrow(kt + first, vt + first, qt + first, len, sel, lo,
                         hi);
    for (int j = 0, p = pf, c = cf; j < len; ++p, c = 0) {
      const int seg = min(C - c, len - j);
      const int k = __popc(hit & (((1u << seg) - 1u) << j));
      if (k) atomicAdd(&cnt[p], k);
      j += seg;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < np; i += blockDim.x) counts[p0 + i] = cnt[i];
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
    // A tile's 4C runs, in whole warps, at most kThreads a block.
    const int runs = (4 * C + 31) / 32 * 32;
    const int threads = runs < kThreads ? runs : kThreads;
    const unsigned blocks = (P + kTilePages - 1) / kTilePages;
    const bool wide = ((reinterpret_cast<uintptr_t>(keys) |
                        reinterpret_cast<uintptr_t>(valid) |
                        reinterpret_cast<uintptr_t>(qual)) & 15) == 0;
    if (wide) {
      page_inspect_kernel<true><<<blocks, threads, 0, stream>>>(
          keys, valid, mask, interval, P, C, qual, counts);
    } else {
      page_inspect_kernel<false><<<blocks, threads, 0, stream>>>(
          keys, valid, mask, interval, P, C, qual, counts);
    }
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

// Per-(query, page) interval counts from the ranks of the tuples against the
// batch's sorted interval endpoints, for Hopper (sm_90a). Shared by
// compact_inspect.cu (kernel B) and page_inspect.cu (batched kernel E), which
// compute the same thing: for each (query, page) pair, the page's valid
// tuples with lo <= key <= hi.
//
// Testing every tuple against every query costs Q compares per tuple. This
// design uses exact integer arithmetic instead:
//
//   count(q, page) = lo_q <= hi_q ? #{c : k_c >= lo_q} - #{c : k_c > hi_q}
//                                 : 0
//
// which holds because k > hi >= lo implies k >= lo. Both terms are counts of
// one kind, #{c : e <= k_c}: e = lo_q for the first, and for the second e =
// next_up(hi_q), the next float above hi_q, since hi < k iff next_up(hi) <= k
// (hi = +inf, which no key exceeds, takes a NaN: never <= k). So the batch's
// 2Q endpoints go into one sorted array E, and with rank(k) = #{j : E_j <= k}
// and pos(e) = #{j : E_j < e} (the first of e's ties), e <= k iff pos(e) <
// rank(k). Each tuple costs one rank (below) and adds 1 to its page's rank
// histogram; a suffix sum over the histogram then gives both terms of every
// query, and a (query, page) pair costs two shared-memory lookups and a
// subtraction.
//
// Edges: an invalid tuple and a pad page add nothing; a NaN key has rank 0,
// so it counts in neither term (as it matches no interval in the plain
// version). -0.0 and +0.0 compare equal and sort as ties (next_up of either
// is the least denormal). +-inf keys and endpoints compare as floats. An
// empty interval (lo > hi, or a NaN endpoint) reads cell 2Q+1, which is
// always 0. NaN endpoints are sorted as +inf, so the order stays total;
// their own query reads the zero cell, and the others' counts only need a
// consistent order.
//
// A tuple's rank comes from a table of kBuckets buckets over the finite
// endpoints' span: b(k) = clamp(floor((k - base) * scale)), the same float
// arithmetic for keys and endpoints, is monotone in k, so rank(k) = (the
// endpoints in buckets below b(k)) + (those in bucket b(k) that are <= k),
// exactly. With the batch's 2Q endpoints over 2048 buckets a bucket holds 0
// or 1 of them in the common case, so a tuple costs one table load and at
// most a few compares; a NaN key lands in bucket 0 and compares false, rank
// 0. A bucket of more than kLinear endpoints (clustered endpoints, or a span
// that is 0 or not finite, where every endpoint shares bucket 0) is searched
// in the tree below instead.
//
// That tree stores the sorted endpoints in Eytzinger (breadth-first) order:
// node i has children 2i and 2i+1, and a search reads one node per level. A
// level's nodes are contiguous, so the 32 lanes of a warp, each searching its
// own key, read at most 4 addresses per bank at Q = 64 (the 128-node level)
// and at most 2 on the levels above it; in sorted order the later steps of a
// plain binary search read with up to 8-way bank conflicts.
//
// The next tile's tuples are loaded into registers while the current tile's
// are ranked, and a tile's mask bytes before its tuples, so a block never
// waits a whole trip to device memory at the start of a stage; kernel B
// reads the page numbers two tiles ahead. What bounds the kernels then is
// the count of instructions through the load/store pipe (shared-memory
// accesses, atomics, shuffles and device loads), spread over the stages, so
// the design keeps that count down: a page's counts never exceed its C
// slots, so for C <= 255 a histogram cell is one byte, four to a word
// (stride 33 words at Q = 64 instead of 131); the suffix sums keep each
// thread's run of words in registers between their two passes; each
// thread reads its queries' suffix cells once, not once a tile; the
// histograms are cleared with 16 B stores. A stage of the tuples and mask
// bytes through shared memory with cp.async, instead of registers, was no
// faster, nor were blocks of 512 threads: latency and occupancy are not
// what limits. TMA is not used: B's pages of C * 4 B sit at any 4 B
// boundary, not the 16 B a bulk copy needs, and for E's contiguous tiles it
// would only save the load instructions, a small part of the issue.
//
// Shared memory of one block (4-byte cells), in this order:
//   eyt        [n2]           the 2Q endpoints in Eytzinger order, node 0
//                             unused, NaN where no endpoint falls
//   plo, phi   [Q]            per query, the suffix cells of its two terms
//   srt        [2Q]           the endpoints in sorted order (NaN last)
//   buckets    [kBuckets]     per bucket, the sorted position of its first
//                             endpoint | its endpoint count << 16 (scratch
//                             for the sort before that)
//   span       [4]            base, top (finite endpoints) and the count of
//                             non-NaN endpoints (4 cells: hist is 16 B
//                             aligned)
//   hist       [T][stride]    rank histograms of the tile's T pages, 2Q + 2
//                             cells a row (hist_stride); the odd stride puts
//                             the rows of consecutive pages in distinct banks
//                             both when a warp adds the tuples of one page
//                             (distinct ranks) and when it reads one query's
//                             cell of 32 pages
//   pages      [T]            kernel B: the page numbers of the next tile
// n2 = 2^kSteps >= 2Q + 1, so a complete tree of n2 - 1 nodes holds every
// endpoint and at least one NaN pad follows the last.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hippo_pc {

constexpr int kThreads = 256;
constexpr int kMaxQueries = 1024;        // one launch; the wrappers split more
constexpr int kTilePairs = 2048;         // Q * T <= kTilePairs
constexpr int kPairsPerThread = kTilePairs / kThreads;
constexpr int kPerThread = 8;            // tuples per thread per round
constexpr int kRoundTuples = kThreads * kPerThread;
constexpr int kMinBlocks = 3;            // resident blocks per SM (registers)
constexpr int kBuckets = 2048;           // buckets of the rank table
constexpr int kLinear = 8;               // endpoints a bucket compares in turn

// Words of one page's histogram row: 2Q + 2 cells of 32 bits, or of 8 bits
// four to a word where a page holds at most 255 slots (no cell or suffix sum
// can exceed the page's count). Odd, so the rows of consecutive pages fall
// in distinct banks.
__host__ __device__ inline int hist_stride(int Q, bool packed) {
  return (packed ? (2 * Q + 2 + 3) / 4 : 2 * Q + 2) | 1;
}
inline bool packed_counts(int C) { return C <= 255; }

// Binary-search steps for Q queries: n2 = 2^steps >= 2Q + 1, in four sizes
// so that four instantiations cover every Q up to kMaxQueries.
inline int search_steps(int Q) {
  return Q < 8 ? 4 : Q < 128 ? 8 : Q < 512 ? 10 : 12;
}

// log2 of the pages per tile: the largest power of two T <= 32 with Q * T <=
// kTilePairs (at most kPairsPerThread pairs per thread) and, where pages
// hold at most kRoundTuples tuples, T * C <= kRoundTuples (one round of
// tuple loads per tile). Larger pages take one page per tile and several
// rounds.
inline int tile_log(int Q, int C) {
  int lg = 5;
  while (lg > 0 && ((Q << lg) > kTilePairs || (C << lg) > kRoundTuples)) {
    --lg;
  }
  return lg;
}

inline size_t shared_bytes(int Q, int C) {
  const int T = 1 << tile_log(Q, C);
  return ((size_t)(1 << search_steps(Q)) + 2 * Q + kBuckets + 4 + 2 * Q
          + (size_t)T * hist_stride(Q, packed_counts(C)) + T) * 4;
}

__device__ __forceinline__ float nan_key() {
  return __int_as_float(0x7fc00000);
}

// The next float above v (v neither NaN nor +inf), from its bits: -0.0 and
// +0.0 both go to the least denormal.
__device__ __forceinline__ float next_up(float v) {
  const int b = __float_as_int(v);
  if (b == (int)0x80000000) return __int_as_float(1);
  return __int_as_float(b >= 0 ? b + 1 : b - 1);
}

// NaN sorts last, as one value: a total order on the stored endpoints.
__device__ __forceinline__ bool before(float u, float v) {
  return u < v || (v != v && u == u);
}
__device__ __forceinline__ bool same(float u, float v) {
  return u == v || (u != u && v != v);
}

// The Eytzinger node of sorted position p in a complete tree of 2^steps - 1
// nodes (1-based): the in-order position's trailing zeros give its depth.
__device__ __forceinline__ int eytzinger_node(int p, int steps) {
  const int x = p + 1;
  const int tz = __ffs(x) - 1;
  return (1 << (steps - 1 - tz)) + (x >> (tz + 1));
}

// Sorts the batch's 2Q endpoints into eyt and srt and sets plo/phi.
// `scratch` holds at least 2 * Q floats (the bucket table, before
// make_ranks fills it).
__device__ inline void sort_endpoints(const float* __restrict__ los,
                                      const float* __restrict__ his, int Q,
                                      int steps, float* eyt, float* srt,
                                      int* plo, int* phi, float* scratch) {
  const float inf = __int_as_float(0x7f800000);
  for (int i = threadIdx.x; i < 2 * Q; i += blockDim.x) {
    float v = i < Q ? los[i] : his[i - Q];
    if (v != v) v = inf;
    if (i >= Q) v = v == inf ? nan_key() : next_up(v);
    scratch[i] = v;
  }
  for (int i = threadIdx.x; i < (1 << steps); i += blockDim.x) {
    eyt[i] = nan_key();
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 2 * Q; j += blockDim.x) {
    const float v = scratch[j];
    int less = 0, tie = 0;
    for (int i = 0; i < 2 * Q; ++i) {
      const float u = scratch[i];
      less += before(u, v);
      tie += same(u, v) & (i < j);
    }
    eyt[eytzinger_node(less + tie, steps)] = v;
    srt[less + tie] = v;
    const int q = j < Q ? j : j - Q;
    const bool empty = !(los[q] <= his[q]);
    (j < Q ? plo : phi)[q] = empty ? 2 * Q + 1 : less + 1;
  }
  __syncthreads();
}

// #{j : E_j <= k} by the Eytzinger tree; 0 for a NaN key.
template <int kSteps>
__device__ __forceinline__ int tree_rank(const float* eyt, float k) {
  int a = 1;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) a = 2 * a + (eyt[a] <= k);
  return a - (1 << kSteps);
}

__device__ __forceinline__ int bucket_of(float k, float base, float scale) {
  return (int)fminf(fmaxf((k - base) * scale, 0.f), (float)(kBuckets - 1));
}

// The sorted endpoints and their bucket table, for rank().
struct Ranks {
  const float* eyt;
  const float* srt;
  const int* buckets;
  float base, scale;
};

// Builds the bucket table over srt (after sort_endpoints): the span of the
// finite endpoints, then per bucket its first sorted position and count.
// `span` holds 4 floats.
__device__ inline Ranks make_ranks(const float* eyt, const float* srt,
                                   int* buckets, float* span, int Q) {
  const int n = 2 * Q;
  if (threadIdx.x == 0) span[0] = span[1] = span[2] = 0.f;
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float v = srt[j];
    const bool fin = isfinite(v);
    if (fin && (j == 0 || !isfinite(srt[j - 1]))) span[0] = v;
    if (fin && (j == n - 1 || !isfinite(srt[j + 1]))) span[1] = v;
    if (v == v && (j == n - 1 || srt[j + 1] != srt[j + 1])) {
      span[2] = (float)(j + 1);   // endpoints before the NaN ones
    }
  }
  __syncthreads();
  const float base = span[0], top = span[1];
  const int real = (int)span[2];
  const float width = top - base;
  const float scale =
      top > base && isfinite(width) ? (float)kBuckets / width : 0.f;
  // The first sorted position in bucket >= b: buckets rise along srt.
  auto first = [&](int b) {
    int lo = 0, hi = real;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (bucket_of(srt[mid], base, scale) < b) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    return lo;
  };
  for (int b = threadIdx.x; b < kBuckets; b += blockDim.x) {
    const int start = first(b);
    buckets[b] = start | ((first(b + 1) - start) << 16);
  }
  __syncthreads();
  return Ranks{eyt, srt, buckets, base, scale};
}

// rank(k) = #{j : E_j <= k}; 0 for a NaN key.
template <int kSteps>
__device__ __forceinline__ int rank(const Ranks& R, float k) {
  const int e = R.buckets[bucket_of(k, R.base, R.scale)];
  const int start = e & 0xffff, count = e >> 16;
  if (count > kLinear) return tree_rank<kSteps>(R.eyt, k);
  int r = start;
  for (int i = 0; i < count; ++i) r += R.srt[start + i] <= k;
  return r;
}

// One round of a tile's tuples in registers: tuple i = r * kRoundTuples +
// threadIdx.x + u * kThreads of the tile (page-major), so a warp reads 32
// consecutive slots. `v` is 0 where the tuple is invalid, a pad or past the
// tile.
struct Round {
  float k[kPerThread];
  uint8_t v[kPerThread];
};

// Issues the loads of round r of a tile of nm pages of C slots:
// `fetch(m, c, k, v)` loads slot c of tile page m (or leaves v = 0). The
// registers are only read later, so the loads stay in flight meanwhile.
template <class Fetch>
__device__ __forceinline__ void load_round(Round& rd, int r, int nm, int C,
                                           Fetch fetch) {
  const int first = r * kRoundTuples + (int)threadIdx.x;
  int m = first / C, c = first - m * C;
  const int dm = kThreads / C, dc = kThreads - dm * C;
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    rd.k[u] = 0.f;
    rd.v[u] = 0;
    if (m < nm) fetch(m, c, rd.k[u], rd.v[u]);
    c += dc;
    m += dm;
    if (c >= C) {
      c -= C;
      ++m;
    }
  }
}

// Adds 1 to cell a of tile page m's histogram row.
template <bool kPacked>
__device__ __forceinline__ void count_cell(int* hist, int stride, int m,
                                           int a) {
  if (kPacked) {
    atomicAdd(reinterpret_cast<unsigned*>(hist) + m * stride + (a >> 2),
              1u << ((a & 3) * 8));
  } else {
    atomicAdd(hist + m * stride + a, 1);
  }
}

// Cell c of tile page m's histogram row.
template <bool kPacked>
__device__ __forceinline__ int cell_at(const int* hist, int stride, int m,
                                       int c) {
  return kPacked ? reinterpret_cast<const uint8_t*>(hist + m * stride)[c]
                 : hist[m * stride + c];
}

// Ranks the tuples of a loaded round and adds them to the tile's histograms.
template <int kSteps, bool kPacked>
__device__ __forceinline__ void add_round(const Round& rd, int r, int nm,
                                          int C, const Ranks& R, int* hist,
                                          int stride) {
  const int first = r * kRoundTuples + (int)threadIdx.x;
  int m = first / C, c = first - m * C;
  const int dm = kThreads / C, dc = kThreads - dm * C;
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    if (m < nm && rd.v[u]) {
      const int a = rank<kSteps>(R, rd.k[u]);
      if (a) count_cell<kPacked>(hist, stride, m, a);
    }
    c += dc;
    m += dm;
    if (c >= C) {
      c -= C;
      ++m;
    }
  }
}

// Zeroes the histograms; `hist` is 16 B aligned, so most of it goes in
// 16 B stores.
__device__ __forceinline__ void clear_hist(int* hist, int T, int stride) {
  const int n = T * stride;
  int4* h4 = reinterpret_cast<int4*>(hist);
  for (int i = threadIdx.x; i < n / 4; i += kThreads) {
    h4[i] = make_int4(0, 0, 0, 0);
  }
  for (int i = (n & ~3) + threadIdx.x; i < n; i += kThreads) hist[i] = 0;
}

// Turns each histogram row into its suffix sums: cell r becomes the sum of
// cells r..2Q (cell 2Q+1 stays 0). g = min(32, kThreads / T) threads share a
// row, each a run of words (an odd length, so the g runs start in distinct
// banks); the runs' totals combine with shuffles among the g lanes. A run of
// up to kRun words stays in registers between its two passes. In a packed
// word the suffix over its four bytes is x + (x >> 8) + (x >> 16) + (x >>
// 24), and the later words' total is added to every byte: no byte carries,
// since no sum exceeds the page's count. After it cell_at(plo[q]) -
// cell_at(phi[q]) of page m is query q's count on tile page m.
template <bool kPacked>
__device__ __forceinline__ void suffix_sums(int* hist, int T, int stride,
                                            int Q) {
  constexpr int kRun = kPacked ? 5 : 17;   // the runs at Q = 64, T = 32
  const int g = T >= kThreads / 32 ? kThreads / T : 32;
  const int row = threadIdx.x / g, part = threadIdx.x % g;
  if (row >= T) return;   // whole warps, so the shuffles below stay full
  // Packed rows scan every word (cell 0 and the pad cells ride along);
  // 32-bit rows scan cells 1..2Q.
  const int first = kPacked ? 0 : 1;
  const int words = kPacked ? (2 * Q + 2 + 3) / 4 : 2 * Q;
  const int len = ((words + g - 1) / g) | 1;
  const int lo = first + part * len;
  const int hi = min(lo + len, first + words);
  unsigned* h = reinterpret_cast<unsigned*>(hist + row * stride);
  auto suffix = [](unsigned x) {
    return kPacked ? x + (x >> 8) + (x >> 16) + (x >> 24) : x;
  };
  auto total_of = [](unsigned s) { return kPacked ? s & 0xffu : s; };
  unsigned v[kRun];
  unsigned total = 0;
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    v[i] = lo + i < hi ? suffix(h[lo + i]) : 0;
    total += total_of(v[i]);
  }
  for (int c = lo + kRun; c < hi; ++c) total += total_of(suffix(h[c]));
  unsigned after = total;   // becomes the sum over this run and later ones
  for (int o = 1; o < g; o <<= 1) {
    const unsigned x = __shfl_down_sync(0xffffffffu, after, o, g);
    if (part + o < g) after += x;
  }
  unsigned run = after - total;
  const unsigned spread = kPacked ? 0x01010101u : 1u;
  for (int c = hi - 1; c >= lo + kRun; --c) {
    const unsigned x = suffix(h[c]);
    h[c] = x + run * spread;
    run += total_of(x);
  }
#pragma unroll
  for (int i = kRun - 1; i >= 0; --i) {
    if (lo + i < hi) {
      h[lo + i] = v[i] + run * spread;
      run += total_of(v[i]);
    }
  }
}

// Per pair slot i of a thread (pair j = threadIdx.x + i * kThreads of every
// tile, query j >> log_tile), that query's two suffix cells, plo | phi << 16
// (each at most 2Q + 1 <= 2049): the same in every tile, so read once.
__device__ __forceinline__ void pair_cells(const int* plo, const int* phi,
                                           int Q, int log_tile,
                                           int (&cells)[kPairsPerThread]) {
#pragma unroll
  for (int i = 0; i < kPairsPerThread; ++i) {
    const int q = (int)(threadIdx.x + i * kThreads) >> log_tile;
    cells[i] = q < Q ? plo[q] | (phi[q] << 16) : 0;
  }
}

// Blocks per shard for a persistent grid over `tiles` tiles of each of S
// shards: as many as fit on the card at once, spread over the shards.
template <class Kernel>
inline cudaError_t persistent_blocks(Kernel kernel, size_t smem, int tiles,
                                     int S, int* per_shard) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess) {
    return err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess) {
    return err;
  }
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  int n = resident / (S > 0 ? S : 1);
  if (n > tiles) n = tiles;
  *per_shard = n > 0 ? n : 1;
  return cudaSuccess;
}

}  // namespace hippo_pc

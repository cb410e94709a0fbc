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
// The second entry point, `hippo_batch_filter`, replaces the unsharded TPU
// kernel `batch_filter_kernel` (src/repro/kernels/batch_filter/kernel.py:32,
// pallas_call at :39): out[q, e] = live[e] && any_w(queries[q, w] &
// entries[e, w]), (Q, W) x (E, W) -> (Q, E). It is this kernel at S=1. It
// carries `search_many` (the HippoIndex batch and each routed per-shard
// dispatch, whose entries are a shard's view of a stack: 4 B aligned only).
//
// What bounds it on the H100: bytes. Entry words are read once (S*E*W*4 B),
// the live bytes once, and the (S, Q, E) match bytes written once; the
// queries are a few KB. At SF10, A (S=4, E=469,685, W=13, Q=64) moves ~98 MB
// in and ~120 MB out, ~0.066 ms at the H100 SXM's published 3.35 TB/s
// (700 W); D (E=1,500,676) ~78 MB in and ~96 MB out, ~0.052 ms. The word
// tests are S*Q*E*W ~ 1.6 G AND/ORs for A: on the CUDA cores (64 integer
// lanes per SM) that alone is ~0.1 ms, above the byte bound. The earlier
// design (one thread per entry, a byte store per (query, entry), one
// shared-memory load and one AND/OR per word test) was bound by the issue
// of those instructions at ~11x the byte bound.
//
// Design: the test as a binary tensor-core product. any_w(q_w & e_w) != 0
// iff popc(q & e) > 0 over the H bits, which is what
// `mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc` computes for a
// 16-query x 8-entry tile over 256 bits (the counts never exceed 1024, so s32
// is exact). The W words are zero-padded to K = ceil(W/8) k-steps of 8 words
// (in the queries only: a pad word ANDs to 0 whatever the entry holds).
//   1. A block takes a tile of TE consecutive entries of one shard and copies
//      their TE*W contiguous words into shared memory with 4 B cp.async
//      (coalesced, and valid at any 4 B base: a shard's view of an (S, E, W)
//      stack starts at s*E*W*4 B), re-laid at a row pitch of 8K words (36 at
//      K=4) so each lane's fragment words are one 16 B load (8 B for odd K)
//      and a warp's fragment loads hit every bank once. The live bytes go
//      beside them, and the first pass's 64 query rows (zero rows past Q,
//      zero words past W) come in the same cp.async group, so a block waits
//      on device memory once before it computes.
//   2. Word order inside a k-step is free as long as both operands use the
//      same one, so lane (g, t) of a warp takes words 2Kt .. 2Kt+2K-1 of its
//      entry row: b0 of k-step k is word 2Kt+2k, b1 word 2Kt+2k+1, and the
//      query (A) fragments are read from the query rows with the same map.
//   3. Each warp holds its n8 tiles' B fragments in registers and, for each
//      16-query m-tile, issues K mma per n8 tile: 8 mma per 64 x 8 results
//      at W = 13 where the CUDA cores need 64 x 8 x 13 AND/ORs.
//   4. The epilogue ANDs `count > 0` with the live bytes and writes the 0/1
//      bytes into a (64, TE) match tile in shared memory with stmatrix
//      (sm_90): a lane's two result bytes of one n8 tile and the two of the
//      tile paired with it are one b16 x 2 register of an 8 x 8 matrix, so
//      one stmatrix.x4 writes a warp's 16 x 32 bytes of an m-tile. The entry
//      columns are permuted to make that order right: of each pair of n8
//      tiles covering 16 entries, the first takes entries 4c, 4c+1 and the
//      second 4c+2, 4c+3 (c = 0..3). The row pitch (TE + 16 B) keeps the
//      rows 16 B aligned and each 8-row store on every bank once.
//   5. Row (s, q) of the output starts at (s*Q + q)*E + e0, at any alignment
//      (E is odd at SF10), so each warp writes its rows' aligned words with
//      coalesced 4 B stores, each built from two shared words with a funnel
//      shift, and then the at most 3 + 3 bytes at the ends of 8 rows at a
//      time, four lanes a row.
// Q above 64 loops over query tiles inside the block: the entry tile is read
// from device memory once whatever Q is.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit (times of this
// design and of the earlier one in PERF.md, from chip_smoke.py). Alternatives
// were timed against this design in turns, each pair in one process, with a
// timing script not kept in the repository, so only their order is stated
// here:
//   - the CUDA-core design (4 entries a thread with their words in
//     registers, 16 B broadcast loads of each query's words, one 4 B match
//     store per query) was slower at both SF10 shapes;
//   - 2 B shared stores of each lane's result bytes in place of stmatrix
//     were as fast for A and slower for D, whether the rows then went out
//     with 4 B stores or, shifted in shared memory to the output's
//     alignment, with 16 B stores;
//   - loading the query rows only after the entry tile had arrived (a
//     second wait on memory per block) was slower for A and for a shard's
//     view, and as fast for D;
//   - a persistent grid with the next tile's copies in flight (double
//     buffering), two tiles a block with the second's copies in flight,
//     4 warps of 8 n8 tiles each (half the query fragment loads), 128
//     entries and 4 warps a block, streaming (evict-first) stores, and a
//     register cap for more resident blocks were all slower.
// Leaving out one stage at a time showed the output stores as the largest
// part, then the entry copies, then the mma. How close the kernel comes to
// the card's own streaming of the same bytes (a fill of the output plus a
// read of the entries, which chip_smoke.py times beside it) is in PERF.md.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWords = 32;    // resolution <= 1024: K <= 4 k-steps
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileQ = 64;       // queries per pass: 4 m16 tiles

// Entries per block tile: 256 while the tiles fit the 48 KB of static shared
// memory (K <= 2, W <= 16), 128 above.
template <int K> struct Tile {
  static constexpr int kPitch = K == 4 ? 36 : 8 * K;     // words per row
  static constexpr int kEntries = K <= 2 ? 256 : 128;
  static constexpr int kNTiles = kEntries / 8 / kWarps;  // n8 tiles per warp
  static constexpr int kPairs = kNTiles / 2;             // 2, or 1 at K > 2
  // 16 B aligned rows whose 8-row stmatrix stores hit every bank once
  static constexpr int kMatchPitch = kEntries + 16;
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// d += popc(a & b) over one 16 x 8 x 256-bit tile.
__device__ __forceinline__ void mma_and_popc(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two (four) 8 x 8 matrices of b16 in the mma result layout into shared
// memory; lanes 8i .. 8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void stmatrix_x2(void* smem, uint32_t r0,
                                            uint32_t r1) {
  const unsigned p = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("stmatrix.sync.aligned.m8n8.x2.shared.b16 [%0], {%1, %2};\n"
               ::"r"(p), "r"(r0), "r"(r1));
}

__device__ __forceinline__ void stmatrix_x4(void* smem, uint32_t r0,
                                            uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  const unsigned p = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
      ::"r"(p), "r"(r0), "r"(r1), "r"(r2), "r"(r3));
}

// The 2K words a lane takes from one row (16 B loads for even K, 8 B for odd).
template <int K>
__device__ __forceinline__ void load_row_words(const uint32_t* p,
                                               uint32_t (&w)[2 * K]) {
  if constexpr (K % 2 == 0) {
#pragma unroll
    for (int j = 0; j < K / 2; ++j) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[j];
      w[4 * j] = v.x;
      w[4 * j + 1] = v.y;
      w[4 * j + 2] = v.z;
      w[4 * j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const uint2 v = reinterpret_cast<const uint2*>(p)[j];
      w[2 * j] = v.x;
      w[2 * j + 1] = v.y;
    }
  }
}

// The 64 query rows of a pass at q0, zero past Q and past W, as cp.async
// copies of this thread's current group.
template <int K>
__device__ __forceinline__ void stage_queries(const int32_t* qs, int q0,
                                              int nq, int W, uint32_t* sq) {
  constexpr int PE = Tile<K>::kPitch;
  for (int i = threadIdx.x; i < kTileQ * 8 * K; i += kThreads) {
    const int r = i / (8 * K), w = i - r * (8 * K);
    if (r < nq && w < W) {
      cp_async4(&sq[r * PE + w], qs + (int64_t)(q0 + r) * W + w);
    } else {
      sq[r * PE + w] = 0u;
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads) batch_filter_kernel(
    const int32_t* __restrict__ queries, const int32_t* __restrict__ entries,
    const uint8_t* __restrict__ live, int Q, int E, int W,
    uint8_t* __restrict__ out) {
  using T = Tile<K>;
  constexpr int PE = T::kPitch;
  constexpr int TE = T::kEntries;
  constexpr int MP = T::kMatchPitch;
  __shared__ __align__(16) uint32_t se[TE * PE];
  __shared__ __align__(16) uint32_t sq[kTileQ * PE];
  __shared__ __align__(16) uint8_t sm[kTileQ * MP];
  __shared__ __align__(16) uint8_t sl[TE];

  const int s = blockIdx.y;
  const int e0 = blockIdx.x * TE;
  const int n = min(TE, E - e0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // 1. the entry tile (n*W contiguous words, re-laid at pitch PE), the
  // first pass's query rows and the live bytes
  {
    const int32_t* src = entries + ((int64_t)s * E + e0) * W;
    const int total = n * W;
    int row = tid / W, col = tid - row * W;
    const int drow = kThreads / W, dcol = kThreads - drow * W;
    for (int j = tid; j < total; j += kThreads) {
      cp_async4(&se[row * PE + col], src + j);
      row += drow;
      col += dcol;
      if (col >= W) {
        col -= W;
        ++row;
      }
    }
  }
  const int32_t* qs = queries + (int64_t)s * Q * W;
  stage_queries<K>(qs, 0, min(kTileQ, Q), W, sq);
  for (int i = tid; i < n; i += kThreads) sl[i] = live[(int64_t)s * E + e0 + i];
  cp_async_wait_all();
  __syncthreads();

  // 2. this warp's B fragments and the live bytes of its columns, in pairs
  // of n8 tiles of 16 entries: the first tile of a pair takes entries 4c,
  // 4c+1 of each group of 4 and the second 4c+2, 4c+3 (step 4).
  const int wbase = warp * T::kNTiles * 8;
  uint32_t b[T::kNTiles][2 * K];
  uint32_t live2[T::kNTiles];
#pragma unroll
  for (int nt = 0; nt < T::kNTiles; ++nt) {
    const int pbase = wbase + (nt >> 1) * 16 + (nt & 1) * 2;
    load_row_words<K>(&se[(pbase + 4 * (g >> 1) + (g & 1)) * PE + t * 2 * K],
                      b[nt]);
    live2[nt] = *reinterpret_cast<const uint16_t*>(&sl[pbase + 4 * t]);
  }

  for (int q0 = 0; q0 < Q; q0 += kTileQ) {
    const int nq = min(kTileQ, Q - q0);
    if (q0 > 0) {
      __syncthreads();   // the last pass is done with sq and sm
      stage_queries<K>(qs, q0, nq, W, sq);
      cp_async_wait_all();
      __syncthreads();
    }

    // 3-4. mma per (m-tile, n8 tile); counts > 0 and live into the match tile
    const int mtiles = (nq + 15) >> 4;
#pragma unroll
    for (int mt = 0; mt < kTileQ / 16; ++mt) {
      if (mt < mtiles) {
        uint32_t lo[2 * K], hi[2 * K];
        load_row_words<K>(&sq[(mt * 16 + g) * PE + t * 2 * K], lo);
        load_row_words<K>(&sq[(mt * 16 + g + 8) * PE + t * 2 * K], hi);
        uint32_t top[T::kNTiles], bot[T::kNTiles];
#pragma unroll
        for (int nt = 0; nt < T::kNTiles; ++nt) {
          int d[4] = {0, 0, 0, 0};
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const uint32_t a[4] = {lo[2 * k], hi[2 * k], lo[2 * k + 1],
                                   hi[2 * k + 1]};
            mma_and_popc(d, a, b[nt][2 * k], b[nt][2 * k + 1]);
          }
          top[nt] = ((d[0] != 0 ? 1u : 0u) | (d[1] != 0 ? 0x100u : 0u)) &
                    live2[nt];
          bot[nt] = ((d[2] != 0 ? 1u : 0u) | (d[3] != 0 ? 0x100u : 0u)) &
                    live2[nt];
        }
        // matrix i of a store: rows 8 * (i & 1) .. of the m-tile, pair i >> 1
        // (lanes 8i .. 8i+7 give its row addresses)
        uint8_t* rowp = &sm[(mt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * MP
                            + wbase + (lane >> 4) * 16];
        if constexpr (T::kPairs == 2) {
          stmatrix_x4(rowp, top[0] | top[1] << 16, bot[0] | bot[1] << 16,
                      top[2] | top[3] << 16, bot[2] | bot[3] << 16);
        } else {
          stmatrix_x2(rowp, top[0] | top[1] << 16, bot[0] | bot[1] << 16);
        }
      }
    }
    __syncthreads();

    // 5. rows out: aligned 4 B words; then the at most 3 + 3 bytes at the
    // ends of 8 of this warp's rows at a time, four lanes a row
    uint8_t* out_tile = out + ((int64_t)s * Q + q0) * E + e0;
    for (int r = warp; r < nq; r += kWarps) {
      uint8_t* dst = out_tile + (int64_t)r * E;
      const uint32_t* roww = reinterpret_cast<const uint32_t*>(&sm[r * MP]);
      const int a = (int)((uintptr_t)dst & 3);
      const int head = (4 - a) & 3;
      const int nw = n > head ? (n - head) >> 2 : 0;
      uint32_t* base = reinterpret_cast<uint32_t*>(dst + head);
      const int shift = head * 8;
      for (int w = lane; w < nw; w += 32) {
        base[w] = __funnelshift_r(roww[w], roww[w + 1], shift);
      }
    }
    for (int r = warp + kWarps * (lane >> 2); r < nq; r += 8 * kWarps) {
      uint8_t* dst = out_tile + (int64_t)r * E;
      const uint8_t* row = &sm[r * MP];
      const int a = (int)((uintptr_t)dst & 3);
      int head = (4 - a) & 3;
      if (head > n) head = n;
      const int tail0 = head + ((n - head) & ~3);   // first byte after words
      for (int k = lane & 3; k < head + (n - tail0); k += 4) {
        const int tb = k < head ? k : tail0 + (k - head);
        dst[tb] = row[tb];
      }
    }
  }
}

template <int K>
int launch(const int32_t* queries, const int32_t* entries, const uint8_t* live,
           int S, int Q, int E, int W, uint8_t* out, cudaStream_t stream) {
  constexpr int TE = Tile<K>::kEntries;
  dim3 grid((E + TE - 1) / TE, S);
  batch_filter_kernel<K><<<grid, kThreads, 0, stream>>>(queries, entries,
                                                        live, Q, E, W, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hippo_batch_filter_sharded(const int32_t* queries,
                                          const int32_t* entries,
                                          const uint8_t* live, int S, int Q,
                                          int E, int W, uint8_t* out,
                                          cudaStream_t stream) {
  if (W > kMaxWords || W < 0) return (int)cudaErrorInvalidValue;
  if (S <= 0 || E <= 0 || Q <= 0) return (int)cudaGetLastError();
  if (W == 0)   // no bucket to share: nothing matches
    return (int)cudaMemsetAsync(out, 0, (size_t)S * Q * E, stream);
  switch ((W + 7) / 8) {
    case 1: return launch<1>(queries, entries, live, S, Q, E, W, out, stream);
    case 2: return launch<2>(queries, entries, live, S, Q, E, W, out, stream);
    case 3: return launch<3>(queries, entries, live, S, Q, E, W, out, stream);
    default: return launch<4>(queries, entries, live, S, Q, E, W, out, stream);
  }
}

extern "C" int hippo_batch_filter(const int32_t* queries,
                                  const int32_t* entries, const uint8_t* live,
                                  int Q, int E, int W, uint8_t* out,
                                  cudaStream_t stream) {
  return hippo_batch_filter_sharded(queries, entries, live, 1, Q, E, W, out,
                                    stream);
}

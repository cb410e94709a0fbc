// Histogram bucket probe (paper section 4.2) for Hopper (sm_90a).
//
// Replaces the TPU kernel `bucketize_kernel`
// (src/repro/kernels/bucketize/kernel.py:40, pallas_call at :48):
//   ids[i] = clip(#{bounds <= values[i]} - 1, 0, resolution - 1)
// which equals searchsorted(bounds, v, side="right") - 1, clipped, for
// nondecreasing bounds (NaN bounds are outside that contract). That formula
// gives a NaN value bucket 0; the reference's core (jnp.searchsorted) sorts
// NaN last, into bucket resolution - 1. With `nan_last` set, a NaN value
// takes resolution - 1 (one select in the same pass); with it clear, the
// kernel keeps the TPU kernel's formula. Callers: the index build and the
// maintenance paths (every tuple of a shard, through a view that starts at
// any 4 B boundary; inserted values) through `hippo_bucketize`, and
// predicate conversion (the 2Q endpoints of a batch under every shard's
// bounds row, packed into the query bitmaps' words in the same launch)
// through `hippo_bucketize_rows_words`, all with `nan_last` set.
//
// The rows entry probes one set of values under each of S bounds rows,
// (S, H+1) -> ids (S, N): the grid's second axis runs over the rows, and
// each block copies its own row into shared memory, exactly as the 1-D
// launch does (which is the rows entry at S = 1). Row s is converted under
// bounds[s] whatever the other rows hold, so shards on different bounds
// epochs in the middle of a drift remap need no grouping: a batch of 64
// predicates under 4 shards is 4 x 128 lookups in one launch, with no
// distinct-row search on the device and nothing read back by the host.
//
// The words entry (`hippo_bucketize_rows_words`) is the rows entry fused
// with the packing that follows it in predicate conversion: it buckets each
// interval's two endpoints with the same device function and writes the
// (S, Q, W) int32 query bitmaps itself, each word in closed form. The plain
// composition it replaces on the card (ids, a (S, Q, 32W) bool range mask
// packed 32 passes of a bit, the empty predicates zeroed) took ~110 small
// launches, each a few microseconds of device work behind its host dispatch;
// at S = 4, Q = 64, H = 400 the entry moves ~20 KB, so one launch's latency
// is all it costs.
//
// What bounds it on the H100: bytes. Each value is read once (4 B) and its
// id written once (4 B); the H+1 bounds are a few KB. At the build's shape
// (N = 18,746,450 values of one SF10 shard) that is 150 MB, 0.045 ms at the
// H100 SXM's published 3.35 TB/s (700 W). The first design of this file ran a
// 9-step binary search per value (dependent shared-memory reads at addresses
// that differ across the lanes), moved 4 B a lane and took 0.093 ms there;
// this one takes 0.066 ms, 1.47x the bound and as long as the card's own
// float32 -> int32 copy of the same values (0.065 ms), and 0.069 ms at an odd
// shard's view (`python3 chip_smoke.py --baseline-csrc`, NVIDIA H100 80GB
// HBM3, power limit 700.00 W).
//
// Design: a constant-time rank. Each block copies the bounds into shared
// memory and builds a table of kBuckets buckets over the span of the finite
// bounds, b(v) = clamp(floor((v - base) * scale)), the same float arithmetic
// for values and bounds, so b is monotone in v: rank(v) = #{bounds <= v} =
// (the bounds in buckets below b(v)) + (those in bucket b(v) that are <= v).
// A table cell holds the bucket's first sorted position and its count, so a
// value costs one table read and a search of its bucket, which holds 0 or 1
// bounds at H = 400. Edges keep the plain version's answer: a NaN value lands
// in bucket 0 and compares false everywhere (rank 0, id 0); +-inf values and
// bounds fall in the end buckets; -0.0 and +0.0 land together; tied bounds,
// a zero span (every bound equal) or a span that is not finite (every bound
// in bucket 0) only make a bucket crowded, and a crowded bucket is searched
// by bisection. The table is built once per block of a persistent grid, its
// 2049 sorted positions by interleaved bisections, while the block's first
// values are already in flight.
//
// Values go in and ids out in vectors of 4 (16 B) when the values and the
// output share their offset within 16 B, else in vectors of 2 where they
// share it within 8 B (an odd shard's view starts 8 mod 16 against a fresh,
// aligned output), else one by one: the warp's accesses stay contiguous
// either way. A head before the first aligned vector and a tail after the
// last go one value a thread. Small launches (predicate conversion: 2Q =
// 128 values) take one value a thread, skip the table and bisect all the
// bounds: below kTableValues values a thread the table would cost more than
// it saves.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBuckets = 2048;                    // buckets of the rank table
constexpr int kPerThread = kBuckets / kThreads;   // table cells a thread builds
constexpr int kTableValues = 16;                  // values a thread, at least
constexpr int64_t kSmall = 4096;                  // values below: no vectors

template <int V> struct Vec;
template <> struct Vec<4> { using F = float4; using I = int4; };
template <> struct Vec<2> { using F = float2; using I = int2; };
template <> struct Vec<1> { using F = float; using I = int; };

__device__ __forceinline__ int bucket_of(float v, float base, float scale) {
  return (int)fminf(fmaxf((v - base) * scale, 0.f), (float)(kBuckets - 1));
}

// The largest power of two <= n (n >= 1).
__device__ __forceinline__ int top_step(int n) { return 1 << (31 - __clz(n)); }

struct Probe {
  const float* sb;    // the bounds, in shared memory
  const int* tab;     // per bucket: first position | count << 16
  int nb;
  int step;           // top_step(nb)
  float base, scale;
};

// #{j : sb[j] <= v} over all the bounds, by bisection in steps of powers of
// two; 0 for a NaN value.
__device__ __forceinline__ int rank_all(const Probe& pr, float v) {
  int pos = 0;
  for (int s = pr.step; s > 0; s >>= 1) {
    const int c = pos + s;
    if (c <= pr.nb && pr.sb[c - 1] <= v) pos = c;
  }
  return pos;
}

// The same through the table: the bounds below v's bucket, then a bisection
// of the bucket's own (usually 0 or 1 of them).
__device__ __forceinline__ int rank_table(const Probe& pr, float v) {
  const int e = pr.tab[bucket_of(v, pr.base, pr.scale)];
  int first = e & 0xffff;
  int len = e >> 16;
  while (len > 0) {
    const int half = len >> 1;
    const bool right = pr.sb[first + half] <= v;
    first = right ? first + half + 1 : first;
    len = right ? len - half - 1 : half;
  }
  return first;
}

// Fills tab (after the bounds are in sb): the span of the finite bounds,
// then per bucket b its first position #{j : b(sb[j]) < b} and its count.
// Thread t takes buckets kPerThread * t .. + kPerThread and bisects their
// kPerThread + 1 first positions side by side, so the dependent reads of the
// bisections overlap.
__device__ inline void build_table(Probe& pr, int* tab, float* span) {
  const float* sb = pr.sb;
  const int nb = pr.nb;
  if (threadIdx.x == 0) span[0] = span[1] = 0.f;
  __syncthreads();
  for (int j = threadIdx.x; j < nb; j += kThreads) {
    const float v = sb[j];
    if (isfinite(v)) {
      if (j == 0 || !isfinite(sb[j - 1])) span[0] = v;
      if (j == nb - 1 || !isfinite(sb[j + 1])) span[1] = v;
    }
  }
  __syncthreads();
  const float base = span[0], top = span[1];
  const float width = top - base;
  pr.base = base;
  pr.scale = top > base && isfinite(width) ? (float)kBuckets / width : 0.f;
  const int b0 = kPerThread * threadIdx.x;
  int pos[kPerThread + 1];
#pragma unroll
  for (int k = 0; k <= kPerThread; ++k) pos[k] = 0;
  for (int s = pr.step; s > 0; s >>= 1) {
#pragma unroll
    for (int k = 0; k <= kPerThread; ++k) {
      const int c = pos[k] + s;
      if (c <= nb && bucket_of(sb[c - 1], pr.base, pr.scale) < b0 + k) {
        pos[k] = c;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    tab[b0 + k] = pos[k] | ((pos[k + 1] - pos[k]) << 16);
  }
  __syncthreads();
}

// nan_id: the id of a NaN value (0, the rank formula's, or resolution - 1).
template <bool kTable>
__device__ __forceinline__ int bucket_id(const Probe& pr, float v,
                                         int resolution, int nan_id) {
  const int id = (kTable ? rank_table(pr, v) : rank_all(pr, v)) - 1;
  return isnan(v) ? nan_id : min(max(id, 0), resolution - 1);
}

// values[head .. head + nvec * V) in vectors of V, the rest one by one,
// under bounds row blockIdx.y into out row blockIdx.y.
template <int V, bool kTable>
__global__ void __launch_bounds__(kThreads)
    bucketize_kernel(const float* __restrict__ values, int64_t n,
                     int64_t head, int64_t nvec,
                     const float* __restrict__ bounds, int nb, int resolution,
                     int nan_id, int* __restrict__ out) {
  using F = typename Vec<V>::F;
  using I = typename Vec<V>::I;
  bounds += (int64_t)blockIdx.y * nb;     // this block's row
  out += (int64_t)blockIdx.y * n;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sb = reinterpret_cast<float*>(smem);
  int* tab = reinterpret_cast<int*>(sb + nb);
  float* span = reinterpret_cast<float*>(tab + kBuckets);
  const F* vv = reinterpret_cast<const F*>(values + head);
  I* ov = reinterpret_cast<I*>(out + head);
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  F cur{};
  if (i < nvec) cur = vv[i];              // in flight while the table builds
  for (int j = threadIdx.x; j < nb; j += kThreads) sb[j] = bounds[j];
  __syncthreads();
  Probe pr{sb, tab, nb, top_step(nb), 0.f, 0.f};
  if (kTable) build_table(pr, tab, span);
  for (; i < nvec; i += stride) {
    F next = cur;
    if (i + stride < nvec) next = vv[i + stride];
    union { F f; float a[V]; } in;
    union { I i; int a[V]; } res;
    in.f = cur;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      res.a[u] = bucket_id<kTable>(pr, in.a[u], resolution, nan_id);
    }
    ov[i] = res.i;
    cur = next;
  }
  const int64_t tail = head + nvec * V;
  const int64_t rest = head + (n - tail);
  for (int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x; g < rest;
       g += stride) {
    const int64_t k = g < head ? g : tail + (g - head);
    out[k] = bucket_id<kTable>(pr, values[k], resolution, nan_id);
  }
}

template <int V, bool kTable>
cudaError_t launch(const float* values, int64_t n, int64_t head, int64_t nvec,
                   const float* bounds, int rows, int nb, int resolution,
                   int nan_id, int* out, int64_t blocks, cudaStream_t stream) {
  auto kernel = bucketize_kernel<V, kTable>;
  const size_t smem =
      (size_t)nb * 4 + (kTable ? (size_t)(kBuckets + 2) * 4 : 0);
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess) {
    return err;
  }
  kernel<<<dim3((unsigned)blocks, (unsigned)rows), kThreads, smem, stream>>>(
      values, n, head, nvec, bounds, nb, resolution, nan_id, out);
  return cudaGetLastError();
}

// The current device's SM count, asked once per device: a query on every
// launch would cost a small launch (predicate conversion) host time.
inline cudaError_t sm_count(int* sms) {
  constexpr int kDevices = 64;
  static int known[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && known[dev] > 0) {
    *sms = known[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kDevices) known[dev] = *sms;
  return err;
}

template <int V>
cudaError_t launch_width(const float* values, int64_t n, const float* bounds,
                         int rows, int nb, int resolution, int nan_id,
                         int* out, cudaStream_t stream) {
  // head: values before the first address aligned to V floats
  const int64_t mis = (int64_t)((reinterpret_cast<uintptr_t>(values) / 4) %
                                V);
  int64_t head = (V - mis) % V;
  if (head > n) head = n;
  const int64_t nvec = (n - head) / V;
  const int64_t work = nvec > n - nvec * V ? nvec : n - nvec * V;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int64_t resident = (int64_t)sms * (2048 / kThreads);
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  if (nvec * V >= (int64_t)kTableValues * kThreads * resident) {
    return launch<V, true>(values, n, head, nvec, bounds, rows, nb,
                           resolution, nan_id, out, blocks, stream);
  }
  return launch<V, false>(values, n, head, nvec, bounds, rows, nb, resolution,
                          nan_id, out, blocks, stream);
}

// The rows entry fused with the packing after it: the (rows, Q, W) int32
// query bitmaps of Q closed intervals [los[i], his[i]] under each bounds row.
// Block (x, s) stages row s of the bounds in shared memory, then takes the
// intervals in chunks of kThreads, strided over gridDim.x: a thread buckets
// one interval's two endpoints with the rows entry's own bucket_id, into
// shared memory, and the block writes the chunk's W words a query, thread k
// on word k of the chunk, so the stores are contiguous. Word w holds bits
// [lo, hi] of [32w, 32w + 32) in closed form: a = clamp(lo - 32w, 0, 32),
// b = clamp(min(hi + 1, resolution) - 32w, 0, 32), word (2^b - 2^a) mod 2^32
// where b > a, else 0. An interval with nonempty[i] clear gets hi = -1, so
// all its words are 0.
__global__ void __launch_bounds__(kThreads)
    bucketize_words_kernel(const float* __restrict__ los,
                           const float* __restrict__ his,
                           const uint8_t* __restrict__ nonempty, int q,
                           const float* __restrict__ bounds, int nb,
                           int resolution, int nan_id, int w,
                           int* __restrict__ words) {
  bounds += (int64_t)blockIdx.y * nb;     // this block's row
  words += (int64_t)blockIdx.y * q * w;
  extern __shared__ __align__(16) unsigned char smem[];
  int* lo_id = reinterpret_cast<int*>(smem);
  int* hi_id = lo_id + kThreads;
  float* sb = reinterpret_cast<float*>(hi_id + kThreads);
  for (int j = threadIdx.x; j < nb; j += kThreads) sb[j] = bounds[j];
  __syncthreads();
  const Probe pr{sb, nullptr, nb, top_step(nb), 0.f, 0.f};
  for (int first = blockIdx.x * kThreads; first < q;
       first += gridDim.x * kThreads) {
    const int n = min(kThreads, q - first);
    if (threadIdx.x < n) {
      const int i = first + threadIdx.x;
      lo_id[threadIdx.x] = bucket_id<false>(pr, los[i], resolution, nan_id);
      hi_id[threadIdx.x] =
          nonempty[i] ? bucket_id<false>(pr, his[i], resolution, nan_id) : -1;
    }
    __syncthreads();
    int* out = words + (int64_t)first * w;
    for (int k = threadIdx.x; k < n * w; k += kThreads) {
      const int i = k / w;
      const int bit0 = (k - i * w) * 32;
      const int a = min(max(lo_id[i] - bit0, 0), 32);
      const int b = min(max(min(hi_id[i] + 1, resolution) - bit0, 0), 32);
      out[k] = b > a ? (int)(uint32_t)((1ull << b) - (1ull << a)) : 0;
    }
    __syncthreads();
  }
}

}  // namespace

// Ids of values (N,) under each row of bounds (rows, nb), into out (rows, N).
extern "C" int hippo_bucketize_rows(const float* values, int64_t n,
                                    const float* bounds, int rows, int nb,
                                    int resolution, int nan_last, int* out,
                                    cudaStream_t stream) {
  if (n <= 0 || nb <= 0 || rows <= 0) return (int)cudaGetLastError();
  if (rows > 65535) return (int)cudaErrorInvalidValue;   // grid's y axis
  const int nan_id = nan_last ? resolution - 1 : 0;
  // The widest vector at which values and ids share their offset, in every
  // out row: row s starts s * n ids after the first.
  const uintptr_t d = reinterpret_cast<uintptr_t>(values) ^
                      reinterpret_cast<uintptr_t>(out);
  cudaError_t err;
  if (n < kSmall) {   // one value a thread: the shortest chain per thread
    err = launch_width<1>(values, n, bounds, rows, nb, resolution, nan_id,
                          out, stream);
  } else if ((d & 15) == 0 && (rows == 1 || n % 4 == 0)) {
    err = launch_width<4>(values, n, bounds, rows, nb, resolution, nan_id,
                          out, stream);
  } else if ((d & 7) == 0 && (rows == 1 || n % 2 == 0)) {
    err = launch_width<2>(values, n, bounds, rows, nb, resolution, nan_id,
                          out, stream);
  } else {
    err = launch_width<1>(values, n, bounds, rows, nb, resolution, nan_id,
                          out, stream);
  }
  return (int)err;
}

extern "C" int hippo_bucketize(const float* values, int64_t n,
                               const float* bounds, int nb, int resolution,
                               int nan_last, int* out, cudaStream_t stream) {
  return hippo_bucketize_rows(values, n, bounds, 1, nb, resolution, nan_last,
                              out, stream);
}

// Query bitmaps of the intervals [los, his] (Q,) with nonempty (Q,) under
// each row of bounds (rows, nb), into words (rows, Q, ceil(resolution / 32)).
extern "C" int hippo_bucketize_rows_words(const float* los, const float* his,
                                          const uint8_t* nonempty, int q,
                                          const float* bounds, int rows,
                                          int nb, int resolution,
                                          int nan_last, int* words,
                                          cudaStream_t stream) {
  if (q <= 0 || nb <= 0 || rows <= 0) return (int)cudaGetLastError();
  if (rows > 65535) return (int)cudaErrorInvalidValue;   // grid's y axis
  const int nan_id = nan_last ? resolution - 1 : 0;
  const int w = (resolution + 31) / 32;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  // enough blocks of kThreads intervals to cover Q, no more than stay
  // resident beside the other rows' blocks
  int per_row = sms * (2048 / kThreads) / rows;
  if (per_row < 1) per_row = 1;
  int blocks = (q + kThreads - 1) / kThreads;
  if (blocks > per_row) blocks = per_row;
  const size_t smem = (size_t)nb * 4 + 2 * kThreads * 4;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(bucketize_words_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess) {
    return (int)err;
  }
  bucketize_words_kernel<<<dim3((unsigned)blocks, (unsigned)rows), kThreads,
                           smem, stream>>>(los, his, nonempty, q, bounds, nb,
                                           resolution, nan_id, w, words);
  return (int)cudaGetLastError();
}

// Error text for the codes the C entry points of every csrc file return.
extern "C" const char* hippo_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

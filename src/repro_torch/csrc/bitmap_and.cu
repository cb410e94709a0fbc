// Single-query joint-bucket filter (paper section 3.2, Fig. 3) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `bitmap_and_any_kernel`
// (src/repro/kernels/bitmap_and/kernel.py:29, pallas_call at :35):
//   out[e] = live[e] && any_w(entries[e, w] & query[w])
// One change of contract against the TPU kernel: the live-slot mask
// (`slot_live & slot < num_slots`, src/repro/core/index.py:228-230) is fused
// in, as kernel A fuses it, and the result is one byte per entry. Words are
// int32 holding the reference's uint32 bits. There is no padding of E to a
// block or of W to 128 lanes: the kernel masks its own ragged edge.
//
// What bounds it on the H100: bytes. Entry words are read once (E*W*4 B),
// the live bytes once and one match byte written per entry; the query is a
// few words. At SF10 (the unsharded HippoIndex: E=1,500,676 slots, W=13)
// that is ~78 MB in and 1.5 MB out, ~0.024 ms at the H100 SXM's published
// 3.35 TB/s (700 W). The AND work (E*W word ops) is far below the integer
// rate.
//
// Design: one thread per entry. A block stages its 256 entries' words in
// shared memory with coalesced loads (the rows are W words apart, so direct
// per-thread loads would stride), at an odd row pitch so that the per-thread
// row reads hit 32 distinct banks; the query words sit in shared memory and
// are read as broadcasts.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // entries per block
constexpr int kMaxWords = 32;   // resolution <= 1024
constexpr int kPitch = kMaxWords + 1;

__global__ void bitmap_and_any_kernel(const uint32_t* __restrict__ entries,
                                      const uint32_t* __restrict__ query,
                                      const uint8_t* __restrict__ live, int E,
                                      int W, uint8_t* __restrict__ out) {
  __shared__ uint32_t tile[kThreads * kPitch];
  __shared__ uint32_t qs[kMaxWords];
  const int e0 = blockIdx.x * kThreads;
  const int ne = min(kThreads, E - e0);
  const int pitch = W | 1;   // odd: conflict-free row reads
  if (threadIdx.x < W) qs[threadIdx.x] = query[threadIdx.x];
  const uint32_t* src = entries + (int64_t)e0 * W;
  for (int i = threadIdx.x; i < ne * W; i += kThreads) {
    const int r = i / W;
    tile[r * pitch + (i - r * W)] = src[i];
  }
  __syncthreads();
  if (threadIdx.x < ne) {
    uint32_t acc = 0u;
    const uint32_t* row = tile + threadIdx.x * pitch;
    for (int w = 0; w < W; ++w) acc |= row[w] & qs[w];
    const int e = e0 + threadIdx.x;
    out[e] = (acc != 0u && live[e] != 0) ? 1 : 0;
  }
}

}  // namespace

extern "C" int hippo_bitmap_and_any(const int32_t* entries,
                                    const int32_t* query,
                                    const uint8_t* live, int E, int W,
                                    uint8_t* out, cudaStream_t stream) {
  if (W < 1 || W > kMaxWords) return (int)cudaErrorInvalidValue;
  if (E > 0) {
    bitmap_and_any_kernel<<<(E + kThreads - 1) / kThreads, kThreads, 0,
                            stream>>>(
        reinterpret_cast<const uint32_t*>(entries),
        reinterpret_cast<const uint32_t*>(query), live, E, W, out);
  }
  return (int)cudaGetLastError();
}

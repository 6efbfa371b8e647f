// Raw one-mask popcount sums on Hopper (sm_90a).
//
// Replaces tools/probe_roofline.py:_kern, launched by count_pallas (the
// row-tiled Pallas kernel of the TPU roofline probe).  For each row r of the
// packed planes and ONE column mask m it computes the raw sums
//
//     n10 = sum popc(p0 & m)   n11 = sum popc(p1 & m)   nb = sum popc(p0 & p1 & m)
//
// with no affine step, into a (rows, 3) int32 output.  The TPU kernel's
// layout is not carried over: its 128-lane output padded lanes 3..127 with
// zeros, and its 256-row tiles and the trim of the rows to a multiple of
// 256 were TPU tiling; this kernel takes any row count, any width and a row
// offset.
//
// What bounds it on this card: device-memory bytes, 2 * rows * words * 4 read
// once, against 3 popcounts per word pair.  It is the probe's one-mask
// streaming kernel, the reference point for kernel A (count_codes.cu) at 1
// mask.
//
// What the design does about it: one warp streams one row of both planes
// with coalesced loads, 128-bit loads when the width is a multiple of 4 words
// and the pointers are 16-byte aligned, 32-bit loads otherwise.  The mask
// (8 KB at 2,048 words) is read through the read-only path and stays in L1:
// a version that staged it in shared memory once per block, over a one-wave
// grid, measured as fast at 2,048 words and slower at 157 (PERF.md).  One
// block per 8 rows.  Each lane keeps three accumulators; the warp reduces them
// with __reduce_add_sync, so there are no atomics and the sums are exact.
//
// Interface: a plain C entry point (bgt_count_raw) bound with ctypes.  It
// launches on the caller's stream, does not synchronise, allocates nothing,
// and returns the first CUDA error it meets (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void add3(uint32_t a, uint32_t b, uint32_t m,
                                     unsigned& n10, unsigned& n11, unsigned& nb) {
  const uint32_t am = a & m;
  const uint32_t bm = b & m;
  n10 += __popc(am);
  n11 += __popc(bm);
  nb += __popc(am & bm);
}

// kVec: 128-bit loads (words % 4 == 0, 16-byte aligned pointers).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
count_raw_kernel(const uint32_t* __restrict__ p0,
                 const uint32_t* __restrict__ p1,
                 const uint32_t* __restrict__ m,
                 int* __restrict__ out,
                 long long row_start, int rows, int words) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= rows) return;  // the whole warp leaves together
  const size_t base = (size_t)(row_start + r) * words;
  unsigned n10 = 0, n11 = 0, nb = 0;
  if (kVec) {
    const uint4* a4 = reinterpret_cast<const uint4*>(p0 + base);
    const uint4* b4 = reinterpret_cast<const uint4*>(p1 + base);
    const uint4* m4 = reinterpret_cast<const uint4*>(m);
    const int n4 = words >> 2;
#pragma unroll 4
    for (int i = lane; i < n4; i += 32) {
      const uint4 a = __ldg(a4 + i);
      const uint4 b = __ldg(b4 + i);
      const uint4 mk = __ldg(m4 + i);
      add3(a.x, b.x, mk.x, n10, n11, nb);
      add3(a.y, b.y, mk.y, n10, n11, nb);
      add3(a.z, b.z, mk.z, n10, n11, nb);
      add3(a.w, b.w, mk.w, n10, n11, nb);
    }
  } else {
#pragma unroll 8
    for (int w = lane; w < words; w += 32)
      add3(__ldg(p0 + base + w), __ldg(p1 + base + w), __ldg(m + w), n10, n11, nb);
  }
  n10 = __reduce_add_sync(kFull, n10);
  n11 = __reduce_add_sync(kFull, n11);
  nb = __reduce_add_sync(kFull, nb);
  if (lane == 0) {
    out[r * 3 + 0] = (int)n10;
    out[r * 3 + 1] = (int)n11;
    out[r * 3 + 2] = (int)nb;
  }
}

}  // namespace

// p0, p1: (n_rows, words) planes; rows [row_start, row_start + rows) are
// counted.  mask: (1, words).  out: (rows, 3) int32: n10, n11, nb per row.
// stream: a cudaStream_t.  Launches nothing when rows is 0.
extern "C" int bgt_count_raw(const void* p0, const void* p1, const void* mask,
                             void* out, long long row_start, int rows, int words,
                             void* stream) {
  if (rows <= 0) return 0;
  const uint32_t* a = static_cast<const uint32_t*>(p0);
  const uint32_t* b = static_cast<const uint32_t*>(p1);
  const uint32_t* m = static_cast<const uint32_t*>(mask);
  const bool vec = words % 4 == 0 && (((uintptr_t)a | (uintptr_t)b | (uintptr_t)m) & 15) == 0;
  const unsigned blocks = (unsigned)(((long long)rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  auto kernel = vec ? count_raw_kernel<true> : count_raw_kernel<false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, m, static_cast<int*>(out), row_start, rows, words);
  return (int)cudaGetLastError();
}

// Masked-popcount genotype counts on Hopper (sm_90a).
//
// Replaces bgt_tpu/ops/counts.py:_count3_kernel, launched by
// _count_codes_pallas (the Pallas kernel on the TPU).  For each row r of the
// packed planes and each column mask m_g it computes
//
//     n10 = sum popc(p0 & m_g)   n11 = sum popc(p1 & m_g)
//     nb  = sum popc(p0 & p1 & m_g)
//
// and, unlike the TPU kernel, applies the affine step in the epilogue, so
// the output is the final (rows, groups, 4) int32 counts of codes 0..3:
//
//     cnt1 = n10 - nb   cnt2 = n11 - nb   cnt3 = nb
//     cnt0 = |m_g| - cnt1 - cnt2 - cnt3
//
// What bounds it on this card: device-memory bytes.  A pass reads
// 2 * rows * words * 4 bytes of planes whatever the group count; the masks
// (at most 33 x words x 4 bytes, ~270 KB at the widest cohort) stay resident
// in L1/L2.  Compute is 3 popcounts per word per group, so at high group
// counts the popcount units, not memory, become the limit.
//
// What the design does about it: every plane word is read from device memory
// exactly once.  One warp owns one row; it holds a tile of K words per lane
// (32*K words per warp) of both planes in registers and loops over all
// groups on that tile before it loads the next, so the planes are never
// re-read per group (the TPU kernel re-read them for every 8-group chunk).
// Loads are plain coalesced 32-bit loads; out-of-range words of a ragged
// tile load as 0, which adds nothing to any popcount, so odd word widths need
// no scalar tail.  Per-tile warp sums use __reduce_add_sync (no atomics:
// the result is deterministic and exact) and accumulate in shared memory,
// three ints per group per warp, so register use does not grow with the
// group count.  The row offset of a range query is a kernel argument.
// Groups are counted in chunks of at most kMaxGroupsPerLaunch per launch, so
// those accumulators stay within the default 48 KB of dynamic shared memory
// at any group count; past 512 groups the planes are read once per chunk,
// where the popcounts, not the reads, already bound the kernel.
//
// Interface: a plain C entry point (bgt_count_codes) bound with ctypes.  It
// launches on the caller's stream, does not synchronise, allocates nothing,
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kTileWordsPerLane = 8;  // K: 256 words of each plane per tile
constexpr unsigned kFull = 0xffffffffu;
// 8 warps x 512 groups x 3 sums x 4 bytes = 48 KB of shared memory
constexpr int kMaxGroupsPerLaunch = 512;

// |m_g| for every group: one block per group.
__global__ void mask_popcount_kernel(const uint32_t* __restrict__ masks,
                                     int words, int* __restrict__ mask_pop) {
  __shared__ unsigned warp_sums[kWarpsPerBlock];
  const uint32_t* m = masks + (size_t)blockIdx.x * words;
  unsigned s = 0;
  for (int w = threadIdx.x; w < words; w += blockDim.x) s += __popc(__ldg(m + w));
  s = __reduce_add_sync(kFull, s);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) warp_sums[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned t = 0;
    for (int i = 0; i < kWarpsPerBlock; ++i) t += warp_sums[i];
    mask_pop[blockIdx.x] = (int)t;
  }
}

__global__ void __launch_bounds__(kThreads)
count_codes_kernel(const uint32_t* __restrict__ p0,
                   const uint32_t* __restrict__ p1,
                   const uint32_t* __restrict__ masks,
                   const int* __restrict__ mask_pop,
                   int4* __restrict__ out,
                   long long row_start, int rows, int words, int groups,
                   int out_groups) {
  constexpr int K = kTileWordsPerLane;
  extern __shared__ unsigned acc_all[];  // [warp][group][3]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned* acc = acc_all + (size_t)warp * groups * 3;
  const long long n_warps = (long long)gridDim.x * kWarpsPerBlock;

  for (long long r = (long long)blockIdx.x * kWarpsPerBlock + warp; r < rows;
       r += n_warps) {
    for (int i = lane; i < groups * 3; i += 32) acc[i] = 0;
    __syncwarp();
    const uint32_t* a_row = p0 + (size_t)(row_start + r) * words;
    const uint32_t* b_row = p1 + (size_t)(row_start + r) * words;
    for (int w0 = 0; w0 < words; w0 += 32 * K) {
      uint32_t a[K], b[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int w = w0 + k * 32 + lane;
        a[k] = w < words ? __ldg(a_row + w) : 0u;
        b[k] = w < words ? __ldg(b_row + w) : 0u;
      }
      for (int g = 0; g < groups; ++g) {
        const uint32_t* m = masks + (size_t)g * words;
        unsigned n10 = 0, n11 = 0, nb = 0;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int w = w0 + k * 32 + lane;
          const uint32_t mk = w < words ? __ldg(m + w) : 0u;
          const uint32_t am = a[k] & mk;
          const uint32_t bm = b[k] & mk;
          n10 += __popc(am);
          n11 += __popc(bm);
          nb += __popc(am & bm);
        }
        n10 = __reduce_add_sync(kFull, n10);
        n11 = __reduce_add_sync(kFull, n11);
        nb = __reduce_add_sync(kFull, nb);
        if (lane == 0) {
          acc[g * 3 + 0] += n10;
          acc[g * 3 + 1] += n11;
          acc[g * 3 + 2] += nb;
        }
      }
    }
    __syncwarp();
    for (int g = lane; g < groups; g += 32) {
      const int n10 = (int)acc[g * 3 + 0];
      const int n11 = (int)acc[g * 3 + 1];
      const int nb = (int)acc[g * 3 + 2];
      const int c1 = n10 - nb;
      const int c2 = n11 - nb;
      out[(size_t)r * out_groups + g] = make_int4(mask_pop[g] - c1 - c2 - nb, c1, c2, nb);
    }
    __syncwarp();
  }
}

}  // namespace

// p0, p1: (n_rows, words) planes; rows [row_start, row_start + rows) are
// counted.  masks: (groups, words).  mask_pop: (groups,) int32 scratch.
// out: (rows, groups, 4) int32, 16-byte aligned.  stream: a cudaStream_t.
extern "C" int bgt_count_codes(const void* p0, const void* p1, const void* masks,
                               void* mask_pop, void* out, long long row_start,
                               int rows, int words, int groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mask_popcount_kernel<<<groups, kThreads, 0, s>>>(
      static_cast<const uint32_t*>(masks), words, static_cast<int*>(mask_pop));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long want = ((long long)rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int blocks = (int)(want < (1 << 20) ? want : (1 << 20));
  for (int g0 = 0; g0 < groups; g0 += kMaxGroupsPerLaunch) {
    const int gn = groups - g0 < kMaxGroupsPerLaunch ? groups - g0 : kMaxGroupsPerLaunch;
    const size_t smem = (size_t)kWarpsPerBlock * gn * 3 * sizeof(unsigned);
    count_codes_kernel<<<blocks, kThreads, smem, s>>>(
        static_cast<const uint32_t*>(p0), static_cast<const uint32_t*>(p1),
        static_cast<const uint32_t*>(masks) + (size_t)g0 * words,
        static_cast<const int*>(mask_pop) + g0, static_cast<int4*>(out) + g0,
        row_start, rows, words, gn, groups);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Masked-popcount genotype counts at narrow row widths on Hopper (sm_90a).
//
// Replaces docs/experiments/pallas_count.py:_count_kernel, launched by
// count_codes_pallas (the narrow-width Pallas experiment).  It computes what
// count_codes.cu computes, the final (rows, groups, 4) int32 counts with the
// affine step inside the kernel:
//
//     n10 = sum popc(p0 & m_g)   n11 = sum popc(p1 & m_g)   nb = sum popc(p0 & p1 & m_g)
//     cnt0 = |m_g| - cnt1 - cnt2 - cnt3, cnt1 = n10 - nb, cnt2 = n11 - nb, cnt3 = nb
//
// for at most 32 groups (the TPU kernel's limit) whose masks fit in shared
// memory together: groups * words * 4 bytes <= the card's opt-in limit
// (227 KB on an H100: 32 groups up to 1,816 words).
//
// What bounds it on this card: at 1 group, device-memory bytes
// (2 * rows * words * 4); from a few groups on, the popcount issue rate (3
// popcounts per word per group), as for count_codes.cu.  What it changes
// against count_codes.cu, whose warp owns one row in 256-word register tiles
// and reads every mask word through L1 for every row:
//
// - All masks are staged in dynamic shared memory once per block (opted in
//   above 48 KB), and |m_g| is computed from them in the prologue: lane g of
//   every warp holds |m_g| in a register.  No companion launch.
// - Several rows per warp: 8 lanes own a row (fewer when the row has fewer
//   than 8 words), so a warp counts 4 rows at once and at 157 words each lane
//   loads 19 or 20 words, none of them padding.  8 lanes read 32 contiguous
//   bytes of a row per load, a whole sector.
// - Each lane keeps per-group sums in registers for a chunk of up to 8 groups
//   (the chunk size is a template argument, so the loops unroll with no
//   per-word guard); the chunk's sums are reduced over the row's lanes with
//   xor shuffles and one lane per group writes the int4 of counts.  For more
//   than 8 groups the row's words are read again for each chunk, from L1/L2.
//   No atomics: the counts are exact and the same on every run.
// - The grid is one wave of resident blocks striding over the rows, so the
//   masks are staged once per block.
//
// Interface: a plain C entry point (bgt_count_codes_narrow) bound with
// ctypes.  It launches on the caller's stream, does not synchronise,
// allocates nothing, and returns the first CUDA error it meets (0 on
// success; cudaErrorInvalidValue for more than 32 groups, or from the
// runtime for masks that do not fit in the card's shared memory).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMaxGroups = 32;
constexpr int kGroupChunk = 8;
constexpr unsigned kFull = 0xffffffffu;

// Counts of groups [g0, g0 + G) for the row this lane's group of `lanes`
// lanes owns.  All 32 lanes of the warp call it (the shuffles need them);
// lanes whose row is past the end pass valid = false.
template <int G>
__device__ __forceinline__ void count_chunk(const uint32_t* __restrict__ a_row,
                                            const uint32_t* __restrict__ b_row,
                                            const uint32_t* sm, int words, int sub,
                                            int lanes, bool valid, unsigned tot,
                                            int g0, int4* __restrict__ out_row) {
  unsigned acc[G][3];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) acc[gi][0] = acc[gi][1] = acc[gi][2] = 0;
  if (valid) {
    const uint32_t* m0 = sm + (size_t)g0 * words;
#pragma unroll 4
    for (int w = sub; w < words; w += lanes) {
      const uint32_t a = __ldg(a_row + w);
      const uint32_t b = __ldg(b_row + w);
      const uint32_t ab = a & b;
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const uint32_t m = m0[gi * words + w];
        acc[gi][0] += __popc(a & m);
        acc[gi][1] += __popc(b & m);
        acc[gi][2] += __popc(ab & m);
      }
    }
  }
  // sum over the row's lanes: a butterfly inside each aligned group of lanes
  for (int o = lanes >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      acc[gi][0] += __shfl_xor_sync(kFull, acc[gi][0], o);
      acc[gi][1] += __shfl_xor_sync(kFull, acc[gi][1], o);
      acc[gi][2] += __shfl_xor_sync(kFull, acc[gi][2], o);
    }
  }
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const int pop = (int)__shfl_sync(kFull, tot, g0 + gi);  // |m_g| from lane g
    if (valid && sub == gi % lanes) {
      const int nb = (int)acc[gi][2];
      const int c1 = (int)acc[gi][0] - nb;
      const int c2 = (int)acc[gi][1] - nb;
      out_row[g0 + gi] = make_int4(pop - c1 - c2 - nb, c1, c2, nb);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
count_narrow_kernel(const uint32_t* __restrict__ p0,
                    const uint32_t* __restrict__ p1,
                    const uint32_t* __restrict__ masks,
                    int4* __restrict__ out,
                    long long row_start, int rows, int words, int groups,
                    int lanes) {
  extern __shared__ uint32_t sm[];  // [groups][words]
  const size_t n = (size_t)groups * words;
  for (size_t i = threadIdx.x; i < n; i += kThreads) sm[i] = __ldg(masks + i);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned tot = 0;  // |m_lane|
  for (int g = 0; g < groups; ++g) {
    unsigned s = 0;
    for (int w = lane; w < words; w += 32) s += __popc(sm[(size_t)g * words + w]);
    s = __reduce_add_sync(kFull, s);
    if (lane == g) tot = s;
  }
  const int sub = lane & (lanes - 1);
  const int rows_per_warp = 32 / lanes;
  const long long rows_per_block = (long long)kWarpsPerBlock * rows_per_warp;
  const long long stride = (long long)gridDim.x * rows_per_block;
  // r0 depends only on the warp, so the whole warp runs every iteration
  for (long long r0 = blockIdx.x * rows_per_block + (long long)warp * rows_per_warp;
       r0 < rows; r0 += stride) {
    const long long r = r0 + lane / lanes;
    const bool valid = r < rows;
    const long long rv = valid ? r : r0;
    const uint32_t* a_row = p0 + (size_t)(row_start + rv) * words;
    const uint32_t* b_row = p1 + (size_t)(row_start + rv) * words;
    int4* out_row = out + (size_t)rv * groups;
    for (int g0 = 0; g0 < groups; g0 += kGroupChunk) {
      switch (groups - g0 < kGroupChunk ? groups - g0 : kGroupChunk) {
#define BGT_CHUNK(G)                                                            \
  case G:                                                                       \
    count_chunk<G>(a_row, b_row, sm, words, sub, lanes, valid, tot, g0, out_row); \
    break;
        BGT_CHUNK(1) BGT_CHUNK(2) BGT_CHUNK(3) BGT_CHUNK(4)
        BGT_CHUNK(5) BGT_CHUNK(6) BGT_CHUNK(7) BGT_CHUNK(8)
#undef BGT_CHUNK
      }
    }
  }
}

}  // namespace

// p0, p1: (n_rows, words) planes; rows [row_start, row_start + rows) are
// counted.  masks: (groups, words), groups <= 32.  out: (rows, groups, 4)
// int32, 16-byte aligned.  stream: a cudaStream_t.  Launches nothing when
// rows or groups is 0.
extern "C" int bgt_count_codes_narrow(const void* p0, const void* p1,
                                      const void* masks, void* out,
                                      long long row_start, int rows, int words,
                                      int groups, void* stream) {
  if (rows <= 0 || groups <= 0) return 0;
  if (groups > kMaxGroups || words < 0) return (int)cudaErrorInvalidValue;
  auto kernel = count_narrow_kernel;
  const size_t smem = (size_t)groups * words * sizeof(uint32_t);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // the opt-in above the default 48 KB, set on every launch (a host-side
  // call); the runtime refuses a size past the card's limit
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  int lanes = 1;  // lanes per row: 8, or the row's width rounded up to a power of 2
  while (lanes < 8 && lanes < words) lanes <<= 1;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows_per_block = (long long)kWarpsPerBlock * (32 / lanes);
  const long long want = ((long long)rows + rows_per_block - 1) / rows_per_block;
  const long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(want < wave ? want : wave);
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(p0), static_cast<const uint32_t*>(p1),
      static_cast<const uint32_t*>(masks), static_cast<int4*>(out), row_start,
      rows, words, groups, lanes);
  return (int)cudaGetLastError();
}

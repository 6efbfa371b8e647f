// Masked-popcount genotype counts on Hopper (sm_90a), on the tensor cores.
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
// What bounds it on this card: the bytes, the planes (2 * rows * words * 4)
// read once plus the counts written once, at 3.35 TB/s; 4.9-5.0 ms on a
// 10^6 x 2,031-word tile at 1-33 groups.  A design on the CUDA cores also
// has to issue the three masked ANDs per word per group, at 64 logic ops per
// clock per SM (132 SMs at 1.98 GHz: 16.7 T/s), which at 33 groups on that
// tile take 12.0 ms; one __popc per word per group per counter, at a quarter
// of that rate, takes four times longer still.
//
// What the design does about it: past two groups the counting leaves the
// CUDA cores.  The sums are binary matrix products, C[r][g] = sum_k
// popc(A[r][k] & B[k][g]), which one instruction computes for a 16-row x
// 256-bit x 8-group tile: mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32
// .and.popc (wgmma has no 1-bit type).  A block owns a 16-row tile; its
// warps walk the words in chunks of 32, and per chunk and per 8 groups a
// warp issues three mma pairs, for p0, p1 and p0 & p1 (one AND per plane
// word, shared by all groups).  The planes are read once for up to
// kMaxOctets * 8 groups, with 128-bit loads where the rows are 16-byte
// aligned.  The accumulators are int32 and exact (at most 32 * words per
// row).  At one group, and at two where the rows take 128-bit loads, the
// logic is far below the bytes, and a warp per row summing with carry-save
// adders on the CUDA cores (count_few_groups_kernel) measured faster than
// the tensor-core path: on an H100 SXM at 700 W, 5.24 against 5.69 ms at
// 1 group on 10^6 x 2,031 words, 0.525 against 0.534 ms at 1 group and
// 0.534 against 0.538 ms at 2 on 100,000 x 2,048 words (chip_smoke.py
// --baseline with this file less the launcher's carry-save branch).
//
// Operand layout.  The sum over k does not depend on which word sits in
// which k slot, as long as the A (plane) and B (mask) fragments agree.  Lane
// (gid = lane / 4, t = lane % 4) loads words [4t, 4t + 4) of a 16-word block
// of rows gid and gid + 8 and of mask gid of the octet; word pair j of
// those four feeds mma j of the block as its k slots t and 4 + t.  So every
// operand comes straight from one 128-bit load, with no shuffles.
//
// Ragged shapes: words past the row and rows past the range load as 0,
// which adds nothing to an AND-popcount; the columns of groups past the
// count (an octet's padding) are counted against mask 0 and dropped; the
// epilogue writes only real rows and groups.  Groups are counted in passes
// of at most kMaxOctets * 8 = 40 per launch (the query engine takes at most
// 32 groups), so the accumulators stay in registers at any group count;
// past 40 groups the planes are read once per pass.  The row offset of a
// range query is a kernel argument.
//
// Interface: a plain C entry point (bgt_count_codes) bound with ctypes.  It
// launches on the caller's stream, does not synchronise, allocates nothing,
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kTileRows = 16;    // rows of one mma A operand
constexpr int kBlockWords = 16;  // words of one 128-bit load per lane group
constexpr int kChunkWords = 32;  // words a warp loads per step
constexpr int kMaxOctets = 5;    // 8 groups per mma; 40 groups per pass
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ void mma_and_popc(int (&c)[4], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Words [w, w + 4) of ``p``; those at or past ``lim`` read as 0.  FULL: all
// four are below lim (no checks); VEC: one 128-bit load (16-byte aligned).
template <bool FULL, bool VEC>
__device__ __forceinline__ uint4 load4(const uint32_t* __restrict__ p, int w,
                                       int lim) {
  if (FULL) {
    if (VEC) return __ldg(reinterpret_cast<const uint4*>(p + w));
    return make_uint4(__ldg(p + w), __ldg(p + w + 1), __ldg(p + w + 2),
                      __ldg(p + w + 3));
  }
  return make_uint4(w < lim ? __ldg(p + w) : 0u,
                    w + 1 < lim ? __ldg(p + w + 1) : 0u,
                    w + 2 < lim ? __ldg(p + w + 2) : 0u,
                    w + 3 < lim ? __ldg(p + w + 3) : 0u);
}

struct Acc {
  int c[3][kMaxOctets][4];
};

// One 32-word chunk of a warp's 16-row tile at word w0, all NT octets.
template <int NT, bool FULL, bool VEC>
__device__ __forceinline__ void count_chunk(
    Acc& acc, const uint32_t* __restrict__ lo0, const uint32_t* __restrict__ hi0,
    const uint32_t* __restrict__ lo1, const uint32_t* __restrict__ hi1,
    const uint32_t* __restrict__ const* mrow, int w0, int lim_lo, int lim_hi,
    int words, int t) {
  uint4 a_lo[2], a_hi[2], b_lo[2], b_hi[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int w = w0 + s * kBlockWords + 4 * t;
    a_lo[s] = load4<FULL, VEC>(lo0, w, lim_lo);
    a_hi[s] = load4<FULL, VEC>(hi0, w, lim_hi);
    b_lo[s] = load4<FULL, VEC>(lo1, w, lim_lo);
    b_hi[s] = load4<FULL, VEC>(hi1, w, lim_hi);
  }
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int w = w0 + s * kBlockWords + 4 * t;
    const uint4 al = a_lo[s], ah = a_hi[s], bl = b_lo[s], bh = b_hi[s];
    const uint4 ql = make_uint4(al.x & bl.x, al.y & bl.y, al.z & bl.z, al.w & bl.w);
    const uint4 qh = make_uint4(ah.x & bh.x, ah.y & bh.y, ah.z & bh.z, ah.w & bh.w);
#pragma unroll
    for (int o = 0; o < NT; ++o) {
      const uint4 m = load4<FULL, VEC>(mrow[o], w, words);
      mma_and_popc(acc.c[0][o], al.x, ah.x, al.y, ah.y, m.x, m.y);
      mma_and_popc(acc.c[0][o], al.z, ah.z, al.w, ah.w, m.z, m.w);
      mma_and_popc(acc.c[1][o], bl.x, bh.x, bl.y, bh.y, m.x, m.y);
      mma_and_popc(acc.c[1][o], bl.z, bh.z, bl.w, bh.w, m.z, m.w);
      mma_and_popc(acc.c[2][o], ql.x, qh.x, ql.y, qh.y, m.x, m.y);
      mma_and_popc(acc.c[2][o], ql.z, qh.z, ql.w, qh.w, m.z, m.w);
    }
  }
}

// NT: octets of groups counted by this launch (groups <= 8 * NT).
//
// One block owns a 16-row tile at a time; its 8 warps split the words, warp
// w taking the 32-word chunks w, w + 8, ..., so at each step the block reads
// one 1 KB run of every row of the tile (a warp alone would read 128 B runs
// of 16 rows 8 KB apart).  The warps' accumulators are then summed in shared
// memory and the epilogue writes the counts.  The kernel is held to 128
// registers, two blocks per SM (a few bytes spill at 32-40 groups); that
// measured faster than one block of more registers at 1-16 and 33 groups
// and 4% slower at 32.
template <int NT, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
count_codes_kernel(const uint32_t* __restrict__ p0,
                   const uint32_t* __restrict__ p1,
                   const uint32_t* __restrict__ masks,
                   const int* __restrict__ mask_pop,
                   int4* __restrict__ out,
                   long long row_start, int rows, int words, int groups,
                   int out_groups) {
  // [counter][octet][fragment register][lane]: conflict-free for a warp
  __shared__ int red[3 * NT * 4 * 32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;  // fragment row (A) and column (B, C)
  const int t = lane & 3;
  // mask row of this lane's group in each octet; a group past the count
  // reads mask 0, and the epilogue drops its column
  const uint32_t* mrow[NT];
#pragma unroll
  for (int o = 0; o < NT; ++o) {
    const int g = o * 8 + gid;
    mrow[o] = masks + (size_t)(g < groups ? g : 0) * words;
  }
  const long long n_tiles = ((long long)rows + kTileRows - 1) / kTileRows;
  constexpr int kStride = kWarpsPerBlock * kChunkWords;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long r_lo = tile * kTileRows + gid;  // within the range
    const long long r_hi = r_lo + 8;
    const int lim_lo = r_lo < rows ? words : 0;
    const int lim_hi = r_hi < rows ? words : 0;
    // rows past the range point at the range's first row and load nothing
    const size_t off_lo = (size_t)(row_start + (r_lo < rows ? r_lo : 0)) * words;
    const size_t off_hi = (size_t)(row_start + (r_hi < rows ? r_hi : 0)) * words;
    const uint32_t* lo0 = p0 + off_lo;
    const uint32_t* hi0 = p0 + off_hi;
    const uint32_t* lo1 = p1 + off_lo;
    const uint32_t* hi1 = p1 + off_hi;

    Acc acc;
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int o = 0; o < NT; ++o)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc.c[k][o][i] = 0;

    // whole chunks of a full tile need no checks; a ragged tile's rows past
    // the range and the row's last partial chunk load through the checks
    const bool full_tile = (tile + 1) * kTileRows <= rows;
    int w0 = warp * kChunkWords;
    if (full_tile) {
      for (; w0 + kChunkWords <= words; w0 += kStride)
        count_chunk<NT, true, VEC>(acc, lo0, hi0, lo1, hi1, mrow, w0, lim_lo,
                                   lim_hi, words, t);
    }
    for (; w0 < words; w0 += kStride)
      count_chunk<NT, false, false>(acc, lo0, hi0, lo1, hi1, mrow, w0, lim_lo,
                                    lim_hi, words, t);

    __syncthreads();  // the previous tile's epilogue has read red
    if (warp == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int o = 0; o < NT; ++o)
#pragma unroll
          for (int i = 0; i < 4; ++i) red[((k * NT + o) * 4 + i) * 32 + lane] = acc.c[k][o][i];
    }
    __syncthreads();
    if (warp != 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int o = 0; o < NT; ++o)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            atomicAdd(&red[((k * NT + o) * 4 + i) * 32 + lane], acc.c[k][o][i]);
    }
    __syncthreads();

    // C fragment: register 0, 1 are row gid, groups 2t, 2t + 1 of the
    // octet; registers 2, 3 the same groups of row gid + 8.  Warp o writes
    // octet o.
    for (int o = warp; o < NT; o += kWarpsPerBlock) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long r = i < 2 ? r_lo : r_hi;
        const int g = o * 8 + 2 * t + (i & 1);
        if (r < rows && g < groups) {
          const int n10 = red[((0 * NT + o) * 4 + i) * 32 + lane];
          const int n11 = red[((1 * NT + o) * 4 + i) * 32 + lane];
          const int nb = red[((2 * NT + o) * 4 + i) * 32 + lane];
          const int c1 = n10 - nb;
          const int c2 = n11 - nb;
          out[(size_t)r * out_groups + g] =
              make_int4(__ldg(mask_pop + g) - c1 - c2 - nb, c1, c2, nb);
        }
      }
    }
  }
}

// Harley-Seal carry-save adder: h:l = a + b + c, bit by bit.
__device__ __forceinline__ void csa(uint32_t& h, uint32_t& l, uint32_t a,
                                    uint32_t b, uint32_t c) {
  const uint32_t u = a ^ b;
  h = (a & b) | (u & c);
  l = u ^ c;
}

// The set bits of 16 words, with 5 __popc instead of 16.
__device__ __forceinline__ unsigned popc16(const uint32_t (&v)[16]) {
  uint32_t ones = 0, twos = 0, fours = 0, eights = 0, sixteens;
  uint32_t t0, t1, f0, f1, e0, e1;
  csa(t0, ones, ones, v[0], v[1]);
  csa(t1, ones, ones, v[2], v[3]);
  csa(f0, twos, twos, t0, t1);
  csa(t0, ones, ones, v[4], v[5]);
  csa(t1, ones, ones, v[6], v[7]);
  csa(f1, twos, twos, t0, t1);
  csa(e0, fours, fours, f0, f1);
  csa(t0, ones, ones, v[8], v[9]);
  csa(t1, ones, ones, v[10], v[11]);
  csa(f0, twos, twos, t0, t1);
  csa(t0, ones, ones, v[12], v[13]);
  csa(t1, ones, ones, v[14], v[15]);
  csa(f1, twos, twos, t0, t1);
  csa(e1, fours, fours, f0, f1);
  csa(sixteens, eights, eights, e0, e1);
  return 16u * __popc(sixteens) + 8u * __popc(eights) + 4u * __popc(fours) +
         2u * __popc(twos) + __popc(ones);
}

// G <= 2 groups, the bytes-bound case: on the CUDA cores, one warp per row.
// Each lane loads 16 words of each plane per 512-word step (four 128-bit
// loads each, coalesced across the warp), then per group ANDs them with the
// mask and sums each counter with carry-save adders, so the popcount pipe
// issues 5 __popc per 16 words per counter and the loads set the pace.
// Words past the row load as 0.
template <int G, bool VEC>
__global__ void __launch_bounds__(kThreads)
count_few_groups_kernel(const uint32_t* __restrict__ p0,
                        const uint32_t* __restrict__ p1,
                        const uint32_t* __restrict__ masks,
                        const int* __restrict__ mask_pop,
                        int4* __restrict__ out, long long row_start, int rows,
                        int words) {
  constexpr int kStep = 512;
  const int lane = threadIdx.x & 31;
  const long long n_warps = (long long)gridDim.x * kWarpsPerBlock;
  for (long long r = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       r < rows; r += n_warps) {
    const uint32_t* a_row = p0 + (size_t)(row_start + r) * words;
    const uint32_t* b_row = p1 + (size_t)(row_start + r) * words;
    unsigned n[G][3] = {};
    for (int w0 = 0; w0 < words; w0 += kStep) {
      const bool full = w0 + kStep <= words;
      uint4 a[4], b[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int w = w0 + k * 128 + 4 * lane;
        a[k] = full ? load4<true, VEC>(a_row, w, words)
                    : load4<false, false>(a_row, w, words);
        b[k] = full ? load4<true, VEC>(b_row, w, words)
                    : load4<false, false>(b_row, w, words);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const uint32_t* mask = masks + (size_t)g * words;
        uint32_t x[16], y[16], z[16];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int w = w0 + k * 128 + 4 * lane;
          const uint4 m = full ? load4<true, VEC>(mask, w, words)
                               : load4<false, false>(mask, w, words);
          const uint32_t av[4] = {a[k].x, a[k].y, a[k].z, a[k].w};
          const uint32_t bv[4] = {b[k].x, b[k].y, b[k].z, b[k].w};
          const uint32_t mv[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            x[4 * k + j] = av[j] & mv[j];
            y[4 * k + j] = bv[j] & mv[j];
            z[4 * k + j] = x[4 * k + j] & bv[j];
          }
        }
        n[g][0] += popc16(x);
        n[g][1] += popc16(y);
        n[g][2] += popc16(z);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int n10 = (int)__reduce_add_sync(kFull, n[g][0]);
      const int n11 = (int)__reduce_add_sync(kFull, n[g][1]);
      const int nb = (int)__reduce_add_sync(kFull, n[g][2]);
      if (lane == 0)
        out[(size_t)r * G + g] = make_int4(__ldg(mask_pop + g) - n10 - n11 + nb,
                                           n10 - nb, n11 - nb, nb);
    }
  }
}

template <int NT>
cudaError_t launch_pass(bool vec, int blocks, cudaStream_t s,
                        const uint32_t* p0, const uint32_t* p1,
                        const uint32_t* masks, const int* mask_pop, int4* out,
                        long long row_start, int rows, int words, int groups,
                        int out_groups) {
  if (vec)
    count_codes_kernel<NT, true><<<blocks, kThreads, 0, s>>>(
        p0, p1, masks, mask_pop, out, row_start, rows, words, groups, out_groups);
  else
    count_codes_kernel<NT, false><<<blocks, kThreads, 0, s>>>(
        p0, p1, masks, mask_pop, out, row_start, rows, words, groups, out_groups);
  return cudaGetLastError();
}

}  // namespace

// p0, p1: (n_rows, words) planes; rows [row_start, row_start + rows) are
// counted.  masks: (groups, words).  mask_pop: (groups,) int32 scratch.
// out: (rows, groups, 4) int32, 16-byte aligned.  stream: a cudaStream_t.
extern "C" int bgt_count_codes(const void* p0, const void* p1, const void* masks,
                               void* mask_pop, void* out, long long row_start,
                               int rows, int words, int groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* a = static_cast<const uint32_t*>(p0);
  const uint32_t* b = static_cast<const uint32_t*>(p1);
  const uint32_t* m = static_cast<const uint32_t*>(masks);
  int* pop = static_cast<int*>(mask_pop);
  mask_popcount_kernel<<<groups, kThreads, 0, s>>>(m, words, pop);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // 128-bit loads need 16-byte aligned rows
  const bool vec = words % 4 == 0 && ((uintptr_t)a | (uintptr_t)b | (uintptr_t)m) % 16 == 0;
  // one group at any width, two at widths that take 128-bit loads: the
  // carry-save path (measured faster there than the tensor-core path)
  if (groups == 1 || (groups == 2 && vec)) {
    const long long want = ((long long)rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    const int blocks = (int)(want < (1 << 20) ? want : (1 << 20));
    int4* o = static_cast<int4*>(out);
    if (groups == 1 && vec)
      count_few_groups_kernel<1, true><<<blocks, kThreads, 0, s>>>(a, b, m, pop, o, row_start, rows, words);
    else if (groups == 1)
      count_few_groups_kernel<1, false><<<blocks, kThreads, 0, s>>>(a, b, m, pop, o, row_start, rows, words);
    else
      count_few_groups_kernel<2, true><<<blocks, kThreads, 0, s>>>(a, b, m, pop, o, row_start, rows, words);
    return (int)cudaGetLastError();
  }
  const long long tiles = ((long long)rows + kTileRows - 1) / kTileRows;
  const int blocks = (int)(tiles < (1 << 20) ? tiles : (1 << 20));
  constexpr int kPass = kMaxOctets * 8;
  for (int g0 = 0; g0 < groups; g0 += kPass) {
    const int gn = groups - g0 < kPass ? groups - g0 : kPass;
    const uint32_t* mg = m + (size_t)g0 * words;
    int4* og = static_cast<int4*>(out) + g0;
    switch ((gn + 7) / 8) {
      case 1: err = launch_pass<1>(vec, blocks, s, a, b, mg, pop + g0, og, row_start, rows, words, gn, groups); break;
      case 2: err = launch_pass<2>(vec, blocks, s, a, b, mg, pop + g0, og, row_start, rows, words, gn, groups); break;
      case 3: err = launch_pass<3>(vec, blocks, s, a, b, mg, pop + g0, og, row_start, rows, words, gn, groups); break;
      case 4: err = launch_pass<4>(vec, blocks, s, a, b, mg, pop + g0, og, row_start, rows, words, gn, groups); break;
      default: err = launch_pass<5>(vec, blocks, s, a, b, mg, pop + g0, og, row_start, rows, words, gn, groups); break;
    }
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

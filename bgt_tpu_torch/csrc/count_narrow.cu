// Masked-popcount genotype counts at narrow row widths on Hopper (sm_90a),
// on the binary tensor cores.
//
// Replaces docs/experiments/pallas_count.py:29 _count_kernel, launched by
// count_codes_pallas (the narrow-width Pallas experiment).  It computes the
// final (rows, groups, 4) int32 counts with the affine step inside the
// kernel:
//
//     n10 = sum popc(p0 & m_g)   n11 = sum popc(p1 & m_g)   nb = sum popc(p0 & p1 & m_g)
//     cnt0 = |m_g| - cnt1 - cnt2 - cnt3, cnt1 = n10 - nb, cnt2 = n11 - nb, cnt3 = nb
//
// for at most 32 groups (the TPU kernel's limit) whose masks fit in shared
// memory together: groups * words * 4 bytes <= the card's opt-in limit
// (227 KB on an H100: 32 groups up to 1,816 words).
//
// What bounds it on this card: the bytes.  Both planes are read once and the
// counts written once: at 105,730 x 157 words, 133 MB of planes and, at 32
// groups, 54 MB of counts, 0.056 ms at 3.35 TB/s.  The counting runs on the
// binary tensor cores, three mma per (16 rows, 8 words, 8 groups): 1.6 M at
// that shape and 32 groups, far below the bytes.
//
// What the design does about it, limit by limit, and why it is not kernel
// A's (count_codes.cu) at narrow widths:
// - The popcount pipe.  The sums are binary matrix products, C[r][g] =
//   sum_k popc(A[r][k] & B[k][g]), which one instruction computes for a
//   16-row x 256-bit x 8-group tile: mma.sync.aligned.m16n8k256.row.col.s32
//   .b1.b1.s32.and.popc (wgmma has no 1-bit type).  Per k-step of 8 words a
//   warp issues three per octet of groups, for p0, p1 and p0 & p1 (one AND
//   per word, shared by all groups), and no __popc.
// - Re-reads.  One warp owns a whole 16-row tile across all its words and
//   counts every octet in the same pass, so a row is read once at any
//   g <= 32; the accumulators (3 counters x 4 octets x 4 registers) stay in
//   registers.  Kernel A splits a tile's words among 8 warps in 32-word
//   chunks: at 157 words three warps idle and a fifth is ragged.
// - Butterflies and barriers.  With a whole tile per warp there is no
//   cross-warp or cross-lane sum: no shuffle, no __syncthreads and no
//   shared-memory atomic on the main loop (kernel A ends each tile in three
//   __syncthreads and atomics).  The affine step runs in registers on the
//   mma's C fragment: lane (gid = lane / 4, t = lane % 4) holds rows gid and
//   gid + 8, groups 2t and 2t + 1 of each octet, and writes each as an int4,
//   so the four lanes of a row write 128 contiguous bytes per octet.
// - Bytes in flight.  A 157-word row is 628 bytes: no 128-bit lane load
//   (kernel A's rows then take scalar loads) and no 2-D TMA map (its global
//   stride must be a multiple of 16 bytes).  But a 16-row tile of a plane is
//   one contiguous run of 64 * words bytes, a multiple of 16, so a 1-D bulk
//   copy (cp.async.bulk ... mbarrier::complete_tx::bytes) brings it into
//   shared memory.  Each warp keeps its own ring of `stages` tiles (2 to 8,
//   as many as shared memory holds beside the masks for 4 warps, one per SM
//   sub-partition): it waits on a tile's mbarrier, counts it, and issues the
//   copy of the tile `stages` ahead into the slot it freed, so every warp has
//   a tile in flight while it counts.  The copies start before the masks are
//   staged.  Tiles start 16-byte aligned from the first row `head` where both
//   planes are; the head rows and the ragged last tile load straight from
//   global memory.  A producer warp filling one 10-slot ring per block for 4
//   consuming warps (full and empty mbarriers) measured 0.0576 / 0.0615 /
//   0.0776 ms at 1 / 8 / 32 groups on 105,730 x 157 words, against 0.0551 /
//   0.0595 / 0.0789 ms for these per-warp rings (H100 SXM at 700 W, in turns,
//   chip_smoke.py phase 7 with the variant as a --baseline).
// - Masks.  They are staged once per persistent block (one wave of blocks
//   strides over the tiles) in the order the B fragments are read,
//   [k-step][group][8 words], so a warp's 64-bit fragment load reads 256
//   contiguous bytes with no bank conflict, with no padding (the words of a
//   last, partial k-step sit after them as [group][words % 8]).  Each thread
//   loads 8 mask words at once (one at a time measured 0.0876 against
//   0.0789 ms at 32 groups, the same card and turns).  |m_g| comes
//   from the same products with all-ones rows, in the prologue, already in
//   the C fragment's layout: no companion launch (kernel A runs one).
//
// Operand layout.  The sum over k does not depend on which word sits in
// which k slot, as long as the A (plane) and B (mask) fragments agree.  Lane
// (gid, t) gives words 8s + 2t and 8s + 2t + 1 of k-step s to k slots t and
// 4 + t: of rows gid and gid + 8 for A, of group gid of the octet for B.
//
// Shapes.  Groups past the count in the last octet count against a zero
// mask and are not written; the words of the last, partial k-step past the
// row count against a zero mask; rows past the range point at a real row and
// are not written.  The counts are int32 and exact, the same on every run.
// When shared memory cannot hold the masks and two tiles of one warp (past
// 605 words at 32 groups, 893 at 1), or the planes have no 16-byte aligned
// tile start, the same tensor-core kernel runs with its A fragments loaded
// straight from global memory (the RING = false instantiation).
//
// Interface: a plain C entry point (bgt_count_codes_narrow) bound with
// ctypes.  It launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() (cudaErrorInvalidValue
// for more than 32 groups; the runtime's error for masks that do not fit in
// the card's shared memory).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 16;   // rows of one mma A operand
constexpr int kStepWords = 8;   // words of one mma k-step (256 bits)
constexpr int kMaxGroups = 32;
constexpr int kRingWarps = 4;   // warps of a block on the ring path
constexpr int kDirectWarps = 8; // warps of a block loading from global memory
constexpr int kMaxStages = 8;   // tiles in a warp's ring
constexpr int kStageLoads = 8;  // mask words a thread loads at once

__device__ __forceinline__ void mma_and_popc(int (&c)[4], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// One 16-row tile of both planes into `slot` (p0's rows, then p1's), one
// bulk copy each, completing on `bar`.  Called by one lane.
__device__ __forceinline__ void load_tile(uint32_t* slot, uint64_t* bar,
                                          const uint32_t* a, const uint32_t* b,
                                          uint32_t bytes) {
  const uint32_t mb = smem_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(mb), "r"(2 * bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(slot)), "l"(a), "r"(bytes), "r"(mb) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(slot + bytes / 4)), "l"(b), "r"(bytes), "r"(mb)
      : "memory");
}

template <bool GLOBAL>
__device__ __forceinline__ uint32_t ld(const uint32_t* p) {
  if (GLOBAL) return __ldg(p);
  return *p;
}

// Rows gid and gid + 8 of a tile of p0 and p1, in shared or global memory.
struct Rows {
  const uint32_t* lo0;
  const uint32_t* hi0;
  const uint32_t* lo1;
  const uint32_t* hi1;
};

// The staged masks: k-step s of group g at main[(s * groups + g) * 8], the
// last partial k-step's words % 8 words of group g at tail[g * (words % 8)].
struct Masks {
  const uint32_t* main;
  const uint32_t* tail;
  int steps;   // whole k-steps: words / 8
  int rest;    // words % 8
  int groups;
};

// B fragment (k slots t and 4 + t) of group g at whole k-step s; 0 past
// the groups.
__device__ __forceinline__ uint2 mask_pair(const Masks& m, int s, int g,
                                           int t) {
  const bool real = g < m.groups;
  const uint2 v = *reinterpret_cast<const uint2*>(
      m.main + ((size_t)s * m.groups + (real ? g : 0)) * kStepWords + 2 * t);
  return real ? v : make_uint2(0u, 0u);
}

// The same at the last, partial k-step: words past the row are 0.
__device__ __forceinline__ uint2 mask_pair_rest(const Masks& m, int g, int t) {
  const bool x = g < m.groups && 2 * t < m.rest;
  const bool y = g < m.groups && 2 * t + 1 < m.rest;
  const uint32_t* row = m.tail + (size_t)(g < m.groups ? g : 0) * m.rest;
  return make_uint2(x ? row[2 * t] : 0u, y ? row[2 * t + 1] : 0u);
}

// n10, n11, nb of rows gid and gid + 8 of one tile for NO octets of groups:
// acc[counter][octet] is the C fragment of that counter and octet.
template <int NO, bool GLOBAL>
__device__ __forceinline__ void count_tile(int (&acc)[3][NO][4], const Rows& p,
                                           const Masks& m, int gid, int t) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int o = 0; o < NO; ++o)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[k][o][i] = 0;
#pragma unroll 2
  for (int s = 0; s < m.steps; ++s) {
    const int w = s * kStepWords + 2 * t;
    const uint32_t a0 = ld<GLOBAL>(p.lo0 + w), a2 = ld<GLOBAL>(p.lo0 + w + 1);
    const uint32_t a1 = ld<GLOBAL>(p.hi0 + w), a3 = ld<GLOBAL>(p.hi0 + w + 1);
    const uint32_t b0 = ld<GLOBAL>(p.lo1 + w), b2 = ld<GLOBAL>(p.lo1 + w + 1);
    const uint32_t b1 = ld<GLOBAL>(p.hi1 + w), b3 = ld<GLOBAL>(p.hi1 + w + 1);
    const uint32_t q0 = a0 & b0, q1 = a1 & b1, q2 = a2 & b2, q3 = a3 & b3;
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      const uint2 mk = mask_pair(m, s, o * 8 + gid, t);
      mma_and_popc(acc[0][o], a0, a1, a2, a3, mk.x, mk.y);
      mma_and_popc(acc[1][o], b0, b1, b2, b3, mk.x, mk.y);
      mma_and_popc(acc[2][o], q0, q1, q2, q3, mk.x, mk.y);
    }
  }
  if (m.rest > 0) {  // the last, partial k-step; its words past the row are 0
    const int w = m.steps * kStepWords + 2 * t;
    const bool x = 2 * t < m.rest, y = 2 * t + 1 < m.rest;
    const uint32_t a0 = x ? ld<GLOBAL>(p.lo0 + w) : 0u;
    const uint32_t a2 = y ? ld<GLOBAL>(p.lo0 + w + 1) : 0u;
    const uint32_t a1 = x ? ld<GLOBAL>(p.hi0 + w) : 0u;
    const uint32_t a3 = y ? ld<GLOBAL>(p.hi0 + w + 1) : 0u;
    const uint32_t b0 = x ? ld<GLOBAL>(p.lo1 + w) : 0u;
    const uint32_t b2 = y ? ld<GLOBAL>(p.lo1 + w + 1) : 0u;
    const uint32_t b1 = x ? ld<GLOBAL>(p.hi1 + w) : 0u;
    const uint32_t b3 = y ? ld<GLOBAL>(p.hi1 + w + 1) : 0u;
    const uint32_t q0 = a0 & b0, q1 = a1 & b1, q2 = a2 & b2, q3 = a3 & b3;
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      const uint2 mk = mask_pair_rest(m, o * 8 + gid, t);
      mma_and_popc(acc[0][o], a0, a1, a2, a3, mk.x, mk.y);
      mma_and_popc(acc[1][o], b0, b1, b2, b3, mk.x, mk.y);
      mma_and_popc(acc[2][o], q0, q1, q2, q3, mk.x, mk.y);
    }
  }
}

// |m_g| for the groups 8o + 2t and 8o + 2t + 1 this lane writes: the same
// products with all-ones A rows, read from the C fragment's row gid.
template <int NO>
__device__ __forceinline__ void mask_pops(int (&pop)[NO][2], const Masks& m,
                                          int gid, int t) {
  int c[NO][4];
#pragma unroll
  for (int o = 0; o < NO; ++o)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[o][i] = 0;
  for (int s = 0; s < m.steps; ++s) {
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      const uint2 mk = mask_pair(m, s, o * 8 + gid, t);
      mma_and_popc(c[o], ~0u, ~0u, ~0u, ~0u, mk.x, mk.y);
    }
  }
  if (m.rest > 0) {
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      const uint2 mk = mask_pair_rest(m, o * 8 + gid, t);
      mma_and_popc(c[o], ~0u, ~0u, ~0u, ~0u, mk.x, mk.y);
    }
  }
#pragma unroll
  for (int o = 0; o < NO; ++o) {
    pop[o][0] = c[o][0];
    pop[o][1] = c[o][1];
  }
}

// The affine step on the C fragments, and the int4 of counts of each real
// (row, group) this lane holds: rows r_lo and r_lo + 8 below r_end.
template <int NO>
__device__ __forceinline__ void write_counts(int4* __restrict__ out,
                                             const int (&acc)[3][NO][4],
                                             const int (&pop)[NO][2],
                                             long long r_lo, long long r_end,
                                             int groups, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long r = r_lo + 8 * h;
    if (r >= r_end) continue;
    int4* row = out + (size_t)r * groups;
#pragma unroll
    for (int o = 0; o < NO; ++o) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int g = o * 8 + 2 * t + e;
        const int i = 2 * h + e;
        if (g < groups) {
          const int nb = acc[2][o][i];
          const int c1 = acc[0][o][i] - nb;
          const int c2 = acc[1][o][i] - nb;
          row[g] = make_int4(pop[o][e] - c1 - c2 - nb, c1, c2, nb);
        }
      }
    }
  }
}

// NO: octets of groups (groups <= 8 * NO).  RING: the whole tiles from row
// `head` on come through each warp's ring of `stages` slots; the head rows
// and the ragged last tile (and, without the ring, every tile) load from
// global memory.
//
// Dynamic shared memory: [the ring: warps x stages slots of a tile of both
// planes][the masks, rounded up to 16 bytes][one mbarrier per slot].
template <int NO, bool RING>
__global__ void __launch_bounds__(kDirectWarps * 32, 1)
count_narrow_kernel(const uint32_t* __restrict__ p0,
                    const uint32_t* __restrict__ p1,
                    const uint32_t* __restrict__ masks,
                    int4* __restrict__ out,
                    long long row_start, int rows, int words, int groups,
                    int head, int stages) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int n_warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int t = lane & 3;
  const int tile_words = kTileRows * words;  // one plane's tile
  const size_t ring_words = RING ? (size_t)n_warps * stages * 2 * tile_words : 0;
  uint32_t* sm_main = sm + ring_words;
  const Masks m{sm_main, sm_main + (size_t)(words / kStepWords) * groups * kStepWords,
                words / kStepWords, words % kStepWords, groups};
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      sm_main + ((size_t)groups * words + 3) / 4 * 4);

  const long long gw = (long long)blockIdx.x * n_warps + warp;
  const long long nw = (long long)gridDim.x * n_warps;
  const long long n_ring = RING ? (rows - head) / kTileRows : 0;
  uint32_t* slots = sm + (size_t)warp * stages * 2 * tile_words;
  uint64_t* my_bars = bars + warp * stages;
  const uint32_t tile_bytes = (uint32_t)tile_words * 4;
  auto plane_off = [&](long long tile) {
    return (size_t)(row_start + head + tile * kTileRows) * words;
  };

  if (RING) {  // the first `stages` tiles of this warp, before the masks
    if (lane == 0) {
      for (int k = 0; k < stages; ++k)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                     :: "r"(smem_addr(my_bars + k)) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      for (int k = 0; k < stages; ++k) {
        const long long tile = gw + k * nw;
        if (tile < n_ring)
          load_tile(slots + (size_t)k * 2 * tile_words, my_bars + k,
                    p0 + plane_off(tile), p1 + plane_off(tile), tile_bytes);
      }
    }
    __syncwarp();
  }

  // the masks, once per block, in B-fragment order; kStageLoads loads in
  // flight per thread
  const int steps_words = m.steps * kStepWords;
  const int n_mask = groups * words;
  for (int i0 = threadIdx.x; i0 < n_mask; i0 += kStageLoads * blockDim.x) {
    uint32_t v[kStageLoads];
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int i = i0 + u * blockDim.x;
      v[u] = i < n_mask ? __ldg(masks + i) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i >= n_mask) break;
      const int g = i / words;
      const int w = i - g * words;
      if (w < steps_words)
        sm_main[((w / kStepWords) * groups + g) * kStepWords + w % kStepWords] = v[u];
      else
        sm_main[(size_t)steps_words * groups + g * m.rest + (w - steps_words)] = v[u];
    }
  }
  __syncthreads();

  int pop[NO][2];
  mask_pops<NO>(pop, m, gid, t);
  int acc[3][NO][4];

  for (long long j = 0;; ++j) {  // this warp's whole tiles, through its ring
    const long long tile = gw + j * nw;
    if (tile >= n_ring) break;
    const int k = (int)(j % stages);
    uint32_t* slot = slots + (size_t)k * 2 * tile_words;
    bar_wait(my_bars + k, (uint32_t)(j / stages) & 1u);
    const Rows p{slot + gid * words, slot + (gid + 8) * words,
                 slot + tile_words + gid * words,
                 slot + tile_words + (gid + 8) * words};
    count_tile<NO, false>(acc, p, m, gid, t);
    __syncwarp();  // every lane has read the slot
    const long long next = tile + (long long)stages * nw;
    if (lane == 0 && next < n_ring) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      load_tile(slot, my_bars + k, p0 + plane_off(next), p1 + plane_off(next),
                tile_bytes);
    }
    const long long r0 = head + tile * kTileRows;
    write_counts<NO>(out, acc, pop, r0 + gid, r0 + kTileRows, groups, t);
  }

  // rows [r0, r_end), at most 16, straight from global memory; rows past
  // r_end point at row r0 and are not written
  auto direct = [&](long long r0, long long r_end) {
    const long long lo = r0 + gid < r_end ? r0 + gid : r0;
    const long long hi = r0 + gid + 8 < r_end ? r0 + gid + 8 : r0;
    const size_t off_lo = (size_t)(row_start + lo) * words;
    const size_t off_hi = (size_t)(row_start + hi) * words;
    const Rows p{p0 + off_lo, p0 + off_hi, p1 + off_lo, p1 + off_hi};
    count_tile<NO, true>(acc, p, m, gid, t);
    write_counts<NO>(out, acc, pop, r0 + gid, r_end, groups, t);
  };
  if (RING) {
    const long long tail = head + n_ring * kTileRows;
    if (head > 0 && gw == nw - 1) direct(0, head);
    if (tail < rows && gw == (nw > 1 ? nw - 2 : 0)) direct(tail, rows);
  } else {
    for (long long r0 = gw * kTileRows; r0 < rows; r0 += nw * kTileRows)
      direct(r0, r0 + kTileRows < rows ? r0 + kTileRows : rows);
  }
}

template <int NO>
cudaError_t launch(bool ring, int sms, int warps, size_t smem, cudaStream_t s,
                   const uint32_t* p0, const uint32_t* p1, const uint32_t* masks,
                   int4* out, long long row_start, int rows, int words,
                   int groups, int head, int stages) {
  void (*kernel)(const uint32_t*, const uint32_t*, const uint32_t*, int4*,
                 long long, int, int, int, int, int) =
      ring ? count_narrow_kernel<NO, true> : count_narrow_kernel<NO, false>;
  // the opt-in above the default 48 KB, set on every launch (a host-side
  // call); the runtime refuses a size past the card's limit
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        warps * 32, smem);
  if (err != cudaSuccess) return err;
  // one wave of blocks, no more than the tiles need
  const long long tiles = ring ? (rows - head) / kTileRows
                               : ((long long)rows + kTileRows - 1) / kTileRows;
  const long long want = (tiles + warps - 1) / warps;
  const long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(want < wave ? (want > 0 ? want : 1) : wave);
  kernel<<<blocks, warps * 32, smem, s>>>(p0, p1, masks, out, row_start, rows,
                                          words, groups, head, stages);
  return cudaGetLastError();
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
  int dev = 0, sms = 0, avail = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&avail, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;

  const size_t mask_bytes = (size_t)groups * words * 4;
  const size_t mask_room = (mask_bytes + 15) / 16 * 16;
  // one ring slot: a 16-row tile of both planes, and its mbarrier
  const size_t slot_bytes = 2 * (size_t)kTileRows * words * 4 + 8;
  // the first row from which every 16-row tile of both planes starts on a
  // 16-byte boundary (a tile is 64 * words bytes), if there is one
  int head = -1;
  for (int h = 0; words > 0 && h < kTileRows && head < 0; ++h) {
    const uintptr_t off = (uintptr_t)((row_start + h) * words) * 4;
    if (((uintptr_t)p0 + off) % 16 == 0 && ((uintptr_t)p1 + off) % 16 == 0)
      head = h;
  }
  int warps = 0, stages = 0;
  if (head >= 0 && rows - head >= kTileRows && (size_t)avail > mask_room) {
    const size_t room = (size_t)avail - mask_room;
    const size_t w = room / (2 * slot_bytes);
    warps = (int)(w < kRingWarps ? w : kRingWarps);
    if (warps > 0) {
      const size_t st = room / (warps * slot_bytes);
      stages = (int)(st < kMaxStages ? st : kMaxStages);
    }
  }
  const bool ring = warps > 0;
  const size_t smem = ring ? warps * stages * slot_bytes + mask_room : mask_bytes;
  if (!ring) {
    warps = kDirectWarps;
    head = 0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* a = static_cast<const uint32_t*>(p0);
  const uint32_t* b = static_cast<const uint32_t*>(p1);
  const uint32_t* m = static_cast<const uint32_t*>(masks);
  int4* o = static_cast<int4*>(out);
  switch ((groups + 7) / 8) {
    case 1: err = launch<1>(ring, sms, warps, smem, s, a, b, m, o, row_start, rows, words, groups, head, stages); break;
    case 2: err = launch<2>(ring, sms, warps, smem, s, a, b, m, o, row_start, rows, words, groups, head, stages); break;
    case 3: err = launch<3>(ring, sms, warps, smem, s, a, b, m, o, row_start, rows, words, groups, head, stages); break;
    default: err = launch<4>(ring, sms, warps, smem, s, a, b, m, o, row_start, rows, words, groups, head, stages); break;
  }
  return (int)err;
}

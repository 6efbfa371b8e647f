// The PBWT decode scan on Hopper (sm_90a): kernel D.
//
// Replaces bgt_tpu/ops/decode.py:63 decode_block, which is not a Pallas
// kernel but an XLA lax.scan over the rows of one PBWT checkpoint block.
// For each row, from the permutation S before it and the row's byte-runs
// (length, bit), it computes
//
//     starts = exclusive_cumsum(run lengths)
//     y[i]   = bit of rank i (transitions scattered at the run starts, then
//              a running sum)
//     a[S[i]] = y[i]                     the row in original column order
//     S'     = stable partition of S by y (zeros first)
//
// and writes a as one (m,) uint8 row of the output; S' is the next row's S.
//
// The inverse form.  The kernel carries not S but its inverse P = S^-1, the
// rank of each haplotype.  The stable partition puts S[i] at dest(i), so
// P'[S[i]] = dest(P[S[i]]), and a row becomes local to each haplotype h:
//
//     a[h]  = y[P[h]]                                  a gather, no scatter
//     P'[h] = y[P[h]] ? n0 + ones_before(P[h]) : P[h] - ones_before(P[h])
//
// with ones_before(p) the ones in y[0:p) and n0 the zeros of the row.  A
// step on h reads only P[h] and the row's y and ones_before (m/32 words
// each), so the haplotypes of a scan split into slices that never talk.
//
// What bounds it on this card: not device memory.  The bytes it must move
// (the runs read once, S0 and the final S, one output byte per haplotype per
// row) take ~4 ms for the 13 GB of a 100,000-row x 64,976-haplotype cohort
// at 3.35 TB/s.  Within a scan the rows are sequential, and each costs every
// block of the scan the whole row's y (m/32 words, the row's runs, five
// block-wide barriers) plus one step per haplotype of its slice.
//
// What the design does about it:
// - the grid is scans x C blocks: block (k, c) owns haplotypes
//   [c L, min(m, (c + 1) L)) of scan k, with L a multiple of 16 and
//   C = ceil(m / L).  C fills the card's SMs at the occupancy the kernel
//   gets (bgt_pbwt_decode_plan reads the SM count and asks the occupancy
//   API), or is the caller's; a batch of more scans than SMs takes the
//   least C whose slice fits in shared memory;
// - a block's slice of P lives in shared memory for the whole scan and is
//   updated in place: 16-bit ranks when m <= 65,536 (HRC's 64,976
//   haplotypes fit whole in one block), else 32-bit.  The block sets it
//   from S0 (P[S0[i] - lo] = i) and writes the final S from it
//   (S_final[P[h]] = h): one scatter of each per scan, none per row, and
//   each S_final entry is written by exactly one block;
// - y lives in shared memory as a bitmap, each 32-bit word beside the count
//   of ones before it, and every block builds the whole row: the runs are
//   turned into transition bits in a bitmap of their own (a run whose bit
//   differs from the previous run's, with a nonzero length and a start in
//   [0, m), flips its start bit with atomicXor), and y is their prefix XOR,
//   inside a word by shifts, across words by a block scan of the words'
//   parities; a second block scan of the words' popcounts gives the ones
//   before each word.  12 bytes a word: 24 KB at HRC width.  Long runs cost
//   one byte-run each and never loop over their bits; zero-length padding
//   runs and starts at or past m touch nothing.  The transition words are
//   zeroed as y is made from them, so no barrier closes a row;
// - the slice pass: a thread takes 16 bytes of ranks (8 haplotypes of 16
//   bits, or 4 of 32), reads one 8-byte y entry and does one __popc for
//   each, writes the ranks back and stores its output bytes as one 8- or
//   4-byte store.  A row of the output is contiguous, so a block's slice of
//   a row is one coalesced span (byte stores where the row's start is not
//   aligned to the store);
// - the next row's run offsets and its first kThreads runs are loaded into
//   registers while the current row runs, so a row does not start with a
//   dependent load chain; rows of more runs than threads load the rest in
//   chunks;
// - a block scan takes one barrier: every warp scans the warp totals itself;
// - runs come either from the RLE bytes themselves, decoded in the kernel as
//   ((t & 15) << 4 * (t >> 4), v & 1) with t = v >> 1 (concatenated rows
//   with int64 offsets: one byte per run, no padding), or from the padded
//   int32 (rows, max_runs) lens/bits arrays of bgt_tpu's decode_block.
//
// S0 must hold a permutation of 0..m-1 per scan (the wrapper checks it);
// then every rank stays in [0, m) and every output byte and S_final entry is
// written once.
//
// Interface: plain C entry points bound with ctypes.  bgt_pbwt_decode
// launches on the caller's stream, does not synchronise, allocates nothing,
// and returns the first CUDA error it meets (0 on success).  The block size
// is BGT_PBWT_THREADS (default 1,024), fixed at compile time.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#ifndef BGT_PBWT_THREADS
#define BGT_PBWT_THREADS 1024
#endif

namespace {

constexpr int kThreads = BGT_PBWT_THREADS;
static_assert(kThreads % 32 == 0 && kThreads >= 64 && kThreads <= 1024,
              "BGT_PBWT_THREADS: a multiple of 32 in [64, 1024]");
constexpr int kWarps = kThreads / 32;
constexpr int kSliceUnit = 16;  // a slice's length is a multiple of this
constexpr unsigned kFull = 0xffffffffu;

// Inclusive prefix sum across a warp.
template <typename T>
__device__ __forceinline__ T warp_inclusive_sum(T x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T up = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += up;
  }
  return x;
}

// Block-wide exclusive prefix sum of one value per thread; the block total
// goes to *total.  Every thread of the block must call it.  One barrier:
// every warp scans the kWarps warp totals in `scratch` itself.  So a call
// may reuse a `scratch` buffer only if a barrier lies between it and the
// buffer's previous call (another call on another buffer is one).
template <typename T>
__device__ __forceinline__ T block_exclusive_sum(T v, T* scratch, T* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T x = warp_inclusive_sum(v);
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  const T s = warp_inclusive_sum(lane < kWarps ? scratch[lane] : T(0));
  *total = __shfl_sync(kFull, s, kWarps - 1);
  const T warps_before = __shfl_sync(kFull, s, warp ? warp - 1 : 0);
  return (warp ? warps_before : T(0)) + x - v;
}

// Run j and the bit of run j - 1 of a row, as loaded: decoded only where
// used, so that a load made ahead of need does not wait for its data.
template <bool kBytes>
struct Run;

template <>
struct Run<true> {  // RLE bytes
  unsigned v = 0, pv = 0;
  __device__ void load(const uint8_t* rle, const int32_t*, const int32_t*, long long j,
                       bool has, bool has_prev) {
    if (has) v = rle[j];
    if (has_prev) pv = rle[j - 1];
  }
  __device__ long long len() const {
    const unsigned t = v >> 1;
    return (long long)(t & 15u) << (4 * (t >> 4));
  }
  __device__ int bit() const { return (int)(v & 1u); }
  __device__ int prev_bit() const { return (int)(pv & 1u); }
};

template <>
struct Run<false> {  // padded int32 lens/bits
  int l = 0, b = 0, pb = 0;
  __device__ void load(const uint8_t*, const int32_t* lens, const int32_t* bits, long long j,
                       bool has, bool has_prev) {
    if (has) {
      l = lens[j];
      b = bits[j];
    }
    if (has_prev) pb = bits[j - 1];
  }
  __device__ long long len() const { return l; }
  __device__ int bit() const { return b; }
  __device__ int prev_bit() const { return pb; }
};

// Run j (an index into the source) of the row whose runs are [lo, hi);
// past the row it reads nothing and is an empty run of bit 0.
template <bool kBytes>
__device__ __forceinline__ Run<kBytes> fetch(const uint8_t* rle, const int32_t* lens,
                                             const int32_t* bits, long long j, long long lo,
                                             long long hi) {
  Run<kBytes> run;
  const bool has = j < hi;
  run.load(rle, lens, bits, j, has, has && j > lo);
  return run;
}

// One row's step on the haplotype of rank p: its output bit, and its rank
// in the next row in *next.
__device__ __forceinline__ unsigned step(unsigned p, const uint2* Y, unsigned n0,
                                         unsigned* next) {
  const uint2 e = Y[p >> 5];  // (y word, ones before the word)
  const unsigned b = p & 31u;
  const unsigned y = (e.x >> b) & 1u;
  const unsigned o = e.y + __popc(e.x & ((1u << b) - 1u));
  *next = y ? n0 + o : p - o;
  return y;
}

// Scan k = blockIdx.x / C decodes rows [scan_row0[k], scan_row0[k+1]) of
// the output from S0[k]; row r's runs are [run_off[r], run_off[r+1]) of the
// run source.  The block owns haplotypes [lo, lo + L) of the scan, lo =
// (blockIdx.x % C) L.  Dynamic shared memory: L ranks, then W = ceil(m / 32)
// (y word, ones before it) pairs, then W transition words.
template <bool kBytes, typename Rank>
__global__ void __launch_bounds__(kThreads)
pbwt_decode_kernel(const int32_t* __restrict__ S0, const uint8_t* __restrict__ rle,
                   const int32_t* __restrict__ lens, const int32_t* __restrict__ bits,
                   const long long* __restrict__ run_off,
                   const long long* __restrict__ scan_row0, uint8_t* __restrict__ out,
                   int32_t* __restrict__ S_final, int m, int C, int L) {
  constexpr int Q = 16 / (int)sizeof(Rank);  // haplotypes a thread takes at once
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long run_scratch[2][kWarps];  // alternating chunk by chunk
  __shared__ int word_scratch[2][kWarps];       // parities, popcounts
  const int W = (m + 31) >> 5;
  Rank* const P = reinterpret_cast<Rank*>(smem);
  uint2* const Y = reinterpret_cast<uint2*>(smem + (size_t)L * sizeof(Rank));
  uint32_t* const T = reinterpret_cast<uint32_t*>(Y + W);
  const int tid = threadIdx.x;
  const size_t ms = (size_t)m;
  const int k = blockIdx.x / C;
  const int lo = (blockIdx.x % C) * L;
  const int len = min(L, m - lo);  // > 0: C = ceil(m / L)
  const long long r0 = scan_row0[k];
  const long long r1 = scan_row0[k + 1];
  // each thread's contiguous segment of bitmap words for the two scans
  const int per = (W + kThreads - 1) / kThreads;
  const int w0 = min(tid * per, W);
  const int w1 = min(w0 + per, W);
  const uint32_t tail = (m & 31) ? (1u << (m & 31)) - 1u : kFull;

  const int32_t* const s0 = S0 + (size_t)k * ms;
  for (int i = tid; i < m; i += kThreads) {
    const unsigned h = (unsigned)(s0[i] - lo);
    if (h < (unsigned)len) P[h] = (Rank)i;
  }
  for (int w = w0; w < w1; ++w) T[w] = 0u;
  // row r's runs are [a, e); e1 ends row r + 1's; nxt is row r's first chunk
  long long a = 0, e = 0, e1 = 0;
  Run<kBytes> nxt;
  if (r0 < r1) {
    a = run_off[r0];
    e = run_off[r0 + 1];
    e1 = r0 + 1 < r1 ? run_off[r0 + 2] : e;
    nxt = fetch<kBytes>(rle, lens, bits, a + tid, a, e);
  }
  __syncthreads();  // P set, transitions zero

  for (long long r = r0; r < r1; ++r) {
    const Run<kBytes> first = nxt;
    if (r + 1 < r1) nxt = fetch<kBytes>(rle, lens, bits, e + tid, e, e1);
    const long long e2 = r + 2 < r1 ? run_off[r + 3] : e1;

    // 1. transition bits at the run starts (a chunk's barrier orders the
    //    previous row's zeroing of the words before them)
    const long long n_runs = e - a;
    long long carry = 0, runs_total;
    for (long long base = 0; base < n_runs; base += kThreads) {
      const Run<kBytes> run =
          base == 0 ? first : fetch<kBytes>(rle, lens, bits, a + base + tid, a, e);
      const long long ln = run.len();
      const long long start =
          carry + block_exclusive_sum(ln, run_scratch[(base / kThreads) & 1], &runs_total);
      if (ln > 0 && run.bit() != run.prev_bit() && start >= 0 && start < m)
        atomicXor(&T[start >> 5], 1u << (start & 31));
      carry += runs_total;
    }
    __syncthreads();  // transitions complete; the previous row's slice pass done

    // 2. y = prefix XOR of the transitions; ones before each word
    int par = 0, total;
    for (int w = w0; w < w1; ++w) par ^= __popc(T[w]) & 1;
    uint32_t flip = block_exclusive_sum(par, word_scratch[0], &total) & 1 ? kFull : 0u;
    int ones = 0;
    for (int w = w0; w < w1; ++w) {
      const uint32_t t = T[w];
      T[w] = 0u;
      uint32_t x = t;
      x ^= x << 1;
      x ^= x << 2;
      x ^= x << 4;
      x ^= x << 8;
      x ^= x << 16;
      x ^= flip;
      if (__popc(t) & 1) flip = ~flip;
      if (w == W - 1) x &= tail;
      Y[w].x = x;
      ones += __popc(x);
    }
    int before = block_exclusive_sum(ones, word_scratch[1], &total);
    const unsigned n0 = (unsigned)(m - total);
    for (int w = w0; w < w1; ++w) {
      Y[w].y = (unsigned)before;
      before += __popc(Y[w].x);
    }
    __syncthreads();

    // 3. the slice pass: the row in original order, the ranks in place
    uint8_t* const row = out + (size_t)r * ms + lo;
    const bool aligned = (reinterpret_cast<uintptr_t>(row) % Q) == 0;
    for (int g = tid * Q; g < len; g += kThreads * Q) {
      if (g + Q <= len) {
        union {
          uint4 v;
          Rank p[Q];
        } ranks;
        ranks.v = *reinterpret_cast<const uint4*>(P + g);
        uint32_t word[Q / 4] = {};
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          unsigned nx;
          word[i >> 2] |= step(ranks.p[i], Y, n0, &nx) << (8 * (i & 3));
          ranks.p[i] = (Rank)nx;
        }
        *reinterpret_cast<uint4*>(P + g) = ranks.v;
        if (aligned) {
          if constexpr (Q == 8)
            *reinterpret_cast<uint2*>(row + g) = make_uint2(word[0], word[1]);
          else
            *reinterpret_cast<uint32_t*>(row + g) = word[0];
        } else {
#pragma unroll
          for (int i = 0; i < Q; ++i) row[g + i] = (uint8_t)(word[i >> 2] >> (8 * (i & 3)));
        }
      } else {
        for (int h = g; h < len; ++h) {
          unsigned nx;
          row[h] = (uint8_t)step(P[h], Y, n0, &nx);
          P[h] = (Rank)nx;
        }
      }
    }
    a = e;
    e = e1;
    e1 = e2;
  }
  __syncthreads();  // every rank written

  // the final S from the slice's ranks
  int32_t* const fin = S_final + (size_t)k * ms;
  for (int h = tid; h < len; h += kThreads) fin[P[h]] = lo + h;
}

// The launch of scans x C blocks: plan[0] C, [1] L, [2] threads, [3] dynamic
// shared bytes, [4] the least C whose slice fits, [5] the most C (slices of
// 16), [6] blocks per SM at that shared memory.
constexpr int kPlanLen = 7;

template <bool kBytes, typename Rank>
int plan_for(int scans, int m, int blocks_per_scan, int* plan) {
  auto kernel = pbwt_decode_kernel<kBytes, Rank>;
  int dev, sms, optin, threads_per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&threads_per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  const long long y_bytes = 12LL * ((m + 31) / 32);  // y, ones before, transitions
  const long long room = (long long)optin - (long long)fa.sharedSizeBytes;
  const long long lmax = (room - y_bytes) / (long long)sizeof(Rank) / kSliceUnit * kSliceUnit;
  const int cmax = (m + kSliceUnit - 1) / kSliceUnit;
  const int cmin = lmax >= kSliceUnit ? (int)((m + lmax - 1) / lmax) : cmax + 1;
  plan[4] = cmin;
  plan[5] = cmax;
  if (cmin > cmax) return (int)cudaErrorInvalidValue;  // y alone fills shared memory
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)room);
  if (err != cudaSuccess) return (int)err;
  auto slice = [m](int c) {
    const int l = (m + c - 1) / c;
    return (l + kSliceUnit - 1) / kSliceUnit * kSliceUnit;
  };
  auto smem = [&](int l) { return (int)(l * sizeof(Rank) + y_bytes); };
  int C = blocks_per_scan, occ = 0;
  if (C > 0) {
    if (C < cmin || C > cmax) return (int)cudaErrorInvalidValue;
  } else {
    // the most blocks the SMs hold at once, at the occupancy the slice gets
    int want = threads_per_sm / kThreads;
    for (;;) {
      C = (int)std::min(std::max((long long)sms * want / scans, (long long)cmin),
                        (long long)cmax);
      C = (m + slice(C) - 1) / slice(C);
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads,
                                                          smem(slice(C)));
      if (err != cudaSuccess) return (int)err;
      if (occ >= want || occ < 1) break;
      want = occ;
    }
  }
  const int L = slice(C);
  C = (m + L - 1) / L;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, smem(L));
  if (err != cudaSuccess) return (int)err;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  plan[0] = C;
  plan[1] = L;
  plan[2] = kThreads;
  plan[3] = smem(L);
  plan[6] = occ;
  return 0;
}

template <bool kBytes, typename Rank>
int launch(const void* S0, const void* rle, const void* lens, const void* bits,
           const void* run_off, const void* scan_row0, void* out, void* S_final, int scans,
           int m, int blocks_per_scan, void* stream) {
  int plan[kPlanLen];
  const int err = plan_for<kBytes, Rank>(scans, m, blocks_per_scan, plan);
  if (err != 0) return err;
  pbwt_decode_kernel<kBytes, Rank>
      <<<scans * plan[0], kThreads, plan[3], static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int32_t*>(S0), static_cast<const uint8_t*>(rle),
          static_cast<const int32_t*>(lens), static_cast<const int32_t*>(bits),
          static_cast<const long long*>(run_off), static_cast<const long long*>(scan_row0),
          static_cast<uint8_t*>(out), static_cast<int32_t*>(S_final), m, plan[0], plan[1]);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch bgt_pbwt_decode makes for `scans` scans at m haplotypes, from
// RLE bytes when `rle` is nonzero, else from padded runs, on the current
// device: kPlanLen ints into `plan` (see plan_for).  blocks_per_scan 0 picks
// C; a C outside [plan[4], plan[5]] is refused with cudaErrorInvalidValue
// (plan[4] and plan[5] are still set).  Returns the first CUDA error.
extern "C" int bgt_pbwt_decode_plan(int scans, int m, int blocks_per_scan, int rle, int* plan) {
  if (scans <= 0 || m <= 0 || blocks_per_scan < 0) return (int)cudaErrorInvalidValue;
  if (m <= 65536)
    return rle ? plan_for<true, uint16_t>(scans, m, blocks_per_scan, plan)
               : plan_for<false, uint16_t>(scans, m, blocks_per_scan, plan);
  return rle ? plan_for<true, uint32_t>(scans, m, blocks_per_scan, plan)
             : plan_for<false, uint32_t>(scans, m, blocks_per_scan, plan);
}

// S0: (scans, m) int32, each a permutation of 0..m-1.  Runs: rle (uint8 RLE
// bytes) when it is not null, else lens/bits (int32); row r's runs are
// entries [run_off[r], run_off[r+1]) of that source.  scan_row0: (scans + 1)
// int64, scan k owns output rows [scan_row0[k], scan_row0[k+1]).  out:
// (scan_row0[scans], m) uint8.  S_final: (scans, m) int32, the S after each
// scan's last row (S0 for a scan of no rows).  blocks_per_scan: C, or 0 for
// the plan's own.  stream: a cudaStream_t.  Launches nothing when scans or m
// is 0.
extern "C" int bgt_pbwt_decode(const void* S0, const void* rle, const void* lens,
                               const void* bits, const void* run_off, const void* scan_row0,
                               void* out, void* S_final, int scans, int m,
                               int blocks_per_scan, void* stream) {
  if (scans <= 0 || m <= 0) return 0;
  if (blocks_per_scan < 0) return (int)cudaErrorInvalidValue;
  if (m <= 65536)
    return rle ? launch<true, uint16_t>(S0, rle, lens, bits, run_off, scan_row0, out, S_final,
                                        scans, m, blocks_per_scan, stream)
               : launch<false, uint16_t>(S0, rle, lens, bits, run_off, scan_row0, out,
                                         S_final, scans, m, blocks_per_scan, stream);
  return rle ? launch<true, uint32_t>(S0, rle, lens, bits, run_off, scan_row0, out, S_final,
                                      scans, m, blocks_per_scan, stream)
             : launch<false, uint32_t>(S0, rle, lens, bits, run_off, scan_row0, out, S_final,
                                       scans, m, blocks_per_scan, stream);
}
